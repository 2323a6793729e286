"""PyTorch port: the 9-output route and its epilogue == the JAX package's.

Textured pools past the in-kernel texture route (16,384 texels or 128
materials) baked without mip chains take the JAX ``render_core``'s
9-output mode (``tex_inkernel`` False, :4065-4073): the kernel writes t, z,
idx, the material, uv and the normal, and ``_frames_from_core``
(:4962-5018) shades them with ``shade_lambert_planar`` and, with shadows,
``compute_lit``. The port's twins on the same inputs, bitwise:
``build_world_soup``, ``camera_ray_dirs``, ``shade_lambert_planar`` (with
XLA:CPU's approximate ``rsqrt`` swapped for a correctly rounded one: it
differs from 1/sqrt by up to 2 ulp in about a third of the values, and the
port's is correctly rounded), ``compute_lit`` / ``shadow_occlusion``; the
route's frames against the JAX Pallas kernel in interpret mode and the jnp
reference at tests/test_pallas_parity.py's bar (rgb within ±1 LSB, depth
rtol = atol = 1e-5, segmask exact), nearest and bilinear, with shadows and
rasterized; the resident binned visit (K4 on resident rows), which raised
until the culled visits' 9-output mode was ported; the warm start on the
route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_renderer_tpu.config as jcfg
from madrona_renderer_tpu.assets.importer import load_render_assets as j_load
from madrona_renderer_tpu.assets.png import write_png
from madrona_renderer_tpu.core.scene import bake_scene as j_bake
from madrona_renderer_tpu.core.scene import configure_lighting as j_light
from madrona_renderer_tpu.core.state import init_state as j_init
from madrona_renderer_tpu.ops import raytrace_ref as jref
from madrona_renderer_tpu.ops import shade as jshade
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu_torch.ops import raster_cuda, raytrace_ref, shade, warmstart
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc

from tests.fixtures import make_checker_png
from tests.torch_helpers import (
    IDENTITY, SceneSpec, assert_frames_close, carry_over, quad_uvs, quad_xz,
)

LIGHTS = [((1.0, 1.0, 0.0), (1.0, 1.0, 1.0)), ((-0.3, 1.0, 0.4), (0.4, 0.4, 0.6))]


def _big_pool_spec(path, n_worlds=2):
    """tests/test_shadows.py's occluder scene with both quads textured by a
    144x144 checker (20,736 texels: past the in-kernel route's 16,384),
    beside an untextured material; world w's occluder moved by w/4."""
    write_png(path, make_checker_png(144, 16))
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        insts += [dict(position=[0, 10, 0], rotation=IDENTITY, object_id=0),
                  dict(position=[0.25 * w, 5, 0], rotation=IDENTITY, object_id=1)]
        cams.append(dict(position=[0, 0, 0], rotation=IDENTITY))
        worlds.append(dict(num_instances=2, instance_offset=2 * w, num_cameras=1,
                           camera_offset=w))
    return SceneSpec(meshes=[quad_xz(50.0), quad_xz(2.0)],
                     uvs=[quad_uvs(3.7), quad_uvs()], mesh_materials=[0, 1],
                     materials=[(1, 1, 1, 1), (0.9, 0.4, 0.3, 1)],
                     material_textures=[0, -1], textures=[path],
                     instances=insts, cameras=cams, worlds=worlds)


def _built(tmp_path, lights=LIGHTS):
    """The JAX state and scene (baked with mipmaps=False) and the port's."""
    spec = _big_pool_spec(str(tmp_path / "big.png"))
    geo, mats, insts, cams, worlds = spec._parts(jcfg)
    j_scene = j_bake(j_load(geo, [], mats, list(spec.textures)), mipmaps=False)
    j_scene = j_light(j_scene, lights=lights)
    j_state = j_init(insts, cams, worlds)
    t_state, t_scene = carry_over(j_state, j_scene)
    assert int(t_scene.tex_data.shape[0]) > 128 * 128 and not trc.has_mips(t_scene)
    return (j_state, j_scene), (t_state, t_scene)


@pytest.mark.parametrize("texture_filter", ["nearest", "bilinear"])
def test_nine_output_route_matches_jax(texture_filter, tmp_path):
    """The route's frames, raytraced and with shadows (the epilogue's
    compute_lit), against the JAX Pallas kernel and the jnp reference; the
    prologue takes the 9-output mode on the index sweep (raw rows without
    the in-kernel shadow rays under shadows), and K1-none's outputs are
    K1's."""
    (j_state, j_scene), (t_state, t_scene) = _built(tmp_path)
    kw = dict(height=32, width=32, texture_filter=texture_filter)
    for shadows in (False, True):
        inputs = trc.pack_inputs(t_state, t_scene, shadows=shadows, **kw)
        assert inputs["texture"] == "nine" and inputs["mats"] is None
        assert inputs["geo"] == ("raw" if shadows else "prep")
        port = trc.raytrace(t_state, t_scene, shadows=shadows, **kw)
        assert_frames_close(j_ref_frames(j_state, j_scene, shadows, kw), port)
        assert_frames_close(j_pallas(j_state, j_scene, interpret=True, shadows=shadows, **kw),
                            port)
        assert set(np.unique(port.segmask.numpy())) >= {0, 1}
        none = trc.render_core(t_state, t_scene, shadows=shadows, accel="none", **kw)
        for a, b in zip(none, trc.render_core(t_state, t_scene, shadows=shadows, **kw)):
            assert torch.equal(a, b)
    # The shadows darken the ground; the checker shows (its two texel
    # colours on the lit ground beside the occluder's material colour).
    lit = trc.raytrace(t_state, t_scene, **kw)
    darker = lit.rgb.numpy()[..., :3].astype(int) - port.rgb.numpy()[..., :3]
    assert (darker >= 0).all() and (darker > 10).any()
    assert len(np.unique(lit.rgb.numpy().reshape(-1, 4), axis=0)) >= 3


def j_ref_frames(j_state, j_scene, shadows, kw):
    return jref.raytrace(j_state, j_scene, shadows=shadows, **kw)


def test_nine_output_route_rasterized(tmp_path):
    """The raster conventions on the route: depth z, no segmask."""
    (j_state, j_scene), (t_state, t_scene) = _built(tmp_path)
    kw = dict(height=32, width=32)
    port = raster_cuda.rasterize(t_state, t_scene, **kw)
    assert_frames_close(j_raster_ref(j_state, j_scene, **kw), port)
    assert (port.segmask.numpy() == -1).all() and (port.depth.numpy() > 0).any()


def test_nine_output_route_refusals_and_warm_start(tmp_path):
    """Off the index sweep (the scene's 2 clusters a world bin under
    accel="binned": K4 on resident rows) the 9-output mode, which raised
    until that visit's entries were ported, renders the JAX package's
    frames (the jnp reference and the Pallas kernel's binned visit in
    interpret mode); the warm start on the route is bitwise a cold
    render."""
    (j_state, j_scene), (t_state, t_scene) = _built(tmp_path)
    kw = dict(height=32, width=32)
    for accel in ("clusters", "binned"):  # a resident world of 2 clusters
        route = trc.visit_route(t_state, t_scene, 32, 32, accel)
        if route.visit != "index":
            assert route == trc.Route(False, "binned")
            inputs = trc.pack_inputs(t_state, t_scene, accel=accel, **kw)
            assert inputs["texture"] == "nine" and inputs["bins"] is not None
            port = trc.raytrace(t_state, t_scene, accel=accel, **kw)
            assert_frames_close(j_ref_frames(j_state, j_scene, False, kw), port)
            assert_frames_close(j_pallas(j_state, j_scene, interpret=True, accel=accel, **kw),
                                port)
    cold = trc.raytrace(t_state, t_scene, shadows=True, **kw)
    prev = torch.where(cold.depth > 0, cold.depth * 0.8, 1000.0)
    warm = warmstart.raytrace_warmstart(t_state, t_scene, prev_depth=prev, shadows=True, **kw)
    for a, b in zip((warm.rgb, warm.depth, warm.segmask), (cold.rgb, cold.depth, cold.segmask)):
        assert torch.equal(a, b)


def test_soup_and_rays_are_bitwise_jax(tmp_path):
    """build_world_soup and camera_ray_dirs (one fov, and per-camera fovs)
    against the JAX functions on the same inputs, bitwise."""
    (j_state, j_scene), (t_state, t_scene) = _built(tmp_path)
    j_soup, t_soup = jref.build_world_soup(j_state, j_scene), raytrace_ref.build_world_soup(
        t_state, t_scene)
    for f in ("v0", "e1", "e2", "uv0", "duv1", "duv2", "n0", "dn1", "dn2", "mat", "seg",
              "valid", "density"):
        np.testing.assert_array_equal(np.asarray(getattr(j_soup, f)),
                                      getattr(t_soup, f).numpy(), err_msg=f)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 2, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    ref = np.asarray(jref.camera_ray_dirs(jnp.asarray(q), 24, 40, 90.0))
    port = raytrace_ref.camera_ray_dirs(torch.from_numpy(q), 24, 40, 90.0).numpy()
    np.testing.assert_array_equal(ref, port)
    # Per-camera fovs: bitwise wherever the two libraries' f32 tan agree on
    # the half angle (XLA:CPU's tan is not correctly rounded: it differs
    # from torch's in some 5% of arguments), within 1e-6 elsewhere.
    fovs = np.asarray([[60.0, 90.0], [45.0, 120.0], [90.0, 75.5]], np.float32)
    ref = np.asarray(jref.camera_ray_dirs(jnp.asarray(q), 24, 40, jnp.asarray(fovs)))
    port = raytrace_ref.camera_ray_dirs(torch.from_numpy(q), 24, 40,
                                        torch.from_numpy(fovs)).numpy()
    half = fovs * np.float32(np.pi / 180) * np.float32(0.5)
    same_tan = np.asarray(jnp.tan(jnp.asarray(half))) == torch.tan(torch.from_numpy(half)).numpy()
    assert same_tan.sum() >= 3
    np.testing.assert_array_equal(ref[same_tan], port[same_tan])
    np.testing.assert_allclose(ref, port, rtol=0, atol=1e-6)


def _exact_rsqrt(x):
    return jnp.asarray((1.0 / np.sqrt(np.asarray(x, np.float64))).astype(np.float32))


@pytest.mark.parametrize("texture_filter", ["nearest", "bilinear"])
def test_shade_lambert_planar_is_bitwise_jax(texture_filter, tmp_path, monkeypatch):
    """shade_lambert_planar on random materials, uv (beyond [0, 1]: the
    repeat wrap), normals, hits and per-light visibility: bitwise the JAX
    function's with a correctly rounded reciprocal square root, and within
    1 LSB of it with XLA:CPU's own."""
    (_, j_scene), (_, t_scene) = _built(tmp_path)
    rng = np.random.default_rng(11)
    shape = (2, 1, 600)
    mat = rng.integers(0, 2, size=shape).astype(np.int32)
    u, v = (rng.uniform(-3, 3, size=shape).astype(np.float32) for _ in range(2))
    n = rng.normal(size=(3,) + shape).astype(np.float32)
    hit = rng.uniform(size=shape) > 0.2
    lit = (rng.uniform(size=shape + (2,)) > 0.4).astype(np.float32)
    args = [mat, u, v, n[0], n[1], n[2], hit]
    port = shade.shade_lambert_planar(t_scene, *[torch.from_numpy(a) for a in args],
                                      texture_filter, lit=torch.from_numpy(lit)).numpy()
    approx = np.asarray(jshade.shade_lambert_planar(
        j_scene, *[jnp.asarray(a) for a in args], texture_filter, lit=jnp.asarray(lit)))
    diff = np.abs(approx.view(np.uint8).astype(int) - port.view(np.uint8).astype(int))
    assert diff.max() <= 1
    monkeypatch.setattr(jax.lax, "rsqrt", _exact_rsqrt)
    exact = np.asarray(jshade.shade_lambert_planar(
        j_scene, *[jnp.asarray(a) for a in args], texture_filter, lit=jnp.asarray(lit)))
    np.testing.assert_array_equal(exact.view(np.int32), port)


def test_compute_lit_is_bitwise_jax(tmp_path):
    """compute_lit (shadow_occlusion per light) from the route's own hit
    points, bitwise the JAX function's; the occluder shadows some of the
    ground. A small world and pixel chunk on the port side changes only the
    memory."""
    (j_state, j_scene), (t_state, t_scene) = _built(tmp_path)
    t, *_ = trc.render_core(t_state, t_scene, height=32, width=32, shadows=True)
    t = t.reshape(2, 1, -1)
    dirs = raytrace_ref.camera_ray_dirs(t_state.camera_rot, 32, 32, 90.0)
    points = t_state.camera_pos[:, :, None, :] + t[..., None] * dirs
    j_soup = jref.build_world_soup(j_state, j_scene)
    ref = np.asarray(jref.compute_lit(j_soup, j_scene, jnp.asarray(points.numpy()),
                                      jnp.asarray(t.numpy())))
    t_soup = raytrace_ref.build_world_soup(t_state, t_scene)
    port = raytrace_ref.compute_lit(t_soup, t_scene, points, t)
    np.testing.assert_array_equal(ref, port.numpy())
    assert 0 < (port[..., 0] == 0).sum() < port[..., 0].numel()
    sdir = -raytrace_ref.light_directions(t_scene)[0]
    chunked = raytrace_ref.shadow_occlusion(t_soup, points, sdir, t, chunk=100,
                                            max_elements=1)
    assert torch.equal(chunked, port[..., 0] == 0)
