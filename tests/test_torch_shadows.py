"""PyTorch port: shadow rays (kernel K8) == the JAX package's.

``shadows=True`` takes the raw-row sweep (K1-raw) and adds one any-hit ray
per (pixel, light) from the primary hit point toward each directional
light; an occluded light adds only ambient. The port's ``raytrace`` /
``rasterize`` (the kernel's plain PyTorch version on the CPU) against the
JAX Pallas kernel in interpret mode and the jnp reference on
tests/test_shadows.py's analytic scene (one and two lights, raytraced and
rasterized), a textured scene and two-camera worlds; then the Manager
option. The bar is tests/test_pallas_parity.py's: rgb within ±1 LSB, depth
rtol = atol = 1e-5, segmask exact.
"""

import dataclasses

import numpy as np
import pytest

import madrona_renderer_tpu as jm
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.assets.png import write_png
from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.core.scene import configure_lighting as j_light
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_raster_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu.ops.shade import AMBIENT
from madrona_renderer_tpu.runners.scenes import demo_config as j_demo
from madrona_renderer_tpu_torch.ops import raster_cuda
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo
from madrona_renderer_tpu_torch.runners.scenes import renderer_kwargs

from tests.fixtures import make_checker_png
from tests.torch_helpers import (
    IDENTITY, SceneSpec, assert_frames_close, carry_over, quad_uvs, quad_xz,
    spec_from_config,
)

ONE_LIGHT = [((1.0, 1.0, 0.0), (1.0, 1.0, 1.0))]
TWO_LIGHTS = ONE_LIGHT + [((-0.3, 1.0, 0.4), (0.4, 0.4, 0.6))]


def _occluder_spec(**kw):
    """tests/test_shadows.py::_scene: a ground quad at y=10 and a small
    occluder quad at y=5 on the view axis of a camera at the origin."""
    return SceneSpec(
        meshes=[quad_xz(50.0), quad_xz(2.0)],
        instances=[dict(position=[0, 10, 0], rotation=IDENTITY, object_id=0),
                   dict(position=[0, 5, 0], rotation=IDENTITY, object_id=1)],
        cameras=[dict(position=[0, 0, 0], rotation=IDENTITY)],
        worlds=[dict(num_instances=2, instance_offset=0, num_cameras=1, camera_offset=0)],
        **kw,
    )


def _textured_spec(tmp_dir):
    """tests/test_shadows.py::test_shadows_textured_inkernel's scene."""
    path = str(tmp_dir / "checker.png")
    write_png(path, make_checker_png(16, 4))
    return _occluder_spec(uvs=[quad_uvs(), quad_uvs()], mesh_materials=[0, 0],
                          materials=[(1, 1, 1, 1)], material_textures=[0],
                          textures=[path])


# name → (spec factory, lights, render mode, texture filter)
CASES = {
    "occluder_one_light": (lambda d: _occluder_spec(), ONE_LIGHT, "rt", "nearest"),
    "occluder_two_lights": (lambda d: _occluder_spec(), TWO_LIGHTS, "rt", "nearest"),
    "occluder_textured": (_textured_spec, [((0.5, 1, 0), (1, 1, 1))], "rt", "nearest"),
    "occluder_raster": (lambda d: _occluder_spec(), ONE_LIGHT, "raster", "nearest"),
    "demo2_2cams": (lambda d: spec_from_config(j_demo(
        2, RenderMode.Raytracer, 32, 32, dynamic=True, num_cams=2)), None, "rt", "nearest"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shadow_frames_match_jax(case, tmp_path):
    make, lights, mode, texture_filter = CASES[case]
    j_state, j_scene = make(tmp_path).build_jax()
    if lights is not None:
        j_scene = j_light(j_scene, lights=lights)
    t_state, t_scene = carry_over(j_state, j_scene)
    kw = dict(height=32, width=32, texture_filter=texture_filter)
    if mode == "raster":
        render, ref, pal = raster_cuda.rasterize, j_raster_ref, j_raster_pallas
    else:
        render, ref, pal = trc.raytrace, j_ref, j_pallas
    port = render(t_state, t_scene, shadows=True, **kw)
    assert_frames_close(ref(j_state, j_scene, shadows=True, **kw), port)
    assert_frames_close(pal(j_state, j_scene, shadows=True, interpret=True, **kw), port)
    # Shadows darken some lit pixels and change nothing but rgb.
    off = render(t_state, t_scene, **kw)
    darker = off.rgb.numpy()[..., :3].astype(int) - port.rgb.numpy()[..., :3]
    assert (darker >= 0).all() and (darker > 0).any()
    np.testing.assert_array_equal(off.segmask.numpy(), port.segmask.numpy())
    np.testing.assert_allclose(off.depth.numpy(), port.depth.numpy(), rtol=1e-5, atol=1e-5)


def test_shadow_analytic_extent():
    """tests/test_shadows.py::test_shadow_analytic_extent on the port: the
    occluder's shadow on the ground reads exactly the ambient level, lit
    ground and the occluder's own lit face read ambient + diffuse."""
    j_state, j_scene = _occluder_spec().build_jax()
    t_state, t_scene = carry_over(j_state, j_light(j_scene, lights=ONE_LIGHT))
    f = trc.raytrace(t_state, t_scene, height=64, width=64, shadows=True)
    rgb, seg = f.rgb.numpy()[0, 0], f.segmask.numpy()[0, 0]

    def pix(wx, wz):
        return int((1.0 - wz / 10.0) * 32 - 0.5), int((wx / 10.0 + 1.0) * 32 - 0.5)

    ambient_only = int(AMBIENT * 255 + 0.5)
    in_shadow, lit, occ_face = pix(5.5, 0.0), pix(-6.0, 0.0), pix(0.0, 0.0)
    assert seg[in_shadow] == 0 and seg[lit] == 0 and seg[occ_face] == 1
    assert abs(int(rgb[in_shadow][0]) - ambient_only) <= 1, rgb[in_shadow]
    assert int(rgb[lit][0]) > ambient_only + 40
    assert int(rgb[occ_face][0]) > ambient_only + 40


def test_shadow_prologue_takes_the_raw_rows():
    """shadows on a one-camera scene: the rows are K13's raw layout and the
    kernel's raw_shadows variant runs; a sweep the kernel lacks raises."""
    t_state, t_scene = spec_from_config(t_demo(2, tm.RenderMode.Raytracer, 16, 16)).build_torch()
    assert trc.pack_inputs(t_state, t_scene, height=16, width=16)["geo"] == "prep"
    kw = trc.pack_inputs(t_state, t_scene, height=16, width=16, shadows=True)
    assert kw["geo"] == "raw_shadows"
    assert kw["rows"].equal(trc._pack_rows_planar(t_state, t_scene))
    assert (trc.variant_name(True, "bilinear", "raw_shadows")
            == "render_resident_raw_shadows_raster_tex_bilinear")
    # 2 routes (resident, streamed) x 5 sweeps (prep, raw, raw with shadows
    # and the two watertight ones) x 2 conventions x 4 texture modes (K7's
    # mip hand-off the fourth).
    assert len(trc.VARIANTS) == len(set(trc.VARIANTS)) == 80
    with pytest.raises(ValueError, match="geo must be one of"):
        trc.render_resident(**dict(kw, geo="prep_shadows"))


@pytest.mark.parametrize("num_cams", [1, 2])
def test_manager_shadows_option(num_cams):
    """``shadows=True`` through MadronaRenderer matches the JAX Manager and,
    against the same renderer without shadows, changes rgb only: with two
    cameras both run the raw sweep, so depth and segmask are bitwise; with
    one the unshadowed renderer runs the prep rows, whose determinant
    rounds otherwise (depth within the bar, segmask equal on this scene)."""
    cfg = t_demo(2, tm.RenderMode.Raytracer, 32, 32, dynamic=True, num_cams=num_cams)
    on = tm.MadronaRenderer(0, 2, tm.RenderMode.Raytracer, 32, 32, device="cpu",
                            shadows=True, **renderer_kwargs(cfg))
    off = tm.MadronaRenderer(0, 2, tm.RenderMode.Raytracer, 32, 32, device="cpu",
                             **renderer_kwargs(cfg))
    j = jm.Manager(dataclasses.replace(
        j_demo(2, jm.RenderMode.Raytracer, 32, 32, dynamic=True, num_cams=num_cams,
               impl="jnp"), shadows=True))
    assert_frames_close(j.frames, on.frames)
    assert (on.rgb_tensor().numpy() != off.rgb_tensor().numpy()).any()
    np.testing.assert_array_equal(on.segmask_tensor().numpy(), off.segmask_tensor().numpy())
    if num_cams > 1:
        np.testing.assert_array_equal(on.depth_tensor().numpy(), off.depth_tensor().numpy())
    else:
        np.testing.assert_allclose(on.depth_tensor().numpy(), off.depth_tensor().numpy(),
                                   rtol=1e-5, atol=1e-5)
