"""PyTorch port: the batched kernel K12 (``accel="mxu"``) == the JAX package's.

The port's ``render_batched`` (on the CPU its plain PyTorch version,
``render_batched_plain``) against the JAX ``render_core(accel="mxu")`` with
the batched Pallas kernel in interpret mode, on the scenes of
tests/test_pallas_parity.py's mxu tests (:294-400): the core outputs (t and
z within 1e-5 relative, idx exact; in the 9-output mode the material exact,
uv and normals within 1e-5), and the frames at tests/test_pallas_parity.py's
bar (rgb within ±1 LSB, depth rtol = atol = 1e-5, segmask exact) against
the jnp reference, raytraced and rasterized; shadows through the epilogue
(tests/test_shadows.py:194); the row layout K12 reads; the JAX package's
refusals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_renderer_tpu.config import (
    AdditionalMaterial, ImportedCamera, ImportedInstance,
)
from madrona_renderer_tpu.core.scene import configure_lighting as j_light
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import _frames_from_core as j_frames
from madrona_renderer_tpu.ops.raytrace_pallas import _pack_rows_planar as j_pack_rows
from madrona_renderer_tpu.ops.raytrace_pallas import render_core as j_core
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu_torch.ops import pack_cuda, raster_cuda, warmstart
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo

from tests.fixtures import make_checker_png
from tests.helpers import build, cam_at_origin_looking_plus_y, quad_uvs, quad_xz
from tests.torch_helpers import assert_frames_close, carry_over


def _unit(q):
    return (q / np.linalg.norm(q)).tolist()


def _random(seed):
    """tests/test_pallas_parity.py::test_parity_mxu_random_scenes's scene."""
    rng = np.random.default_rng(1000 + seed)
    n_meshes = int(rng.integers(1, 4))
    meshes = [(rng.normal(size=(int(rng.integers(1, 7)) * 3, 3)) * 5).astype(np.float32)
              for _ in range(n_meshes)]
    instances = [ImportedInstance(position=rng.normal(size=3).tolist(),
                                  rotation=_unit(rng.normal(size=4)),
                                  scale=rng.uniform(0.5, 2.0, size=3).tolist(),
                                  object_id=int(rng.integers(0, n_meshes)))
                 for _ in range(int(rng.integers(1, 5)))]
    cameras = [ImportedCamera(position=(rng.normal(size=3) * 3 + [0, -12, 0]).tolist(),
                              rotation=_unit(rng.normal(size=4) * 0.2 + [1, 0, 0, 0]))
               for _ in range(int(rng.integers(1, 3)))]
    return build(meshes, instances, cameras), 32, 32


def _multichunk():
    """test_parity_mxu_multichunk_and_modes's scene: 300 triangles (more
    than one of the TPU kernel's chunks) behind a wall, two cameras with
    their own fov and znear, at 24x40."""
    rng = np.random.default_rng(42)
    centers = rng.uniform(-8, 8, size=(300, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(5, 30, size=300)
    tris = []
    for c in centers:
        tris += [c + rng.normal(size=3) * 0.5 for _ in range(3)]
    scene = build(
        [np.asarray(tris, np.float32), quad_xz(half=50.0, y=0.0)],
        [ImportedInstance(position=[0, 0, 0], rotation=[1, 0, 0, 0], object_id=0),
         ImportedInstance(position=[0, 35, 0], rotation=[1, 0, 0, 0], object_id=1)],
        [cam_at_origin_looking_plus_y(),
         ImportedCamera(position=[0, -5, 2], rotation=[1, 0, 0, 0], fov_y_degrees=60.0,
                        znear=2.0)],
    )
    return scene, 24, 40


def _textured(tmp_path):
    """test_parity_mxu_textured's scene: a textured quad (the 9-output mode)."""
    from madrona_renderer_tpu.assets.png import write_png

    tex = str(tmp_path / "checker.png")
    write_png(tex, make_checker_png())
    scene = build(
        [quad_xz(half=20.0, y=0.0)],
        [ImportedInstance(position=[0, 15, 0], rotation=[1, 0, 0, 0], object_id=0)],
        [cam_at_origin_looking_plus_y()],
        uvs=[quad_uvs()], mesh_materials=[0],
        additional_mats=[AdditionalMaterial(color=[1, 1, 1, 1], texture_id=0)],
        additional_textures=[tex],
    )
    return scene, 32, 32


CASES = {
    "random0": lambda tmp: _random(0),
    "random1": lambda tmp: _random(1),
    "multichunk_24x40": lambda tmp: _multichunk(),
    "textured": _textured,
}
NINE_KEYS = ("t", "z", "idx", "mat", "uvx", "uvy", "nx", "ny", "nz")


def _jax_mxu(state, scene, h, w, raster=False, shadows=False, texture_filter="nearest",
             near=0.1):
    """The JAX mxu route's core outputs (the Pallas kernel in interpret
    mode) and its frames (``_frames_from_core`` on them)."""
    core, T = j_core(state, scene, height=h, width=w, near=near, far=1000.0,
                     fov_y_degrees=90.0, interpret=True, accel="mxu", raster_clip=raster,
                     shadows=shadows, texture_filter=texture_filter)
    frames = j_frames(core, T, scene, state, h, w, texture_filter,
                      depth_key="z" if raster else "t", far_clip=1000.0 if raster else None,
                      with_segmask=not raster, shadows=shadows)
    return core, frames


def _assert_core_close(core, outs):
    """K12's core outputs against the JAX kernel's: t, z, uv and normals
    within 1e-5 relative, idx and mat exact."""
    keys = NINE_KEYS if len(outs) == 9 else NINE_KEYS[:3]
    for key, out in zip(keys, outs):
        ref = np.asarray(core[key]).reshape(out.shape)
        if key in ("idx", "mat"):
            np.testing.assert_array_equal(ref, out.numpy(), err_msg=key)
        else:
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k12_matches_jax(case, tmp_path):
    (j_state, j_scene), h, w = CASES[case](tmp_path)
    t_state, t_scene = carry_over(j_state, j_scene)
    core, j_mxu = _jax_mxu(j_state, j_scene, h, w)
    outs = trc.render_core(t_state, t_scene, height=h, width=w, accel="mxu")
    nine = case == "textured"
    assert len(outs) == (9 if nine else 4) and ("rgb" in core) != nine
    _assert_core_close(core, outs)
    if not nine:
        np.testing.assert_array_equal(
            np.asarray(core["rgb"]).reshape(outs[3].shape).view(np.int32), outs[3].numpy())
    port = trc.raytrace(t_state, t_scene, height=h, width=w, accel="mxu")
    assert_frames_close(j_ref(j_state, j_scene, height=h, width=w), port)
    assert_frames_close(j_mxu, port)
    assert (port.segmask.numpy() >= 0).any()
    if case == "multichunk_24x40":
        # Raster mode, with the second camera's znear of 2 (camera-plane).
        state2 = dataclasses.replace(j_state, camera_znear=jnp.array([[0.0, 2.0]], jnp.float32))
        t_state2, _ = carry_over(state2, j_scene)
        ref = j_raster_ref(state2, j_scene, height=h, width=w)
        assert_frames_close(ref, raster_cuda.rasterize(t_state2, t_scene, height=h, width=w,
                                                       accel="mxu"))
        raster_core, j_raster = _jax_mxu(state2, j_scene, h, w, raster=True, near=0.001)
        _assert_core_close(raster_core, trc.render_core(
            t_state2, t_scene, height=h, width=w, near=0.001, accel="mxu", raster=True))
        assert_frames_close(j_raster, raster_cuda.rasterize(t_state2, t_scene, height=h,
                                                            width=w, accel="mxu"))


def test_mxu_shadows_take_the_epilogue():
    """tests/test_shadows.py:194: shadows under accel="mxu" go through the
    9-output mode and compute_lit; the frames match the jnp reference and
    the JAX mxu route, and the shadow darkens the ground."""
    state, scene = build(
        [quad_xz(half=50.0, y=0.0), quad_xz(half=2.0, y=0.0)],
        [ImportedInstance(position=[0, 10, 0], rotation=[1, 0, 0, 0], object_id=0),
         ImportedInstance(position=[0, 5, 0], rotation=[1, 0, 0, 0], object_id=1)],
        [ImportedCamera(position=[0, 0, 0], rotation=[1, 0, 0, 0])],
    )
    scene = j_light(scene, lights=[((1.0, 1.0, 0.0), (1.0, 1.0, 1.0))])
    t_state, t_scene = carry_over(state, scene)
    kw = dict(height=32, width=32, shadows=True)
    assert trc.pack_inputs(t_state, t_scene, accel="mxu", **kw)["nine"]
    port = trc.raytrace(t_state, t_scene, accel="mxu", **kw)
    assert_frames_close(j_ref(state, scene, **kw), port)
    assert_frames_close(_jax_mxu(state, scene, 32, 32, shadows=True)[1], port)
    lit = trc.raytrace(t_state, t_scene, accel="mxu", height=32, width=32)
    darker = lit.rgb.numpy()[..., :3].astype(int) - port.rgb.numpy()[..., :3]
    assert (darker >= 0).all() and (darker > 10).any()


def test_k12_reads_the_jax_row_layout():
    """Every value K12 reads from K13's raw rows is the JAX 32-row layout's
    (``_pack_rows_planar(state, scene)``, split off): rows 0-9 (v0, the
    edges times the validity, the validity) and the attributes, rows 16-35
    here and 10-29 there, bitwise."""
    (j_state, j_scene), _, _ = _multichunk()
    t_state, t_scene = carry_over(j_state, j_scene)
    port = pack_cuda.pack_rows(t_state, t_scene, None).numpy()
    ref = np.asarray(j_pack_rows(j_state, j_scene))
    assert ref.shape[1] == 32 and port.shape[1] == 40
    np.testing.assert_array_equal(port[:, 0:10], ref[:, 0:10])
    np.testing.assert_array_equal(port[:, 16:36], ref[:, 10:30])


def test_mxu_refusals():
    """The JAX package's refusals under accel="mxu": a seed (render_core and
    the warm start), watertight, mip-mapped pools; an untextured scene with
    shadows and the trilinear filter renders (tests/test_mips.py:630)."""
    state, scene = build(
        [quad_xz(half=50.0, y=0.0)],
        [ImportedInstance(position=[0, 10, 0], rotation=[1, 0, 0, 0], scale=[1, 1, 1],
                          object_id=0)],
        [ImportedCamera(position=[0, 0, 0], rotation=[1, 0, 0, 0])],
    )
    t_state, t_scene = carry_over(state, scene)
    kw = dict(height=16, width=16, accel="mxu")
    with pytest.raises(ValueError, match="seed_t is not supported with accel='mxu'"):
        trc.raytrace(t_state, t_scene, seed_t=torch.ones((1, 1, 16, 16)), **kw)
    with pytest.raises(ValueError, match="seed_t is not supported with accel='mxu'"):
        warmstart.raytrace_warmstart(t_state, t_scene, prev_depth=torch.ones((1, 1, 16, 16)),
                                     **kw)
    with pytest.raises(ValueError, match="watertight=True is not supported with accel='mxu'"):
        trc.raytrace(t_state, t_scene, watertight=True, **kw)
    with pytest.raises(ValueError, match="seed_t is not supported"):
        tm.Manager(t_demo(1, tm.RenderMode.Raytracer, 16, 16, warmstart=True, accel="mxu",
                          device="cpu"))
    f = trc.raytrace(t_state, t_scene, shadows=True, texture_filter="trilinear", **kw)
    assert f.rgb.shape == (1, 1, 16, 16, 4)
    assert_frames_close(j_ref(state, scene, height=16, width=16, shadows=True), f)
    mipped = tm.Manager(t_demo(1, tm.RenderMode.Raytracer, 16, 16, textured=True,
                               tex_size=256, device="cpu"))
    assert trc.has_mips(mipped.scene)
    with pytest.raises(ValueError, match="paged kernel path"):
        trc.raytrace(mipped.state, mipped.scene, **kw)


def test_mxu_manager_steps():
    """The Manager passes accel="mxu" through: the demo fleet steps through
    K12's plain version, and moving world 0's cube changes its frames
    only."""
    r = tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 16, 16, dynamic=True, accel="mxu",
                          device="cpu"))
    ref = tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 16, 16, dynamic=True, device="cpu"))
    seg = r.segmask_tensor().to_torch()
    assert torch.equal(seg, ref.segmask_tensor().to_torch())
    before = r.rgb_tensor().to_torch().clone()
    r.instance_position_tensor().to_torch()[0][0] += 0.5
    r.step()
    after = r.rgb_tensor().to_torch()
    assert not torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
