"""PyTorch port: worlds with several cameras == the JAX package's.

More than one camera per world takes the raw-row sweep (kernel K1-raw):
the prologue packs v0 / e1 / e2 rows with no camera origin baked in, and
each view sweeps them from its own camera (``render_core`` :4342-4347).
The port's ``raytrace`` / ``rasterize`` (the kernel's plain PyTorch version
on the CPU) against the JAX Pallas kernel in interpret mode and the jnp
reference, then ``MadronaRenderer`` against the JAX Manager. The bar is
tests/test_pallas_parity.py's: rgb within ±1 LSB, depth rtol = atol = 1e-5,
segmask exact.
"""

import numpy as np
import pytest

import madrona_renderer_tpu as jm
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_raster_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu.runners.scenes import demo_config as j_demo
from madrona_renderer_tpu_torch.ops import pack_cuda, raster_cuda
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo
from madrona_renderer_tpu_torch.runners.scenes import renderer_kwargs

from tests.torch_helpers import (
    IDENTITY, SceneSpec, assert_frames_close, carry_over, quad_xz, spec_from_config,
)


def _multicam_spec(n_worlds, n_cams, seed=137):
    """tests/test_pallas_parity.py::_multicam_scene: per-world distinct
    instances and per-camera distinct poses and fov, so a view that read
    another view's camera or another world's rows would show."""
    rng = np.random.default_rng(seed)
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        insts.append(dict(
            position=[float(rng.uniform(-3, 3)), float(10 + 2 * w),
                      float(rng.uniform(-3, 3))],
            rotation=IDENTITY, scale=[1 + 0.2 * w, 1, 1 + 0.1 * w], object_id=0))
        for c in range(n_cams):
            cams.append(dict(
                position=[float(rng.uniform(-1, 1)), float(rng.uniform(-0.5, 0.5)),
                          float(rng.uniform(-1, 1))],
                rotation=IDENTITY, fov_y_degrees=float(70 + 10 * c)))
        worlds.append(dict(num_instances=1, instance_offset=w, num_cameras=n_cams,
                           camera_offset=w * n_cams))
    return SceneSpec([quad_xz(30.0)], insts, cams, worlds)


def _unequal_cams_spec():
    """The (2, 4) multicam scene with 4 and 2 cameras (world 1's padded
    camera slots render black / 0 / -1), turned cameras and per-camera
    znear."""
    spec = _multicam_spec(2, 4, seed=71)
    rng = np.random.default_rng(72)
    del spec.cameras[6:]
    for c, cam in enumerate(spec.cameras):
        q = np.asarray(IDENTITY) + rng.normal(size=4) * 0.15
        cam["rotation"] = (q / np.linalg.norm(q)).tolist()
        cam["znear"] = [0.0, 0.5, 9.0][c % 3]
    spec.worlds[1]["num_cameras"] = 2
    return spec


def _demo(**kw):
    return lambda: spec_from_config(j_demo(2, RenderMode.Raytracer, 32, 32, dynamic=True,
                                           num_cams=4, **kw))


# name → (spec factory, height, width, render mode, texture filter). Scenes
# of one shape share the JAX kernels' compilations, which take most of the
# file's time.
CASES = {
    "demo2_4cams_32": (_demo(), 32, 32, "rt", "nearest"),
    "multicam_4x2_32x48": (lambda: _multicam_spec(4, 2), 32, 48, "rt", "nearest"),
    "multicam_2x4_32x48": (lambda: _multicam_spec(2, 4), 32, 48, "rt", "nearest"),
    "unequal_cams_2x4_32x48": (_unequal_cams_spec, 32, 48, "rt", "nearest"),
    "demo2_4cams_tex32_nearest": (_demo(textured=True, tex_size=32), 32, 32, "rt",
                                  "nearest"),
    "demo2_4cams_tex32_bilinear": (_demo(textured=True, tex_size=32), 32, 32, "rt",
                                   "bilinear"),
    "raster_demo2_4cams_32": (_demo(), 32, 32, "raster", "nearest"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multicam_frames_match_jax(case):
    make, height, width, mode, texture_filter = CASES[case]
    j_state, j_scene = make().build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    assert t_state.max_cameras > 1
    kw = dict(height=height, width=width, texture_filter=texture_filter)
    if mode == "raster":
        port = raster_cuda.rasterize(t_state, t_scene, **kw)
        assert_frames_close(j_raster_ref(j_state, j_scene, **kw), port)
        assert_frames_close(j_raster_pallas(j_state, j_scene, interpret=True, **kw), port)
    else:
        port = trc.raytrace(t_state, t_scene, **kw)
        assert_frames_close(j_ref(j_state, j_scene, **kw), port)
        assert_frames_close(j_pallas(j_state, j_scene, interpret=True, **kw), port)
    depth = port.depth.numpy()
    valid = t_state.camera_valid.numpy() > 0
    # Every valid view sees something; padded camera slots are black / 0 / -1.
    assert (depth[valid] > 0).reshape(valid.sum(), -1).any(1).all()
    assert (depth[~valid] == 0).all() and (port.segmask.numpy()[~valid] == -1).all()
    rgb = port.rgb.numpy()[~valid]
    assert (rgb[..., :3] == 0).all() and (rgb[..., 3] == 255).all()
    # The views of one world differ from each other.
    assert not np.array_equal(depth[0, 0], depth[0, 1])


def test_multicam_prologue_takes_the_raw_rows():
    """C > 1: the rows are K13's raw layout and the kernel's raw variant
    runs; the wrappers on CPU tensors launch nothing."""
    t_state, t_scene = spec_from_config(t_demo(2, tm.RenderMode.Raytracer, 16, 16,
                                               num_cams=3)).build_torch()
    kw = trc.pack_inputs(t_state, t_scene, height=16, width=16)
    assert kw["geo"] == "raw" and kw["num_cams"] == 3
    assert kw["cams"].shape[0] == 6
    rows = trc._pack_rows_planar(t_state, t_scene)
    assert kw["rows"].equal(rows)
    before = (trc.render_resident.launches, dict(pack_cuda.pack_rows.layout_launches))
    depth, seg, rgb = trc.render_resident(**kw)
    assert depth.shape == (6, 16, 16)
    assert (trc.render_resident.launches, pack_cuda.pack_rows.layout_launches) == before
    assert trc.variant_name(False, None, "raw") == "render_resident_raw"
    with pytest.raises(ValueError, match="one camera origin"):
        trc.render_resident(**dict(kw, geo="prep"))


@pytest.fixture(scope="module")
def managers():
    j = jm.Manager(j_demo(3, jm.RenderMode.Raytracer, 32, 32, dynamic=True, num_cams=4,
                          impl="jnp"))
    cfg = t_demo(3, tm.RenderMode.Raytracer, 32, 32, dynamic=True, num_cams=4)
    t = tm.MadronaRenderer(0, 3, tm.RenderMode.Raytracer, 32, 32, device="cpu",
                           **renderer_kwargs(cfg))
    return j, t


def test_manager_multicam_exports(managers):
    """The flat exports are [worlds x cameras, ...], world-major, as the JAX
    Manager's (and the reference's) are."""
    j, t = managers
    assert t.total_num_cameras == j.total_num_cameras == 12
    for name in ("rgb_tensor", "depth_tensor", "segmask_tensor",
                 "camera_position_tensor", "camera_rotation_tensor"):
        assert getattr(t, name)().shape == getattr(j, name)().shape, name
    assert t.rgb_tensor().shape == (12, 32, 32, 4)
    np.testing.assert_array_equal(t.rgb_tensor().numpy(),
                                  t.frames.rgb.numpy().reshape(12, 32, 32, 4))
    np.testing.assert_array_equal(t.segmask_tensor().numpy(),
                                  t.frames.segmask.numpy().reshape(12, 32, 32))


def test_manager_multicam_frames_match_over_mutated_steps(managers):
    """Moving world 0's cube changes world 0's views that see it and no
    other world's, and both packages agree at the bar each step."""
    j, t = managers
    j_pos = j.instance_position_tensor().to_torch()
    t_pos = t.instance_position_tensor().to_torch()
    for _ in range(2):
        before = t.depth_tensor().numpy().copy()
        sees_cube = (t.segmask_tensor().numpy()[:4] == 0).reshape(4, -1).any(1)
        for pos in (j_pos, t_pos):
            pos[0][1] += 0.5
        j.step()
        t.step()
        assert_frames_close(j.frames, t.frames)
        after = t.depth_tensor().numpy()
        assert sees_cube.any()
        for v in np.flatnonzero(sees_cube):
            assert (after[v] != before[v]).any(), v
        np.testing.assert_array_equal(after[4:], before[4:])
