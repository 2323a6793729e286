"""PyTorch port: the Rasterizer path == the JAX package's.

The port's ``rasterize`` (the plain PyTorch version of the render kernel's
raster variant on the CPU) against the JAX Pallas rasterizer in interpret
mode and the jnp raster reference, on the demo scene (untextured and with
the PNG checkerboard), a random scene and the per-camera fov/znear scene;
then the Manager in ``RenderMode.Rasterizer`` against the JAX Manager. The
bar is tests/test_pallas_parity.py's: rgb within ±1 LSB, depth rtol = atol
= 1e-5, segmask exact (-1 everywhere in raster mode).
"""

import numpy as np
import pytest

import madrona_renderer_tpu as jm
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_ref
from madrona_renderer_tpu.runners.scenes import demo_config as j_demo
from madrona_renderer_tpu_torch.ops import raster_cuda, raytrace_cuda
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo
from madrona_renderer_tpu_torch.runners.scenes import renderer_kwargs

from tests.test_torch_raytrace import _fov_znear_spec
from tests.torch_helpers import (
    assert_frames_close, carry_over, random_spec, spec_from_config,
)

CASES = {
    "demo3_dynamic_64": (lambda: spec_from_config(
        j_demo(3, RenderMode.Rasterizer, 64, 64, dynamic=True)), 64, 64, "nearest"),
    "demo2_tex32_nearest_48": (lambda: spec_from_config(
        j_demo(2, RenderMode.Rasterizer, 48, 48, dynamic=True, textured=True,
               tex_size=32)), 48, 48, "nearest"),
    "demo2_tex32_bilinear_40x24": (lambda: spec_from_config(
        j_demo(2, RenderMode.Rasterizer, 24, 40, dynamic=True, textured=True,
               tex_size=32)), 40, 24, "bilinear"),
    "random4_32": (lambda: random_spec(4, n_worlds=2), 32, 32, "nearest"),
    "fov_znear_48x64": (_fov_znear_spec, 48, 64, "nearest"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_raster_frames_match_jax(case):
    make, height, width, texture_filter = CASES[case]
    j_state, j_scene = make().build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    kw = dict(height=height, width=width, texture_filter=texture_filter)
    port = raster_cuda.rasterize(t_state, t_scene, **kw)
    assert_frames_close(j_ref(j_state, j_scene, **kw), port)
    assert_frames_close(j_pallas(j_state, j_scene, interpret=True, **kw), port)
    depth = port.depth.numpy()
    assert (depth > 0).any()
    assert (port.segmask.numpy() == -1).all()
    # Camera-plane depth is never beyond the ray distance of the same pixel.
    rt = raytrace_cuda.raytrace(t_state, t_scene, **kw).depth.numpy()
    both = (depth > 0) & (rt > 0)
    assert both.any() and (depth[both] <= rt[both] * (1 + 1e-6)).all()


def test_raster_near_plane_clips_per_pixel():
    """A wall just beyond znear on the axis: the centre pixels see it, the
    corner rays (smaller cos) see it at a larger t, still z > znear."""
    spec = _fov_znear_spec()
    j_state, j_scene = spec.build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    kw = dict(height=32, width=32, near=4.5)
    port = raster_cuda.rasterize(t_state, t_scene, **kw)
    assert_frames_close(j_ref(j_state, j_scene, **kw), port)
    depth = port.depth.numpy()
    assert ((depth == 0) | (depth >= 4.5 * (1 - 1e-6))).all()


@pytest.fixture(scope="module")
def managers():
    j = jm.Manager(j_demo(3, jm.RenderMode.Rasterizer, 32, 32, dynamic=True,
                          textured=True, tex_size=32, impl="jnp"))
    t = tm.Manager(t_demo(3, tm.RenderMode.Rasterizer, 32, 32, dynamic=True,
                          textured=True, tex_size=32, device="cpu"))
    return j, t


def test_manager_raster_exports(managers):
    """Depth carries the trailing singleton and segmask raises, as the JAX
    Manager (and the reference, src/mgr.cpp:570-595) does."""
    j, t = managers
    assert t.depth_tensor().shape == j.depth_tensor().shape == (3, 32, 32, 1)
    assert t.rgb_tensor().shape == j.rgb_tensor().shape == (3, 32, 32, 4)
    for m in (j, t):
        with pytest.raises(RuntimeError, match="Segmask not implemented for rasterizer"):
            m.segmask_tensor()
    np.testing.assert_array_equal(t.depth_tensor().numpy()[..., 0],
                                  t.frames.depth.numpy()[:, 0])


def test_manager_raster_frames_match_over_mutated_steps(managers):
    j, t = managers
    j_pos = j.instance_position_tensor().to_torch()
    t_pos = t.instance_position_tensor().to_torch()
    for _ in range(2):
        before = t.rgb_tensor().numpy().copy()
        for pos in (j_pos, t_pos):
            pos[0][0] += 0.5
            pos[0][2] += 0.25
        j.step()
        t.step()
        assert_frames_close(j.frames, t.frames)
        after = t.rgb_tensor().numpy()
        assert (after[0] != before[0]).any()
        np.testing.assert_array_equal(after[1:], before[1:])


def test_madrona_renderer_raster_textured_bilinear():
    """The user-facing constructor in raster mode with a textured scene and
    bilinear filtering renders, and matches the JAX package's Manager."""
    cfg = t_demo(2, tm.RenderMode.Rasterizer, 48, 48, textured=True, tex_size=32)
    r = tm.MadronaRenderer(0, 2, tm.RenderMode.Rasterizer, 48, 48, device="cpu",
                           texture_filter="bilinear", **renderer_kwargs(cfg))
    j = jm.Manager(j_demo(2, jm.RenderMode.Rasterizer, 48, 48, textured=True,
                          tex_size=32, texture_filter="bilinear", impl="jnp"))
    assert_frames_close(j.frames, r.frames)
    # Background and plane, and the checker's two colours on the cube's faces.
    rgb = r.rgb_tensor().numpy()
    assert len(np.unique(rgb[..., :3].reshape(-1, 3), axis=0)) > 4


def test_trilinear_without_mips_raises():
    cfg = t_demo(1, tm.RenderMode.Rasterizer, 16, 16, textured=True, tex_size=32,
                 texture_filter="trilinear", device="cpu")
    with pytest.raises(ValueError, match="trilinear"):
        tm.Manager(cfg)
