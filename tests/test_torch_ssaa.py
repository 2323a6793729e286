"""PyTorch port: supersampled antialiasing (``ops/ssaa.py``) == the JAX
package's.

``Manager(ssaa=s)`` renders every view at ``s x`` height and width, then
box-filters rgb (int32 sums, rounding half up) and takes depth and segmask
from the centre subsample. The filter is torch ops (the JAX package's is
XLA ops, no Pallas kernel); it is held bitwise against the JAX functions,
and the Manager's output bitwise against its own ``s x`` render filtered
down (tests/test_ssaa.py:42-55, :90-100), in both render modes and on a
streamed mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.core.frames import Frames as JFrames
from madrona_renderer_tpu.ops import ssaa as j_ssaa
from madrona_renderer_tpu_torch.core.frames import Frames as TFrames
from madrona_renderer_tpu_torch.ops import ssaa as t_ssaa
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config, demo_config


def _manual_downsample_rgb(rgb, s):
    """tests/test_ssaa.py's definition of the filter, in numpy."""
    n, hs, ws, ch = rgb.shape
    acc = rgb.astype(np.int64).reshape(n, hs // s, s, ws // s, s, ch).sum(axis=(2, 4))
    return ((acc + (s * s) // 2) // (s * s)).astype(np.uint8)


def _center_subsample(x, s):
    n, hs, ws = x.shape[:3]
    mid = s // 2
    return x.reshape((n, hs // s, s, ws // s, s) + x.shape[3:])[:, :, mid, :, mid]


@pytest.mark.parametrize("s", [2, 3])
def test_filters_match_jax_bitwise(s):
    """``downsample_frames`` and ``upsample_depth`` on random u8 / f32 / i32
    frames (2 worlds x 3 cameras, 4x5 output pixels) equal the JAX
    functions bit for bit; s = 1 passes the frames through."""
    rng = np.random.default_rng(s)
    shape = (2, 3, 4 * s, 5 * s)
    rgb = rng.integers(0, 256, size=shape + (4,), dtype=np.uint8)
    depth = rng.normal(size=shape).astype(np.float32) * 10
    seg = rng.integers(-1, 9, size=shape).astype(np.int32)
    want = j_ssaa.downsample_frames(
        JFrames(rgb=jnp.asarray(rgb), depth=jnp.asarray(depth), segmask=jnp.asarray(seg)), s)
    frames = TFrames(rgb=torch.from_numpy(rgb), depth=torch.from_numpy(depth),
                     segmask=torch.from_numpy(seg))
    got = t_ssaa.downsample_frames(frames, s)
    assert got.rgb.dtype == torch.uint8 and got.rgb.shape == (2, 3, 4, 5, 4)
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(want.rgb))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.segmask.numpy(), np.asarray(want.segmask))
    low = depth[:, :, ::s, ::s].copy()
    np.testing.assert_array_equal(t_ssaa.upsample_depth(torch.from_numpy(low), s).numpy(),
                                  np.asarray(j_ssaa.upsample_depth(jnp.asarray(low), s)))
    assert t_ssaa.downsample_frames(frames, 1) is frames


@pytest.mark.parametrize("mode", ["raytracer", "rasterizer"])
def test_ssaa_is_the_supersample_filtered(mode):
    """ssaa=2 at 32x32 == the 64x64 render box-filtered down, bitwise
    (tests/test_ssaa.py:42-55, :90-100), on the textured demo; the
    antialiased rgb differs from the point-sampled 32x32 render."""
    m = tm.RenderMode.Raytracer if mode == "raytracer" else tm.RenderMode.Rasterizer
    kw = dict(dynamic=True, textured=True, tex_size=32, device="cpu")
    a = tm.Manager(demo_config(2, m, 32, 32, ssaa=2, **kw))
    b = tm.Manager(demo_config(2, m, 64, 64, **kw))
    c = tm.Manager(demo_config(2, m, 32, 32, **kw))
    rgb = a.rgb_tensor().numpy()
    assert rgb.shape == (2, 32, 32, 4)
    np.testing.assert_array_equal(rgb, _manual_downsample_rgb(b.rgb_tensor().numpy(), 2))
    depth_a, depth_b = a.depth_tensor().numpy(), b.depth_tensor().numpy()
    if mode == "raytracer":
        np.testing.assert_array_equal(depth_a, _center_subsample(depth_b, 2))
        np.testing.assert_array_equal(a.segmask_tensor().numpy(),
                                      _center_subsample(b.segmask_tensor().numpy(), 2))
    else:
        assert depth_a.shape == (2, 32, 32, 1)
        np.testing.assert_array_equal(depth_a[..., 0], _center_subsample(depth_b[..., 0], 2))
    assert (rgb != c.rgb_tensor().numpy()).any()


def test_ssaa_streamed_mesh_steps():
    """ssaa=2 on bench.py's big-mesh scene (a 40x40-grid terrain: the
    streamed route at 32x32): the 32x32 render filtered down, and a step
    that moves world 0's terrain changes its frames, not world 1's."""
    a = tm.Manager(bigmesh_config(2, 16, 16, grid=40, ssaa=2, device="cpu"))
    b = tm.Manager(bigmesh_config(2, 32, 32, grid=40, device="cpu"))
    np.testing.assert_array_equal(a.rgb_tensor().numpy(),
                                  _manual_downsample_rgb(b.rgb_tensor().numpy(), 2))
    np.testing.assert_array_equal(a.segmask_tensor().numpy(),
                                  _center_subsample(b.segmask_tensor().numpy(), 2))
    rgb0 = a.rgb_tensor().to_torch().clone()
    a.instance_position_tensor().to_torch()[0][2] += 0.5
    a.step()
    rgb1 = a.rgb_tensor().to_torch()
    assert not torch.equal(rgb0[0], rgb1[0]) and torch.equal(rgb0[1], rgb1[1])


@pytest.mark.parametrize("bad", [0, -1, 1.5])
def test_ssaa_must_be_a_positive_integer(bad):
    with pytest.raises(ValueError, match="ssaa"):
        tm.Manager(demo_config(1, tm.RenderMode.Raytracer, 16, 16, ssaa=bad, device="cpu"))
