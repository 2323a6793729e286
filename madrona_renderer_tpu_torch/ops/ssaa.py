"""Supersampled antialiasing (SSAA): a beyond-reference quality tier.

The port's copy of the JAX package's ``ops/ssaa.py``. The reference
point-samples one ray per pixel (``src/mgr.cpp:443-492``), so silhouette
edges alias hard at the low RL resolutions it targets.
``Manager(ssaa=s)`` renders every view at ``s x`` resolution and
box-filters it back down:

 * **rgb**: the exact integer box filter over the ``s*s`` subsamples
   (int32 sums, rounding half up);
 * **depth / segmask**: the centre subsample (``s // 2``). Instance ids
   cannot be averaged, and blending depth across a silhouette would
   fabricate mid-air surfaces, so both stay point-sampled, at the
   subsample nearest the pixel centre.

Rays are generated at subpixel centres ``(i + 0.5) / (s*H)``, so the
``s*s`` subsamples tile each output pixel uniformly. These are torch ops,
not a kernel (the JAX package leaves them to XLA too). The rgb sum reads
the u8 subsamples and accumulates in int32 inside one reduction
(``sum(dtype=torch.int32)``), so no int32 copy of the supersampled image
is made; ``port_tools/ssaa_filter_ab.py`` times it against a per-channel
shift-and-mask form and a two-channels-per-word form of the same sums.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.frames import Frames


def downsample_frames(frames: Frames, s: int) -> Frames:
    """Box-filter ``s x``-supersampled frames to output resolution."""
    if s <= 1:
        return frames
    w, c, hs, ws, ch = frames.rgb.shape  # u8 [W, C, H*s, Wd*s, 4]
    h, wd = hs // s, ws // s
    acc = frames.rgb.reshape(w, c, h, s, wd, s, ch).sum(dim=(3, 5), dtype=torch.int32)
    n = s * s
    rgb8 = ((acc + n // 2) // n).to(torch.uint8)
    mid = s // 2
    depth = frames.depth.reshape(w, c, h, s, wd, s)[:, :, :, mid, :, mid]
    seg = frames.segmask.reshape(w, c, h, s, wd, s)[:, :, :, mid, :, mid]
    return dataclasses.replace(frames, rgb=rgb8, depth=depth, segmask=seg)


def upsample_depth(depth: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest-upsample a [W, C, H, Wd] depth map by ``s`` on both image
    axes (the warm-start seed for a supersampled render)."""
    if s <= 1:
        return depth
    return depth.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
