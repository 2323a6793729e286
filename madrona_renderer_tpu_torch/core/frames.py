"""Output frames.

The analog of the reference's ``RaycastOutputArchetype`` export columns —
RGB (u8 RGBA), depth (f32), segmask (i32) per view (reference
``src/sim.cpp:52-60``) — as plain returned tensors. Shapes keep the padded
``[worlds, cameras, H, W, ...]`` layout; the flat ``[total_cams, ...]``
tensors of the public API are gathered from them (see
``madrona_renderer_tpu_torch.manager``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Frames:
    rgb: torch.Tensor  # u8 [W, C, H, Wd, 4]
    depth: torch.Tensor  # f32 [W, C, H, Wd]
    segmask: torch.Tensor  # i32 [W, C, H, Wd]  (-1 = miss / not applicable)
