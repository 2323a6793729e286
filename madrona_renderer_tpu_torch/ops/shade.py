"""Shading constants and the packed-pixel view.

One or more directional lambert lights plus a constant ambient term,
matching the lighting model the reference configures (``configureLighting``
usage, reference ``src/mgr.cpp:356-359``). The shading itself runs inside
the render kernel (``ops/raytrace_cuda.py``); this module keeps what both
sides share:

  * ``AMBIENT = 0.2`` constant ambient.
  * Misses produce RGBA (0, 0, 0, 255), depth 0.0, segmask -1.
"""

from __future__ import annotations

import torch

AMBIENT = 0.2


def packed_to_rgba8(packed: torch.Tensor) -> torch.Tensor:
    """Packed 32-bit pixels ``[...]`` (i32 or u32) → u8 ``[..., 4]``, a view
    in little-endian byte order, i.e. RGBA."""
    if not packed.is_contiguous():
        packed = packed.contiguous()
    return packed.view(torch.uint8).reshape(*packed.shape, 4)
