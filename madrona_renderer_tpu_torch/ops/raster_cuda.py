"""Batch rasterizer: the raster conventions on the shared kernel (K2).

The port of the JAX package's ``ops/raster_pallas.py::rasterize``. For the
scenes this renderer serves (tiny meshes, many worlds: pixels ≳ triangles)
point-sampled visibility is ray casting — one ray per pixel centre, min-t
depth competition — so the rasterizer is the raytracer's kernel in its
``raster`` variant: camera-plane depth z = t·cos, the exact per-pixel
t-space znear bound znear / cos, the z-space far clip, and no segmask
(the reference's rasterizer has none, ``src/mgr.cpp:595``). Mip-mapped
scenes take the same kernel's K7 route in these conventions. On the
resident index order's prep rows (one camera a world, no shadows,
untextured or nearest or bilinear, no mips) the raster variant runs on the
index visit's tile teams where ``raytrace_cuda.index_plan`` takes them
(K2, K2+K6: blocks of two groups where the views are few); its other
modes keep the parent design, one 16x16 block a tile.
"""

from __future__ import annotations

from ..core.frames import Frames
from ..core.scene import SceneData
from ..core.state import SimState
from .raytrace_cuda import frames_from_core, render_core


def rasterize(state: SimState, scene: SceneData, *, height: int, width: int,
              near: float = 0.001, far: float = 1000.0,
              fov_y_degrees: float = 90.0,
              texture_filter: str = "nearest", shadows: bool = False,
              watertight: bool = False, accel: str = "auto",
              deferred_mxu: bool = False) -> Frames:
    """Raster-convention rendering → padded ``Frames``: depth is
    camera-plane z (0 on a miss or past ``far``), segmask is -1 everywhere,
    invalid camera slots render black. With ``shadows`` the shadow rays
    start at the hit point's ray distance t, not at z; on scenes baked with
    mip chains the mip level reads t too, and the window clamp keys on the
    geometric hit, before the far clip (the JAX ``raster_ref.py:108-123``).
    ``watertight`` passes through to the shared kernel's Woop decision, as
    in the JAX ``raster_pallas.py:79-92``; ``accel`` (the JAX package's five
    values, "none" and "mxu" among them, :65-95) picks the route and
    ``deferred_mxu`` K11 on the streamed visits, as in
    ``raytrace_cuda.render_core``."""
    return frames_from_core(state, *render_core(
        state, scene, height=height, width=width, near=near, far=far,
        fov_y_degrees=fov_y_degrees, raster=True,
        texture_filter=texture_filter, shadows=shadows, watertight=watertight,
        accel=accel, deferred_mxu=deferred_mxu,
    ), scene=scene, raster=True, far=far, fov_y_degrees=fov_y_degrees,
        texture_filter=texture_filter, shadows=shadows)
