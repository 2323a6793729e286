"""Temporal depth warm start with exactness repair, on the kernel's seed (K9).

The port of the JAX package's ``ops/warmstart.py`` (``raytrace_warmstart``
:39, ``raytrace_prepass`` :99). The reference traces every frame cold; this
tier seeds each pixel's search window with an upper bound on its hit t
(``raytrace_cuda.render_resident(seed=)``), so a walk with the occlusion
early exit (the ordered and binned visits, resident or streamed) stops as
soon as no pixel's window reaches the next cluster (the non-culled sweep
K1-none takes the seed too, as the JAX non-culled launch does; the batched
kernel K12, ``accel="mxu"``, has none and raises). Two seeded passes whose
merge is bitwise equal to a cold render, however stale the seed:

 1. main pass: ``best_t`` seeded with ``prev_depth × slack`` (non-positive
    depths, the export's misses, seed ``far``: the cold window);
 2. suspects: pixels that missed under a finite seed (their nearest hit may
    lie beyond it, or they are background);
 3. repair pass, only when there are suspects: the suspects re-rendered
    with the cold window while every other pixel seeds 0 (it accepts
    nothing and never holds a walk's exit back);
 4. the per-pixel merge.

A pixel that is not a suspect hit inside a valid upper bound (the cold
winner: the first minimum under a bound that admits it) or missed with the
cold window; a suspect comes from the repair pass, rendered cold. Both
passes share one prologue (``pack_inputs``): only the seed differs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.frames import Frames
from ..core.scene import SceneData
from ..core.state import SimState
from . import raytrace_cuda


def raytrace_warmstart(state: SimState, scene: SceneData, *, prev_depth: torch.Tensor,
                       slack: float = 1.01, **kw) -> Frames:
    """Render with a previous frame's depth as the seed; bitwise equal to
    ``raytrace_cuda.raytrace(state, scene, **kw)`` for any ``prev_depth``.

    ``prev_depth``: ``[W, C, H, Wd]`` ray-t values (a previous
    ``Frames.depth``). ``slack``: headroom for motion between frames; a
    larger value repairs fewer pixels but cuts less of the walk. ``kw``:
    ``raytrace``'s keyword arguments."""
    far = float(kw.get("far", 1000.0))
    raytrace_cuda.check_seedable(kw.get("accel", "auto"))
    inputs = raytrace_cuda.pack_inputs(state, scene, **kw)
    views, height, width = int(inputs["cams"].shape[0]), kw["height"], kw["width"]
    prev = prev_depth.to(torch.float32).reshape(views, height, width)
    far_t = torch.tensor(far, dtype=torch.float32, device=prev.device)
    seed = torch.where(prev > 0.0, torch.minimum(prev * slack, far_t), far_t).contiguous()
    outs = raytrace_cuda.render_resident(**inputs, seed=seed)
    # A suspect missed under a finite window: its hit may lie beyond it. The
    # fused outputs carry the miss in the segmask, the 9-output mode in idx.
    miss = (outs[1] if len(outs) == 3 else outs[2]) < 0
    suspect = miss & (seed < far)
    if bool(suspect.any()):
        repair = torch.where(suspect, far_t, torch.zeros_like(far_t)).contiguous()
        fixed = raytrace_cuda.render_resident(**inputs, seed=repair)
        outs = tuple(torch.where(suspect, b, a) for a, b in zip(outs, fixed))
    return raytrace_cuda.frames_from_core(
        state, *outs, scene=scene, far=far, fov_y_degrees=kw.get("fov_y_degrees", 90.0),
        texture_filter=kw.get("texture_filter", "nearest"),
        shadows=kw.get("shadows", False))


def raytrace_prepass(state: SimState, scene: SceneData, *, factor: int = 8,
                     slack: float = 1.02, height: int, width: int, **kw) -> Frames:
    """A coarse depth prepass as the seed: render at 1/``factor`` of the
    resolution (at least 8×8, without shadows and with nearest sampling,
    which change neither depth nor segmask), map misses to ``far``, take
    the conservative 3×3 maximum (edges repeated), upsample to the full
    size by nearest neighbour, and render through ``raytrace_warmstart``:
    bitwise equal to a cold render, with no previous frame needed."""
    if factor < 2:
        raise ValueError("prepass factor must be >= 2")
    far = float(kw.get("far", 1000.0))
    hc, wc = max(height // factor, 8), max(width // factor, 8)
    coarse = raytrace_cuda.raytrace(state, scene, height=hc, width=wc,
                                    **dict(kw, shadows=False, texture_filter="nearest"))
    d = torch.where(coarse.segmask >= 0, coarse.depth, far)  # [W, C, hc, wc]
    W, C = d.shape[:2]
    dp = F.pad(d.reshape(W * C, 1, hc, wc), (1, 1, 1, 1), mode="replicate")
    dp = dp.reshape(W, C, hc + 2, wc + 2)
    m = d
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            m = torch.maximum(m, dp[:, :, dy:dy + hc, dx:dx + wc])
    # Coarse pixel i covers fine rows [i·height/hc, (i+1)·height/hc).
    ys = torch.arange(height, device=d.device) * hc // height
    xs = torch.arange(width, device=d.device) * wc // width
    up = m[:, :, ys][:, :, :, xs]
    return raytrace_warmstart(state, scene, prev_depth=up, slack=slack, height=height,
                              width=width, **kw)
