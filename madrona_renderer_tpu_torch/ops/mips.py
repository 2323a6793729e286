"""Mip levels, the per-tile window clamp and mip sampling (torch ops).

The port's copy of the JAX package's ``ops/mips.py``: the building blocks
of kernel K7's plain version (``raytrace_cuda.shade_mip_plain``). The bake
(``core/scene.bake_scene(mipmaps=...)``) lays the texel pool out as
``[fallback region | fine levels]``; the region (``fb_rows`` rows of 128
texels) holds every texture's coarse chain. Per pixel:

  * the level is ⌊log₂ fp⌋ for the footprint
    ``fp = t · (2 / height) · tan_y · density`` (texels per pixel at the
    base level), computed as Σ_l [fp ≥ 2^l]: exact compares;
  * the TPU kernel copied one ``PAGE_ROWS``-row window of the fine levels
    per pixel tile, anchored at the tile's magnified (level 0) pixels when
    any exist, and a pixel whose taps fall outside it samples its
    material's coarse chain instead (``clamp_levels``). That decision is
    part of the frames, so it is reproduced here on the TPU's tiling
    (``tile_geometry``), whatever the CUDA blocks are.

Unlike the JAX helpers, these take the kernel's own inputs: the material
ids, the mip table (``shade.mip_table``: colour, coarse level, then offset,
width and height per level, all f32) and the packed texel pool
(``shade.texel_pool``), so the plain version samples as the kernel does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.scene import TEX_PAGE_ROWS as PAGE_ROWS
from .shade import dequant, _wrap

TILE_LANE = 128
TILE_SUB_MIN = 8
TILE_SUB_MAX = 32
_BIG = 1 << 30


def pick_tile_sub(n_pixels: int) -> int:
    """Largest power-of-two sublane count ≤ 32 the image fills: the TPU
    kernel's pixel-tile height."""
    need = -(-n_pixels // TILE_LANE)
    sub = TILE_SUB_MIN
    while sub < TILE_SUB_MAX and sub < need:
        sub *= 2
    return sub


def tile_geometry(height: int, width: int):
    """(tile_sub, tiles_x, n_tiles) of the TPU tiling: 2D (tile_sub × 128)
    rectangles when the image is a multiple of 128 wide, at least 256, and
    at least tile_sub high, else bands of tile_sub · 128 flattened
    pixels."""
    P = height * width
    tile_sub = pick_tile_sub(P)
    tiles_x = 1
    if width % TILE_LANE == 0 and width // TILE_LANE >= 2 and height >= tile_sub:
        tiles_x = width // TILE_LANE
    if tiles_x > 1:
        n_tiles = tiles_x * (-(-height // tile_sub))
    else:
        n_tiles = -(-P // (tile_sub * TILE_LANE))
    return tile_sub, tiles_x, n_tiles


def tile_ids(height: int, width: int, tile_sub: int, tiles_x: int,
             device="cpu") -> torch.Tensor:
    """i32 [H·W]: the tile that owns each pixel."""
    y = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    x = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    if tiles_x > 1:
        tid = (y // tile_sub) * tiles_x + x // TILE_LANE
    else:
        tid = (y * width + x) // (tile_sub * TILE_LANE)
    return tid.expand(height, width).reshape(-1)


def footprint(t, tan_y, height: int, density):
    """``t · (2 / height) · tan_y · density``, in that order."""
    return t * float(np.float32(2.0 / height)) * tan_y * density


def mip_level(fp, num_levels: int):
    """Per-pixel level in [0, num_levels): Σ_l [fp ≥ 2^l]."""
    lvl = torch.zeros(fp.shape, dtype=torch.int32, device=fp.device)
    for level in range(1, num_levels):
        lvl = lvl + (fp >= float(2.0 ** level)).to(torch.int32)
    return lvl


def _pow2(level):
    """2^level as f32, exact."""
    return torch.bitwise_left_shift(torch.ones_like(level), level).to(torch.float32)


def mip_blend_weight(fp, level):
    """Trilinear weight between ``level`` and ``level + 1``:
    clamp(fp / 2^level − 1, 0, 1)."""
    return torch.clamp(fp / _pow2(level) - 1.0, 0.0, 1.0)


def level_boundary_mask(fp, num_levels: int, rel: float = 1e-4):
    """Pixels whose footprint lies within ``rel`` of a 2^l boundary, where
    the level is ambiguous between two hit computations."""
    near = torch.zeros(fp.shape, dtype=torch.bool, device=fp.device)
    for level in range(1, num_levels):
        b = float(2.0 ** level)
        near = near | ((fp - b).abs() <= rel * b)
    return near


def num_levels(table: torch.Tensor) -> int:
    return (int(table.shape[0]) - 4) // 3


def mip_taps(table, mat, u, v, level, texture_filter: str):
    """The taps of ``level``: (flat pool indices, ax, ay) — one index for
    nearest (ax = ay = None), four for bilinear, in (0,0), (1,0), (0,1),
    (1,1) order (``raytrace_pallas.py:3259-3296``)."""
    m = mat.long()
    row = 4 + 3 * level.long()
    off, wf, hf = table[row, m], table[row + 1, m], table[row + 2, m]
    w_i = wf.to(torch.int32)
    h_i = hf.to(torch.int32)
    off_i = off.to(torch.int32)
    uu = u - torch.floor(u)
    vv = v - torch.floor(v)
    if texture_filter == "nearest":
        tx = torch.minimum(torch.clamp_min((uu * wf).to(torch.int32), 0), w_i - 1)
        ty = torch.minimum(torch.clamp_min(((1.0 - vv) * hf).to(torch.int32), 0),
                           h_i - 1)
        return (off_i + ty * w_i + tx,), None, None
    fx = uu * wf - 0.5
    fy = (1.0 - vv) * hf - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    flats = tuple(
        off_i + _wrap(y0 + dy, h_i) * w_i + _wrap(x0 + dx, w_i)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1))
    )
    return flats, fx - x0f, fy - y0f


def mip_tap_rows(table, mat, u, v, level, texture_filter: str):
    """(row_lo, row_hi) i32: the least and greatest 128-texel pool row the
    pixel's taps at ``level`` touch (trilinear callers pass "bilinear" per
    level)."""
    flats, _, _ = mip_taps(table, mat, u, v, level, texture_filter)
    rows = [f // TILE_LANE for f in flats]
    lo = hi = rows[0]
    for r in rows[1:]:
        lo = torch.minimum(lo, r)
        hi = torch.maximum(hi, r)
    return lo, hi


def _segment_min(vals, tid, n_tiles: int, fill: int):
    """Per-tile min of ``vals [..., P]`` grouped by ``tid [P]``, broadcast
    back per pixel."""
    P = vals.shape[-1]
    v2 = vals.reshape(-1, P)
    idx = tid.long().expand(v2.shape[0], P)
    acc = torch.full((v2.shape[0], n_tiles), fill, dtype=vals.dtype, device=vals.device)
    acc = acc.scatter_reduce(1, idx, v2, "amin", include_self=True)
    return torch.gather(acc, 1, idx).reshape(vals.shape)


def window_base(row_lo, row_hi, fine, level, tid, n_tiles: int):
    """Per pixel (the same across a tile): the 8-aligned first row of the
    tile's window. It anchors at the least row_lo of the tile's magnified
    (level 0) pixels when any exist, else of any fine pixel, skipping
    pixels whose own span cannot fit one window (uv-seam wraps); 0 for a
    tile without fine pixels."""
    anchor_ok = fine & ((row_hi - row_lo) < PAGE_ROWS)
    pref = _segment_min(torch.where(anchor_ok & (level == 0), row_lo, _BIG),
                        tid, n_tiles, _BIG)
    anyf = _segment_min(torch.where(anchor_ok, row_lo, _BIG), tid, n_tiles, _BIG)
    r0 = torch.where(pref < _BIG, pref, anyf)
    r0 = torch.where(r0 < _BIG, r0, 0)
    return (r0 // 8) * 8


def clamp_levels(table, fb_rows: int, mat, u, v, level, hit, tid, n_tiles: int,
                 texture_filter: str, tile_clamp_blend=None):
    """The per-pixel window clamp with three tiers: primary taps in the
    window → sample as asked; primary in, trilinear secondary out (and the
    blend live: ``tile_clamp_blend`` > 0 at the unclamped level) → the
    primary level alone (``kill``); primary out → the coarse chain,
    max(level, fit). Returns (clamped level, kill or None)."""
    prim = "bilinear" if texture_filter == "trilinear" else texture_filter
    plo, phi = mip_tap_rows(table, mat, u, v, level, prim)
    fine = hit & (phi >= fb_rows)
    base = window_base(plo, phi, fine, level, tid, n_tiles)
    prim_in = (plo >= base) & (phi < base + PAGE_ROWS)
    fit = table[3, mat.long()].to(torch.int32)
    out = torch.where(fine & ~prim_in, torch.maximum(level, fit), level)
    kill = None
    if texture_filter == "trilinear":
        top = num_levels(table) - 1
        slo, shi = mip_tap_rows(table, mat, u, v,
                                torch.clamp_max(level + 1, top), "bilinear")
        sec_ok = (~(tile_clamp_blend > 0.0) | (shi < fb_rows)
                  | ((slo >= base) & (shi < base + PAGE_ROWS)))
        kill = fine & prim_in & ~sec_ok
    return out, kill


def sample_texture_mip(table, pool, mat, u, v, level, texture_filter: str,
                       blend=None):
    """The texel colour at ``level`` → (r, g, b) f32; trilinear blends the
    bilinear samples of ``level`` and ``min(level + 1, L - 1)`` by
    ``blend`` as ``c0 · (1 − w) + c1 · w``."""
    if texture_filter == "trilinear":
        c0 = sample_texture_mip(table, pool, mat, u, v, level, "bilinear")
        top = num_levels(table) - 1
        c1 = sample_texture_mip(table, pool, mat, u, v,
                                torch.clamp_max(level + 1, top), "bilinear")
        return tuple(a * (1.0 - blend) + b * blend for a, b in zip(c0, c1))
    flats, ax, ay = mip_taps(table, mat, u, v, level, texture_filter)
    texels = [pool[f.long()] for f in flats]
    if texture_filter == "nearest":
        return tuple(dequant((texels[0] >> (8 * c)) & 255) for c in range(3))
    t00, t10, t01, t11 = texels
    out = []
    for c in range(3):
        sh = 8 * c
        c00 = dequant((t00 >> sh) & 255)
        c10 = dequant((t10 >> sh) & 255)
        c01 = dequant((t01 >> sh) & 255)
        c11 = dequant((t11 >> sh) & 255)
        top_row = c00 * (1.0 - ax) + c10 * ax
        bot_row = c01 * (1.0 - ax) + c11 * ax
        out.append(top_row * (1.0 - ay) + bot_row * ay)
    return tuple(out)


def mip_levels(table, fb_rows: int, mat, u, v, fp, hit, height: int,
               width: int, texture_filter: str):
    """Each pixel's level, clamped level, blend kill (trilinear, else None)
    and blend weight (trilinear, else None), for views ``[V, H·W]``."""
    lvl = mip_level(fp, num_levels(table))
    tile_sub, tiles_x, n_tiles = tile_geometry(height, width)
    tid = tile_ids(height, width, tile_sub, tiles_x, device=fp.device)
    clamp_blend = None
    if texture_filter == "trilinear":
        clamp_blend = mip_blend_weight(fp, lvl)
    lvl_c, kill = clamp_levels(table, fb_rows, mat, u, v, lvl, hit, tid, n_tiles,
                               texture_filter, tile_clamp_blend=clamp_blend)
    blend = None
    if texture_filter == "trilinear":
        blend = torch.where(kill, 0.0, mip_blend_weight(fp, lvl_c))
    return lvl, lvl_c, kill, blend


def mip_base(table, pool, fb_rows: int, mat, u, v, fp, hit, height: int,
             width: int, texture_filter: str):
    """The mip-sampled base colour (material colour × texel) → (r, g, b),
    each ``[V, H·W]`` (the plain version of K7's sampling)."""
    _, lvl_c, _, blend = mip_levels(table, fb_rows, mat, u, v, fp, hit, height,
                                    width, texture_filter)
    col = sample_texture_mip(table, pool, mat, u, v, lvl_c, texture_filter, blend)
    m = mat.long()
    return tuple(table[k, m] * col[k] for k in range(3))
