"""The render kernel's cluster walks replayed in torch ops.

``streamed_walk`` repeats, block by block, what a 16×16 block of the
streamed render kernel (``csrc/render_resident.cu``, ``STREAM``) decides:
along its view's cluster order it stops at the first cluster that is
invalid or that no ray can reach (best_t² ≤ 0.998 · approach distance²),
skips a cluster whose pixel-row span misses the block's rows or whose slab
test (tmin · 0.999 < best_t) no ray passes, and sweeps the rest, the lower
index winning an exact tie (under the watertight sweep's geometry codes,
with the Woop decision). With shadows it repeats each light's index-order
any-hit walk. It returns the frames' depth and segmask (equal to
``render_resident_plain``'s when the culls are conservative, which the tests
check) and the work: positions gated, clusters and triangles swept per
block, and the distinct (world, cluster) pairs whose rows some block
streamed — what the kernel's bound counts. Every block's threads trace
rays, including those past the image edge, as the kernel's do; with a seed
(K9) those start at best t 0 and the others at min(seed, far).
``binned_walk`` replays K4's walk over its bins, and ``resident_walk`` the
resident route's: K1's index order, and K3 and K4 on resident rows (the
ordered and binned walks with no row gate). ``dmxu_walk`` replays K11's
(``csrc/render_dmxu.cu``): either streamed walk, every slot of a visited
cluster tested (on raw rows the view's D, A, Q and t_num), each warp's two
pixel rows gated on the cluster's row span under ``rowskip``, the cluster's
first minimum merged with the lower-index tie rule; it counts the
(triangle, pixel) tests it makes.
"""

from __future__ import annotations

import torch

from . import raytrace_cuda as rc

_T = rc._TILE


def _inverse(d):
    tiny = rc._F_TINY
    return 1.0 / torch.where(d.abs() > tiny, d, torch.where(d < 0, -tiny, tiny))


def _slab(g, origin, inv):
    """Slab test of AABBs ``g`` (rows lo.xyz, hi.xyz as ``g[k]``) against
    rays from ``origin`` with inverse directions ``inv``: (tmin, tmax)."""
    t1 = [(g[k] - origin[k]) * inv[k] for k in range(3)]
    t2 = [(g[3 + k] - origin[k]) * inv[k] for k in range(3)]
    lo = [torch.minimum(a, b) for a, b in zip(t1, t2)]
    hi = [torch.maximum(a, b) for a, b in zip(t1, t2)]
    return (torch.maximum(torch.maximum(lo[0], lo[1]), lo[2]),
            torch.minimum(torch.minimum(hi[0], hi[1]), hi[2]))


def _view_chunks(V: int, per_view: int):
    """View ranges whose [views, blocks, cs, 256] tests hold about 2^26
    elements (the replays at full size stay within the card's memory)."""
    step = max(1, (1 << 26) // max(1, per_view))
    return [slice(v0, min(V, v0 + step)) for v0 in range(0, V, step)]


def _rows(x, sl, V):
    """``x`` (a tensor, a tuple of tensors or None) at views ``sl`` where it
    has a view axis."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_rows(y, sl, V) for y in x)
    return x[sl] if x.shape[0] == V else x


def _dmxu_tri(tri, cams):
    """K11's raw sweep: a gathered slab of raw rows ``[n, 10, cs]`` → the
    view's D, A, Q, t_num rows (``rc.batched_prepass`` with each view's
    camera origin, ``cams [n, cols]``), swept by the prep test."""
    return torch.stack(rc.batched_prepass(tri, cams), dim=1)


def _cluster_tests(rows_v, c, cs, cnt, dirs, t_lo, origin, shear=None, cams=None):
    """Tests of each view's cluster ``c`` [V] (its valid prefix ``cnt``)
    against the blocks' rays ``dirs`` [V, nt, 1, 256] (with ``shear``, the
    watertight decision; with ``cams``, K11's per-view rows of raw rows):
    (ok, t) as [V, nt, cs, 256]."""
    V = rows_v.shape[0]
    dev = rows_v.device
    ks = torch.arange(cs, device=dev)
    idx = (c[:, None] * cs + ks)[:, None, :].expand(V, rc._N_PREP_ROWS, cs)
    tri = rows_v[:, :rc._N_PREP_ROWS].gather(2, idx)  # [V, 10, cs]
    if cams is not None:
        tri, origin = _dmxu_tri(tri, cams), None
    ok, t, _, _ = rc.plain_triangle_test(*dirs, tri[:, :, None, :, None], t_lo, None,
                                         origin, shear)
    return ok & (ks[None, :] < cnt[:, None])[:, None, :, None], t


def _best_t0(far, seed, height: int, width: int, hp: int, wp: int, blocks):
    """Each thread's first best t, ``[V, nt, 256]``: far, or with a seed
    min(seed, far) inside the image and 0 past its edge."""
    V = far.shape[0]
    if seed is None:
        return far.expand(V, hp * wp // (_T * _T), _T * _T).clone()
    full = torch.zeros((V, hp, wp), dtype=far.dtype, device=far.device)
    full[:, :height, :width] = torch.minimum(seed.reshape(V, height, width), far)
    return blocks(full.reshape(V, -1))


def streamed_walk(rows, clusters, cams, order, spans, *, num_cams: int, n_lights: int,
                  height: int, width: int, seg_div: int, raster: bool = False,
                  geo: str = "prep", seed=None, **_):
    """Replay the streamed kernel's walk on ``pack_inputs``'s tensors
    (``seed``: K9's, or None). Returns a dict: ``depth`` f32 and ``segmask``
    i32 ``[W·C, H, Wd]`` as the raytrace export writes them for valid cameras
    (t and idx // seg_div on a hit, 0 and -1 on a miss), and the counts
    ``gated`` (positions a block evaluated past the early exit),
    ``slab_tests`` (those that passed the row gate), ``cluster_visits`` and
    ``triangle_visits`` (per block), ``clusters_streamed`` (distinct (world,
    cluster) pairs visited), ``winners`` (distinct (world, triangle) pairs
    some pixel hits), ``shadow_cluster_visits`` and
    ``shadow_triangle_visits`` (per block, all lights)."""
    return _walk(rows, clusters, cams, order, spans, num_cams=num_cams, n_lights=n_lights,
                 height=height, width=width, seg_div=seg_div, raster=raster, geo=geo,
                 seed=seed)


def resident_walk(rows, clusters, cams, order=None, bins=None, *, bin_tile=None,
                  num_cams: int, n_lights: int, height: int, width: int, seg_div: int,
                  raster: bool = False, geo: str = "prep", seed=None, **_):
    """Replay the resident route's walk on ``pack_inputs``'s tensors: with
    ``order`` K3 on resident rows (``streamed_walk``'s walk with no row
    gate), with ``bins`` K4 on resident rows (``binned_walk``'s with no row
    gate and no ranges), without either K1's index order (every cluster, no
    early exit, the slab test tmin < best_t, invalid clusters skipped);
    ``seed`` as in ``streamed_walk``. Returns what ``streamed_walk``
    returns (binned: ``binned_walk``'s); ``clusters_streamed`` then counts
    the (world, cluster) pairs some block swept."""
    kw = dict(num_cams=num_cams, n_lights=n_lights, height=height, width=width,
              seg_div=seg_div, raster=raster, geo=geo, seed=seed)
    if bins is not None:
        return binned_walk(rows, clusters, cams, bins, None, bin_tile=bin_tile, **kw)
    if order is None:
        V, CC = cams.shape[0], clusters.shape[2]
        order = torch.arange(CC, device=cams.device).expand(V, CC)
        return _walk(rows, clusters, cams, order, None, index=True, **kw)
    return _walk(rows, clusters, cams, order, None, **kw)


def dmxu_walk(rows, clusters, cams, order=None, spans=None, bins=None, *, bin_tile=None,
              num_cams: int, n_lights: int, height: int, width: int, seg_div: int,
              raster: bool = False, geo: str = "prep", seed=None, rowskip: bool = False,
              **_):
    """Replay K11's walk on ``pack_inputs(deferred_mxu=True)``'s tensors: with
    ``bins`` K4's walk (``binned_walk``'s gates, no ranges), else the ordered
    walk (``streamed_walk``'s gates); a visited cluster's every slot tested
    against every pixel of the block that its row gate keeps (``rowskip``:
    a warp's two rows against the cluster's span), the cluster's first
    minimum merged with the lower-index tie rule. On raw rows the tests take
    each view's D, A, Q and t_num, as the kernel forms them. Returns what
    ``streamed_walk`` (``binned_walk``) returns, ``triangle_visits`` every
    slot of each visit, and ``pixel_tests``: the (triangle, pixel) tests it
    makes."""
    kw = dict(num_cams=num_cams, n_lights=n_lights, height=height, width=width,
              seg_div=seg_div, raster=raster, geo=geo, seed=seed, dmxu=True,
              rowskip=rowskip)
    if bins is not None:
        return binned_walk(rows, clusters, cams, bins, spans, bin_tile=bin_tile, **kw)
    return _walk(rows, clusters, cams, order, spans, **kw)


def _warp_rows(row0):
    """The first image row of each thread's warp (two rows of the 16×16
    block a warp): ``[..., 256]`` from the blocks' first rows ``row0``."""
    tid = torch.arange(_T * _T, device=row0.device)
    return row0[..., None] + tid // (2 * _T) * 2


def _walk(rows, clusters, cams, order, spans, *, num_cams: int, n_lights: int,
          height: int, width: int, seg_div: int, raster: bool, geo: str, seed,
          index: bool = False, dmxu: bool = False, rowskip: bool = False):
    """The ordered walk along ``order`` (with ``spans`` the row gate; with
    ``index`` K1's sweep in index order; with ``dmxu`` K11's sweep) →
    ``streamed_walk``'s dict."""
    V = cams.shape[0]
    W, _, S = rows.shape
    CC = clusters.shape[2]
    cs = S // CC
    dev = cams.device
    hp, wp = -(-height // _T) * _T, -(-width // _T) * _T
    ty, tx = hp // _T, wp // _T
    nt = ty * tx
    world = torch.arange(V, device=dev) // num_cams
    rows_v = rows[world]
    cl = clusters[world]  # [V, 8, CC]

    def blocks(x):  # [V, hp·wp] → [V, nt, 256], block-major
        return x.reshape(V, ty, _T, tx, _T).permute(0, 1, 3, 2, 4).reshape(V, nt, _T * _T)

    d = tuple(blocks(x) for x in rc.plain_rays(cams, height, width, hp, wp))
    inv = tuple(_inverse(x) for x in d)

    def cam(k):  # [V, 1, 1]
        return cams[:, k, None, None]

    o = (cam(0), cam(1), cam(2))
    near, far = cam(14), cam(15)
    t_lo = near
    if raster:
        cosf = d[0] * cam(6) + d[1] * cam(7) + d[2] * cam(8)
        t_lo = near / torch.clamp_min(cosf, rc._F_COS_FLOOR)
    raw = geo != "prep"
    dirs = tuple(x[:, :, None] for x in d)  # [V, nt, 1, 256]
    shear = rc.wt.shear_select(*dirs) if geo in rc._WATERTIGHT_GEOS else None
    t_lo4 = t_lo[:, :, None] if raster else near[..., None]
    origin4 = tuple(x[..., None] for x in o) if raw else None
    pre_cams = cams if dmxu and raw else None  # K11's per-view rows
    best_t = _best_t0(far, seed, height, width, hp, wp, blocks)
    best_idx = torch.full_like(best_t, -1, dtype=torch.int64)
    done = torch.zeros((V, nt), dtype=torch.bool, device=dev)
    row0 = (torch.arange(nt, device=dev) // tx * _T)[None, :]
    wrow = _warp_rows(row0)  # [1, nt, 256]
    streamed = torch.zeros((W, CC), dtype=torch.int64, device=dev)  # visits per cluster
    ks = torch.arange(cs, device=dev)[None, None, :, None]
    n = dict(gated=0, slab_tests=0, cluster_visits=0, triangle_visits=0,
             shadow_cluster_visits=0, shadow_triangle_visits=0)
    # The walk's counts, summed on the tensors' device and read once at the
    # end: gated, slab tests, cluster visits, triangle visits, pixel tests.
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    for p in range(CC):
        active = ~done
        c = order[:, p].long()
        g = cl.gather(2, c[:, None, None].expand(V, 8, 1))[:, :, 0]  # [V, 8]
        gv = [g[:, k, None, None] for k in range(8)]
        valid = (g[:, 6] > 0)[:, None]
        if index:
            act = active
        else:
            a = [torch.clamp_min(torch.maximum(g[:, k] - cams[:, k], cams[:, k] - g[:, 3 + k]),
                                 0.0)
                 for k in range(3)]
            d2 = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]  # [V]
            live = (best_t * best_t > (d2 * rc._F_EXIT_SLACK)[:, None, None]).any(-1)
            done = done | (active & (~valid | ~live))
            act = active & ~done
        counts[0] += act.sum()
        if spans is not None:
            lo = spans[:, 0].gather(1, c[:, None])
            hi = spans[:, 1].gather(1, c[:, None])
            act = act & ~((lo > row0 + _T - 1) | (hi < row0))
        counts[1] += act.sum()
        tmin, tmax = _slab(gv, o, inv)
        reach = tmin if index else tmin * rc._F_SLAB_SLACK
        possible = (tmax >= tmin) & (tmax > near) & (reach < best_t)
        visit = act & possible.any(-1)  # [V, nt]
        if index:
            visit = visit & valid
        # One read a position: whether a block was still walking (else the
        # walk is over: this position changed nothing) and whether one visits.
        alive, any_visit = torch.stack([active.any(), visit.any()]).tolist()
        if not alive:
            break
        if not any_visit:
            continue
        cnt = torch.full_like(g[:, 7], cs).long() if dmxu else g[:, 7].long()
        counts[2] += visit.sum()
        counts[3] += (visit.sum(1) * cnt).sum()
        streamed.index_put_((world, c), visit.sum(1), accumulate=True)
        sweep = visit[:, :, None]  # [V, nt, 1 or 256]: the threads that sweep
        if rowskip:  # K11's row gate: a warp's two rows against the span
            sweep = sweep & ~((lo[:, :, None] > wrow + 1) | (hi[:, :, None] < wrow))
        if dmxu:
            counts[4] += sweep.expand(V, nt, _T * _T).sum() * cs
        m = torch.empty_like(best_t)
        first = torch.empty_like(best_idx)
        for sl in _view_chunks(V, nt * cs * _T * _T):
            ok, t = _cluster_tests(rows_v[sl], c[sl], cs, cnt[sl], _rows(dirs, sl, V),
                                   _rows(t_lo4, sl, V), _rows(origin4, sl, V),
                                   _rows(shear, sl, V), _rows(pre_cams, sl, V))
            t = torch.where(ok & sweep[sl, :, None, :], t, torch.inf)
            m[sl] = t.amin(2)
            first[sl] = torch.where(t == m[sl][:, :, None], ks, cs).amin(2)
        gi = c[:, None, None] * cs + first
        take = (m < best_t) | ((m == best_t) & (gi < best_idx))
        best_t = torch.where(take, m, best_t)
        best_idx = torch.where(take, gi, best_idx)

    gated, slab_tests, cluster_visits, triangle_visits, pixel_tests = counts.tolist()
    n.update(gated=gated, slab_tests=slab_tests, cluster_visits=cluster_visits,
             triangle_visits=triangle_visits)
    if dmxu:
        n["pixel_tests"] = pixel_tests
    if geo in rc._SHADOW_GEOS:
        _shadow_walk(cl, cams, world, d, o, best_t, best_idx, rows_v, cs, n_lights,
                     streamed, n)
    return _results(best_t, best_idx, world, S, seg_div, height, width, streamed, n)


def binned_walk(rows, clusters, cams, bins, spans, ranges=None, *, bin_tile: int,
                num_cams: int, n_lights: int, height: int, width: int, seg_div: int,
                raster: bool = False, geo: str = "prep", chunk: int = 4096, seed=None,
                dmxu: bool = False, rowskip: bool = False, **_):
    """Replay the binned kernel's walk (K4, ``csrc/render_binned.cu``) on
    ``pack_inputs``'s tensors (``seed`` as in ``streamed_walk``): each 16x16
    block walks the bin of the ``bin_tile`` square it lies in, front to
    back, with the ordered walk's early exit, row gate (8-row spans; none
    when ``spans`` is None, the resident route) and slab test; with
    ``ranges`` (prep rows) each of its two 8-row bands (rows 0-7 and 8-15 of
    the block) then sweeps the sorted lanes [lo, hi) of its image band where
    the cluster's span touches the band (a band below the image sweeps
    nothing and starts its best t at 0), taking exact ties by the original
    index in row 10; without, the whole valid prefix (``dmxu``: K11's
    sweep, as ``dmxu_walk`` says). Returns what ``streamed_walk`` returns, with
    ``triangle_visits`` counted per band on prep rows (``sweep_threads``:
    the threads that test each, 128 on prep rows, 256 on raw rows), and
    ``stops`` (blocks that stopped at the early exit), ``bin_entries`` (the
    bin entries some block reads: per (view, bin) the count and the
    positions its furthest block reached) and ``band_reads`` (the
    (visit, band) ranges read). Visiting blocks are swept ``chunk`` at a
    time."""
    V = cams.shape[0]
    W, _, S = rows.shape
    CC = clusters.shape[2]
    cs = S // CC
    dev = cams.device
    hp, wp = -(-height // _T) * _T, -(-width // _T) * _T
    ty, tx = hp // _T, wp // _T
    nt = ty * tx
    world = torch.arange(V, device=dev) // num_cams
    cl = clusters[world]  # [V, 8, CC]
    ranged = ranges is not None
    n_rows = rc._N_PREP_ROWS + (1 if ranged else 0)
    n_bands = -(-height // rc._BAND)

    def blocks(x):  # [V, hp·wp] → [V, nt, 256], block-major
        return x.reshape(V, ty, _T, tx, _T).permute(0, 1, 3, 2, 4).reshape(V, nt, _T * _T)

    d = tuple(blocks(x) for x in rc.plain_rays(cams, height, width, hp, wp))
    inv = tuple(_inverse(x) for x in d)

    def cam(k):  # [V, 1, 1]
        return cams[:, k, None, None]

    o = (cam(0), cam(1), cam(2))
    near, far = cam(14), cam(15)
    t_lo = near.expand(V, nt, _T * _T)
    if raster:
        cosf = d[0] * cam(6) + d[1] * cam(7) + d[2] * cam(8)
        t_lo = near / torch.clamp_min(cosf, rc._F_COS_FLOOR)
    raw = geo != "prep"
    wt = geo in rc._WATERTIGHT_GEOS
    best_t = _best_t0(far, seed, height, width, hp, wp, blocks)
    best_idx = torch.full_like(best_t, -1, dtype=torch.int64)
    blk = torch.arange(nt, device=dev)
    row0 = (blk // tx * _T)[None, :]
    thread_band = torch.arange(_T * _T, device=dev) // (_T * rc._BAND)  # 0 or 1
    gband = (blk // tx * 2)[:, None] + thread_band[None, :]  # [nt, 256]
    if ranged:
        best_t = torch.where(gband[None] < n_bands, best_t, 0.0)
    shift = bin_tile.bit_length() - _T.bit_length()
    bin_of = (blk // tx >> shift) * -(-width // bin_tile) + (blk % tx >> shift)
    blk_bins = bins[:, bin_of]  # [V, nt, 1 + CC]
    count = blk_bins[:, :, 0]
    done = torch.zeros((V, nt), dtype=torch.bool, device=dev)
    streamed = torch.zeros((W, CC), dtype=torch.int64, device=dev)
    lanes = torch.arange(cs, device=dev)
    geo_rows = torch.arange(n_rows, device=dev)
    n = dict(gated=0, slab_tests=0, cluster_visits=0, triangle_visits=0,
             shadow_cluster_visits=0, shadow_triangle_visits=0, stops=0, band_reads=0,
             sweep_threads=_T * rc._BAND if ranged else _T * _T)
    if dmxu:
        n["pixel_tests"] = 0
    # The counts that depend on the data add up on the device, read once
    # after the walk: a read a position would wait for the card each time.
    acc = {k: torch.zeros((), dtype=torch.int64, device=dev)
           for k in ("stops", "gated", "slab_tests", "cluster_visits", "triangle_visits",
                     "band_reads", "pixel_tests")}
    wrow = _warp_rows(row0[0])  # [nt, 256]
    reached = torch.zeros((V, nt), dtype=torch.int64, device=dev)
    for p in range(int(count.max()) if count.numel() else 0):
        active = ~done & (p < count)
        if not bool(active.any()):
            break
        reached = torch.where(active, p + 1, reached)
        c = blk_bins[:, :, 1 + p].long().clamp(0, CC - 1)  # [V, nt]
        g = cl.gather(2, c[:, None, :].expand(V, 8, nt))  # [V, 8, nt]
        a = [torch.clamp_min(torch.maximum(g[:, k] - cams[:, k, None],
                                           cams[:, k, None] - g[:, 3 + k]), 0.0)
             for k in range(3)]
        d2 = (a[0] * a[0] + a[1] * a[1]) + a[2] * a[2]  # [V, nt]
        live = (best_t * best_t > (d2 * rc._F_EXIT_SLACK)[..., None]).any(-1)
        done = done | (active & ~live)
        acc["stops"] += (active & ~live).sum()
        act = active & live
        acc["gated"] += act.sum()
        if spans is not None:
            s_lo, s_hi = spans[:, 0].gather(1, c), spans[:, 1].gather(1, c)
            act = act & ~((s_lo > row0 + _T - 1) | (s_hi < row0))
        acc["slab_tests"] += act.sum()
        gv = [g[:, k, :, None] for k in range(8)]
        tmin, tmax = _slab(gv, o, inv)
        possible = (tmax >= tmin) & (tmax > near) & (tmin * rc._F_SLAB_SLACK < best_t)
        visit = act & possible.any(-1)
        visiting = torch.nonzero(visit)
        if not len(visiting):
            continue
        n["cluster_visits"] += len(visiting)
        for vb in visiting.split(chunk):
            v, b = vb[:, 0], vb[:, 1]
            cv, wv = c[v, b], world[v]
            streamed.index_put_((wv, cv), torch.ones_like(cv), accumulate=True)
            lane_g = cv[:, None] * cs + lanes  # [m, cs]
            tri = rows[wv[:, None, None], geo_rows[None, :, None], lane_g[:, None, :]]
            dirs = tuple(x[v, b][:, None, :] for x in d)  # [m, 1, 256]
            if ranged:
                gb = gband[b]  # [m, 256]
                band_rows = gb * rc._BAND
                touch = (gb < n_bands) & (s_lo[v, b][:, None] <= band_rows + rc._BAND - 1) \
                    & (s_hi[v, b][:, None] >= band_rows)
                rg = ranges[wv[:, None], cv[:, None], gb.clamp_max(n_bands - 1)]  # [m, 256, 2]
                lo = torch.where(touch, rg[..., 0], 0)
                hi = torch.where(touch, rg[..., 1], 0)
                sweep = (lanes[None, :, None] >= lo[:, None, :]) & (lanes[None, :, None] < hi[:, None, :])
                per_band = (hi - lo)[:, :: _T * rc._BAND]  # [m, 2]: each band's lanes
                acc["triangle_visits"] += per_band.sum()
                acc["band_reads"] += touch[:, :: _T * rc._BAND].sum()
                gi = tri[:, rc._N_PREP_ROWS].long()  # [m, cs]
            elif dmxu:  # K11: every slot, on the threads its row gate keeps
                keep = torch.ones((len(v), _T * _T), dtype=torch.bool, device=dev)
                if rowskip:
                    wr = wrow[b]  # [m, 256]
                    keep = ~((s_lo[v, b][:, None] > wr + 1) | (s_hi[v, b][:, None] < wr))
                sweep = keep[:, None, :]
                n["triangle_visits"] += len(v) * cs
                acc["pixel_tests"] += keep.sum() * cs
                gi = lane_g
            else:
                cnt = cl[v, 7, cv].long()
                sweep = (lanes[None, :] < cnt[:, None])[:, :, None]
                acc["triangle_visits"] += cnt.sum()
                gi = lane_g
            origin = tuple(x[v] for x in o) if raw else None  # [m, 1, 1]
            if dmxu and raw:  # K11's per-view rows
                tri, origin = _dmxu_tri(tri[:, :rc._N_PREP_ROWS], cams[v]), None
            shear = rc.wt.shear_select(*dirs) if wt else None
            ok, t, _, _ = rc.plain_triangle_test(*dirs, tri[:, :rc._N_PREP_ROWS, :, None],
                                                 t_lo[v, b][:, None, :], None, origin, shear)
            t = torch.where(ok & sweep, t, torch.inf)  # [m, cs, 256]
            tm = t.amin(1)
            big = torch.iinfo(torch.int64).max
            at_min = t == tm[:, None]
            gi_m = torch.where(at_min, gi[:, :, None], big).amin(1)
            bt, bi = best_t[v, b], best_idx[v, b]
            take = (tm < bt) | ((tm == bt) & (gi_m < bi))
            best_t[v, b] = torch.where(take, tm, bt)
            best_idx[v, b] = torch.where(take, gi_m, bi)

    for k, v in acc.items():
        if k in n:
            n[k] += int(v)
    furthest = torch.zeros((V, bins.shape[1]), dtype=torch.int64, device=dev)
    furthest.scatter_reduce_(1, bin_of.expand(V, nt), reached, "amax")
    n["bin_entries"] = int((1 + furthest).sum())
    if geo in rc._SHADOW_GEOS:
        _shadow_walk(cl, cams, world, d, o, best_t, best_idx, rows[world], cs, n_lights,
                     streamed, n)
    return _results(best_t, best_idx, world, S, seg_div, height, width, streamed, n)


def _shadow_walk(cl, cams, world, d, o, best_t, best_idx, rows_v, cs, n_lights,
                 streamed, n):
    """Each light's any-hit walk over every cluster in index order (the
    streamed kernel's shadow walk on both visits), its work added to ``n``
    and ``streamed``."""
    V, CC = cl.shape[0], cl.shape[2]
    dev = cams.device

    def cam(k):  # [V, 1, 1]
        return cams[:, k, None, None]

    t_hit = torch.where(best_idx >= 0, best_t, 0.0)
    h = tuple(o[k] + t_hit * d[k] for k in range(3))
    eps = rc._F_SHADOW_EPS * (1.0 + t_hit)
    h4 = tuple(x[:, :, None] for x in h)
    all_c = torch.arange(CC, device=dev)
    for li in range(n_lights):
        c0 = rc._CAM_LIGHT0 + 6 * li
        sd = tuple(-cam(c0 + k) for k in range(3))
        inv_s = tuple(_inverse(x) for x in sd)
        occ = torch.zeros_like(best_t, dtype=torch.bool)
        for c in range(CC):
            g = [cl[:, k, c, None, None] for k in range(8)]
            tmin, tmax = _slab(g, h, inv_s)
            visit = ((tmax >= tmin) & (tmax > 0) & ~occ).any(-1) & (g[6][:, :, 0] > 0)
            if not bool(visit.any()):
                continue
            cnt = cl[:, 7, c].long()
            n["shadow_cluster_visits"] += int(visit.sum())
            n["shadow_triangle_visits"] += int((visit.sum(1) * cnt).sum())
            streamed.index_put_((world, all_c[c].expand(V)), visit.sum(1), accumulate=True)
            sd4, eps4 = tuple(x[..., None] for x in sd), eps[:, :, None]
            for sl in _view_chunks(V, occ.shape[1] * cs * occ.shape[2]):
                ok, _ = _cluster_tests(rows_v[sl], all_c[c].expand(V)[sl], cs, cnt[sl],
                                       _rows(sd4, sl, V), _rows(eps4, sl, V), _rows(h4, sl, V))
                occ[sl] = occ[sl] | (ok & visit[sl, :, None, None]).any(2)


def _results(best_t, best_idx, world, S, seg_div, height, width, streamed, n):
    """The walk's frames (``[V, nt, 256]`` block-major carries → ``[V,
    height, width]``) and its work."""
    V = best_t.shape[0]
    hp, wp = -(-height // _T) * _T, -(-width // _T) * _T
    ty, tx = hp // _T, wp // _T

    def image(x):  # [V, nt, 256] → [V, height, width]
        x = x.reshape(V, ty, tx, _T, _T).permute(0, 1, 3, 2, 4).reshape(V, hp, wp)
        return x[:, :height, :width]

    found = best_idx >= 0
    hits = (world[:, None, None] * S + best_idx)[found]
    depth = torch.where(found, best_t, 0.0)
    seg = torch.where(found, torch.div(best_idx, seg_div, rounding_mode="floor"), -1)
    return dict(depth=image(depth), segmask=image(seg).to(torch.int32),
                clusters_streamed=int((streamed > 0).sum()),
                winners=int(torch.unique(hits).numel()), **n)
