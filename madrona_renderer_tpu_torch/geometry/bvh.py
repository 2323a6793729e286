"""Acceleration-structure bake for large meshes (host-side, numpy).

The analog of the reference's ``AssetProcessor::makeBVHData`` (device BVH
bake at init — reference ``src/mgr.cpp:472``): **Morton-ordered triangle
clusters with AABBs** — flat, fixed-size, branch-free to cull (the same
bake as the JAX package, so both render identical clusters):

  * triangles are sorted along a Morton curve of their centroids (spatial
    locality → tight cluster bounds),
  * grouped into fixed-size clusters (default 64) with an AABB each,
  * the intersector tests one cluster AABB per *pixel tile* (rays in a
    16×16 block are image-coherent) and skips the whole cluster's
    triangles when no ray of the block can hit — a two-level hierarchy
    whose "traversal" is a dense sweep, not a stack.

Static geometry bakes once; only instance transforms change per step, so
world-space cluster bounds are refit per step by transforming 8 AABB
corners (the TLAS-refit analog).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits over 30 (classic Morton helper)."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: np.ndarray) -> np.ndarray:
    """[N, 3] points → uint64 Morton codes (10 bits/axis)."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip(((pts - lo) / extent * 1023.0), 0, 1023).astype(np.uint64)
    return (
        (_expand_bits(q[:, 0]) << 2)
        | (_expand_bits(q[:, 1]) << 1)
        | _expand_bits(q[:, 2])
    )


@dataclass
class ClusterBVH:
    """Flat cluster structure for one object."""

    order: np.ndarray  # i32 [T] — triangle permutation (Morton)
    cluster_min: np.ndarray  # f32 [n_clusters, 3]
    cluster_max: np.ndarray  # f32 [n_clusters, 3]
    cluster_valid: np.ndarray  # f32 [n_clusters] (0 for all-padding clusters)
    cluster_size: int


def build_clusters(
    v0: np.ndarray,  # f32 [T, 3]
    e1: np.ndarray,
    e2: np.ndarray,
    valid: np.ndarray,  # [T] (bool/float)
    cluster_size: int = 64,
) -> ClusterBVH:
    """Morton-sort valid triangles, group into fixed clusters, AABB each.

    Padding (invalid) triangles sort to the end; clusters containing only
    padding get cluster_valid=0 and an empty AABB.
    """
    T = v0.shape[0]
    valid = np.asarray(valid).astype(bool)
    centroids = v0 + (e1 + e2) / 3.0

    order = np.arange(T, dtype=np.int64)
    if valid.any():
        codes = np.where(valid, morton_codes(centroids), np.uint64(0xFFFFFFFFFFFFFFFF))
        order = np.argsort(codes, kind="stable")
    order = order.astype(np.int32)

    n_clusters = max(1, -(-T // cluster_size))
    cmin = np.full((n_clusters, 3), np.inf, np.float32)
    cmax = np.full((n_clusters, 3), -np.inf, np.float32)
    cvalid = np.zeros((n_clusters,), np.float32)

    sv0, se1, se2 = v0[order], e1[order], e2[order]
    sval = valid[order]
    verts = np.stack([sv0, sv0 + se1, sv0 + se2], axis=1)  # [T, 3verts, 3]
    for c in range(n_clusters):
        sl = slice(c * cluster_size, min((c + 1) * cluster_size, T))
        mask = sval[sl]
        if not mask.any():
            continue
        vs = verts[sl][mask].reshape(-1, 3)
        cmin[c] = vs.min(axis=0)
        cmax[c] = vs.max(axis=0)
        cvalid[c] = 1.0

    return ClusterBVH(
        order=order,
        cluster_min=cmin,
        cluster_max=cmax,
        cluster_valid=cvalid,
        cluster_size=cluster_size,
    )


def aabb_corners(cmin: np.ndarray, cmax: np.ndarray) -> np.ndarray:
    """[..., 3] min/max → [..., 8, 3] corners (for world-space refit)."""
    cmin = np.asarray(cmin)
    cmax = np.asarray(cmax)
    picks = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32
    )  # [8, 3]
    return cmin[..., None, :] * (1 - picks) + cmax[..., None, :] * picks
