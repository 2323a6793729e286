"""Scene bake: merged import results → static device-resident tensors.

The analog of the reference's init-time asset processing:
``AssetProcessor::makeBVHData(objects)`` + ``initMaterialData(mats, texs)``
(reference ``src/mgr.cpp:472-475``) plus ``RenderManager::loadObjects``
(``src/mgr.cpp:352-354``). Geometry is static after init — only instance
transforms change per step (``scripts/test.py:144-150``) — so everything
here is baked once on the host into flat, padded, statically-shaped arrays
and moved to the device once.

The numpy body is the JAX package's ``core/scene.py`` bake term for term
(so both packages bake bitwise-identical scenes), mip chains included;
author-provided container chains arrive only with KTX2 (ROADMAP Queue 1
item 18) and raise.

  * Triangles are padded per object to a common ``T`` (multiple of 8);
    padding triangles are degenerate (zero area) **and** masked.
  * Triangle data is pre-differenced for Möller–Trumbore: ``v0, e1, e2``
    with matching UV/normal deltas so hit attributes are two
    multiply-adds from barycentrics.
  * Textures live in one flat RGBA8 texel pool (``u8 / 255`` as f32) with
    per-texture offset/width/height. A 1×1 white texture at index 0 and a
    default material row at index 0 let the shader treat every pixel
    uniformly (a missing texture is a multiply by 1).
  * With mip chains (``mipmaps``), each texture's box-filtered chain down
    to 1×1, laid out as ``[fallback region | fine levels]``: the region's
    ``fb_rows`` rows of 128 texels hold every texture's coarse chain (the
    levels from ``tex_fit_level`` on), the fine levels follow
    (``ops/mips.py`` has the sampling semantics).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import config as cfg_mod
from ..assets.importer import ImportedAssets


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class SceneData:
    """Static per-scene device tensors. ``O`` objects × ``T`` padded
    triangles. Field names, shapes and dtypes are the JAX package's."""

    # Triangle geometry (object space, pre-differenced)
    v0: torch.Tensor  # f32 [O, T, 3]
    e1: torch.Tensor  # f32 [O, T, 3]  (v1 - v0)
    e2: torch.Tensor  # f32 [O, T, 3]  (v2 - v0)
    # Hit attributes: value(u, v) = a0 + u * d1 + v * d2
    uv0: torch.Tensor  # f32 [O, T, 2]
    duv1: torch.Tensor  # f32 [O, T, 2]
    duv2: torch.Tensor  # f32 [O, T, 2]
    n0: torch.Tensor  # f32 [O, T, 3]
    dn1: torch.Tensor  # f32 [O, T, 3]
    dn2: torch.Tensor  # f32 [O, T, 3]
    tri_mat: torch.Tensor  # i32 [O, T]  (index into material table; 0 = default)
    tri_valid: torch.Tensor  # f32 [O, T] (1.0 real, 0.0 padding)
    # Material table (row 0 = default white material)
    mat_color: torch.Tensor  # f32 [M, 4]
    mat_tex: torch.Tensor  # i32 [M] (index into texture table; 0 = white)
    mat_rough: torch.Tensor  # f32 [M]
    mat_metal: torch.Tensor  # f32 [M]
    # Texture pool (entry 0 = 1x1 white)
    tex_data: torch.Tensor  # f32 [texels, 4] in [0, 1]
    tex_offset: torch.Tensor  # i32 [K]
    tex_width: torch.Tensor  # i32 [K]
    tex_height: torch.Tensor  # i32 [K]
    # Mip tables (L = 1: mips are off, the arrays repeat the base level)
    tex_mip_offset: torch.Tensor  # i32 [K, L]
    tex_mip_w: torch.Tensor  # i32 [K, L]
    tex_mip_h: torch.Tensor  # i32 [K, L]
    tex_fit_level: torch.Tensor  # i32 [K]
    # Lighting: L directional lights, contributions summed (the engine's
    # configureLighting takes a light list, src/mgr.cpp:356-359).
    light_dir: torch.Tensor  # f32 [L, 3] (direction each light travels)
    light_color: torch.Tensor  # f32 [L, 3]
    # Cluster acceleration (geometry/bvh.py): NC clusters per object of a
    # power-of-two size with object-space AABBs; all-padding clusters have
    # cl_valid = 0, and a cluster's valid triangles are a contiguous
    # prefix of cl_count slots.
    cl_min: torch.Tensor  # f32 [O, NC, 3]
    cl_max: torch.Tensor  # f32 [O, NC, 3]
    cl_valid: torch.Tensor  # f32 [O, NC]
    cl_count: torch.Tensor  # i32 [O, NC]
    # Rows of 128 texels in the pool's fallback region (mip chains; without
    # them unused and kept at the JAX default so the two bakes compare
    # field for field).
    fb_rows: int = 64

    @property
    def num_objects(self) -> int:
        return int(self.v0.shape[0])

    @property
    def tris_per_object(self) -> int:
        return int(self.v0.shape[1])

    @property
    def device(self) -> torch.device:
        return self.v0.device


# Default lighting: the reference hardcodes one directional light
# {direction (1, -1, -0.05), color (1, 1, 1)} (src/mgr.cpp:356-359).
DEFAULT_LIGHT_DIR = (1.0, -1.0, -0.05)
DEFAULT_LIGHT_COLOR = (1.0, 1.0, 1.0)

CLUSTER_SIZE = 64
# Resident budget for one world's triangle block, in bytes of the JAX
# kernel's 32-row layout; beyond it the JAX kernel streams clusters from
# device memory (ROADMAP Queue 1 item 8), and the bake pads objects to
# 128-triangle multiples with 32-triangle clusters.
SMEM_TRI_BUDGET = 384 * 1024
_TRI_ROWS = 32
_DMA_CLUSTER = 32
# The JAX bake's fallback-region rows when mips are off.
TEX_FB_ROWS = 64
# Rows of 128 texels in one tile's window over the fine levels: part of the
# mip semantics, since it decides which pixels fall back to the coarse
# chain (ops/mips.py).
TEX_PAGE_ROWS = 128
# Texel-pool rows of 128 texels the render kernel samples resident; past it
# mipmaps="auto" turns mip chains on (the JAX bake's paged-texture switch).
TEX_RESIDENT_ROWS = 128


def _mip_next(img: np.ndarray) -> np.ndarray:
    """One box-filtered mip step on u8 RGBA (odd dims edge-repeat,
    round-half-up) — the mip definition both render paths share."""
    h, w = img.shape[:2]
    if h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
    if w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    a = img[0::2, 0::2].astype(np.uint16)
    b = img[1::2, 0::2].astype(np.uint16)
    c = img[0::2, 1::2].astype(np.uint16)
    d = img[1::2, 1::2].astype(np.uint16)
    return ((a + b + c + d + 2) // 4).astype(np.uint8)


def _fits_for(chains, budget_texels):
    """Coarse-chain start per texture: the smallest level whose dims fit
    ``fit_max``, shrinking ``fit_max`` until every coarse chain fits the
    fallback-region budget together → (fit_max, fits), or (None, None)."""
    for fit_max in (32, 16, 8, 4, 2, 1):
        fits = [
            next(i for i, m in enumerate(c) if max(m.shape[0], m.shape[1]) <= fit_max)
            for c in chains
        ]
        coarse = sum(
            sum(m.shape[0] * m.shape[1] for m in c[f:]) for c, f in zip(chains, fits)
        )
        if coarse <= budget_texels:
            return fit_max, fits
    return None, None


def _mip_pool(textures):
    """The mip-mapped texel pool (the JAX bake's mip branch): chains down
    to 1×1; the fallback region sized to the fewest rows (16, 32, 64 or
    128) that admit the fit the largest admits; the region first, padded
    to ``fb_rows · 128`` texels, then the fine levels, base first; entries
    past a chain repeat its 1×1 top. Returns (u8 pool [texels, 4],
    tex_mip_offset, tex_mip_w, tex_mip_h, tex_fit_level, fb_rows)."""
    chains = []
    for tex in textures:
        chain = [tex]
        while chain[-1].shape[0] > 1 or chain[-1].shape[1] > 1:
            chain.append(_mip_next(chain[-1]))
        chains.append(chain)
    n_levels = max(len(c) for c in chains)
    fit_ref, fits = _fits_for(chains, 128 * 128)
    if fits is None:
        raise ValueError(
            "too many textures for the 128-row fallback region (even 1×1 "
            "chains overflow)"
        )
    fb_rows = 128
    for cand in (16, 32, 64):
        fm, f2 = _fits_for(chains, cand * 128)
        if fm == fit_ref:
            fb_rows, fits = cand, f2
            break
    k = len(textures)
    tex_mip_offset = np.zeros((k, n_levels), np.int32)
    tex_mip_w = np.zeros((k, n_levels), np.int32)
    tex_mip_h = np.zeros((k, n_levels), np.int32)
    pool = []
    off = 0

    def push(ci, level, m):
        nonlocal off
        tex_mip_offset[ci, level] = off
        tex_mip_w[ci, level] = m.shape[1]
        tex_mip_h[ci, level] = m.shape[0]
        pool.append(m.reshape(-1, 4))
        off += m.shape[0] * m.shape[1]

    for ci, (c, f) in enumerate(zip(chains, fits)):
        for level in range(f, len(c)):
            push(ci, level, c[level])
    if off < fb_rows * 128:
        pool.append(np.zeros((fb_rows * 128 - off, 4), np.uint8))
        off = fb_rows * 128
    for ci, (c, f) in enumerate(zip(chains, fits)):
        for level in range(f):
            push(ci, level, c[level])
        for level in range(len(c), n_levels):
            tex_mip_offset[ci, level] = tex_mip_offset[ci, len(c) - 1]
            tex_mip_w[ci, level] = 1
            tex_mip_h[ci, level] = 1
    if off > (1 << 24):
        # Offsets travel as f32 in the kernel's mip table (exact below 2^24).
        raise ValueError(
            f"texture pool ({off} texels incl. mip chains) exceeds the "
            "sampler's 2^24-texel offset range; split textures across scenes "
            "or downsample"
        )
    return (np.concatenate(pool, axis=0), tex_mip_offset, tex_mip_w, tex_mip_h,
            np.asarray(fits, np.int32), fb_rows)


def bake_scene(
    assets: ImportedAssets,
    device: "torch.device | str",
    tri_pad_multiple: int = 8,
    cluster_size: int = CLUSTER_SIZE,
    mipmaps="auto",
) -> SceneData:
    """Bake merged imports into SceneData (numpy work, one transfer).

    Triangles of each object are Morton-sorted and clustered (see
    geometry/bvh.py) so the culled intersector can skip whole clusters.

    ``mipmaps``: True / False / "auto" (on iff the texel pool exceeds
    ``TEX_RESIDENT_ROWS`` rows of 128 texels, as in the JAX bake).
    """
    objects = assets.objects
    num_objects = max(1, len(objects))

    # --- Material table (row 0 = default) ---
    mats = [cfg_mod.AdditionalMaterial(color=(1, 1, 1, 1), texture_id=-1)]
    mats += list(assets.materials)
    m = len(mats)
    mat_color = np.zeros((m, 4), np.float32)
    mat_tex = np.zeros((m,), np.int32)
    mat_rough = np.zeros((m,), np.float32)
    mat_metal = np.zeros((m,), np.float32)
    for i, mat in enumerate(mats):
        if int(mat.texture_id) >= len(assets.textures):
            # An out-of-range id would index past the texture tables on the
            # device.
            raise ValueError(
                f"material {i - 1} names texture {mat.texture_id}, but "
                f"{len(assets.textures)} textures were given"
            )
        mat_color[i] = np.asarray(mat.color, np.float32)
        # texture_id -1 → white texture slot 0; else shift past it.
        mat_tex[i] = 0 if mat.texture_id == -1 else int(mat.texture_id) + 1
        mat_rough[i] = mat.roughness
        mat_metal[i] = mat.metalness

    # --- Texture pool (entry 0 = 1x1 white) ---
    if any(hasattr(t, "levels") for t in assets.textures):
        raise NotImplementedError(
            "container mip chains (KTX2) are not ported yet — ROADMAP Queue 1 "
            "item 18"
        )
    textures = [np.full((1, 1, 4), 255, np.uint8)]
    textures += [np.asarray(t, np.uint8) for t in assets.textures]
    k = len(textures)
    tex_offset = np.zeros((k,), np.int32)
    tex_width = np.zeros((k,), np.int32)
    tex_height = np.zeros((k,), np.int32)
    for i, tex in enumerate(textures):
        tex_width[i] = tex.shape[1]
        tex_height[i] = tex.shape[0]
    base_texels = int(sum(t.shape[0] * t.shape[1] for t in textures))
    if mipmaps == "auto":
        mipmaps = -(-base_texels // 128) > TEX_RESIDENT_ROWS
    if mipmaps:
        (pool, tex_mip_offset, tex_mip_w, tex_mip_h, tex_fit_level,
         fb_rows) = _mip_pool(textures)
        tex_offset = tex_mip_offset[:, 0].copy()
        tex_data = pool.astype(np.float32) / 255.0
    else:
        fb_rows = TEX_FB_ROWS
        pool = []
        off = 0
        for i, tex in enumerate(textures):
            h, w = tex.shape[0], tex.shape[1]
            tex_offset[i] = off
            pool.append(tex.reshape(-1, 4))
            off += h * w
        tex_data = np.concatenate(pool, axis=0).astype(np.float32) / 255.0
        tex_mip_offset = tex_offset[:, None].copy()
        tex_mip_w = tex_width[:, None].copy()
        tex_mip_h = tex_height[:, None].copy()
        tex_fit_level = np.zeros((k,), np.int32)

    # --- Triangles, padded per object ---
    def object_tri_count(obj) -> int:
        return sum(mesh.num_faces for mesh in obj.meshes)

    t_max = max([object_tri_count(o) for o in objects], default=1)
    t_pad = _round_up(max(t_max, 1), tri_pad_multiple)
    streamed = _TRI_ROWS * t_pad * 4 > SMEM_TRI_BUDGET
    if streamed:
        t_pad = _round_up(t_pad, 128)

    v0 = np.zeros((num_objects, t_pad, 3), np.float32)
    e1 = np.zeros((num_objects, t_pad, 3), np.float32)
    e2 = np.zeros((num_objects, t_pad, 3), np.float32)
    uv0 = np.zeros((num_objects, t_pad, 2), np.float32)
    duv1 = np.zeros((num_objects, t_pad, 2), np.float32)
    duv2 = np.zeros((num_objects, t_pad, 2), np.float32)
    n0 = np.zeros((num_objects, t_pad, 3), np.float32)
    dn1 = np.zeros((num_objects, t_pad, 3), np.float32)
    dn2 = np.zeros((num_objects, t_pad, 3), np.float32)
    tri_mat = np.zeros((num_objects, t_pad), np.int32)
    tri_valid = np.zeros((num_objects, t_pad), np.float32)

    for oi, obj in enumerate(objects):
        t = 0
        for mesh in obj.meshes:
            f = mesh.num_faces
            if f == 0:
                continue
            idx = mesh.indices.reshape(-1, 3).astype(np.int64)
            p = mesh.positions.astype(np.float32)
            a, b, c = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
            v0[oi, t : t + f] = a
            e1[oi, t : t + f] = b - a
            e2[oi, t : t + f] = c - a
            if mesh.uvs is not None:
                uv = mesh.uvs.astype(np.float32)
                ua, ub, uc = uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]
                uv0[oi, t : t + f] = ua
                duv1[oi, t : t + f] = ub - ua
                duv2[oi, t : t + f] = uc - ua
            if mesh.normals is not None:
                nr = mesh.normals.astype(np.float32)
                na, nb, nc = nr[idx[:, 0]], nr[idx[:, 1]], nr[idx[:, 2]]
                n0[oi, t : t + f] = na
                dn1[oi, t : t + f] = nb - na
                dn2[oi, t : t + f] = nc - na
            else:
                # Geometric (flat) normal; zero deltas.
                gn = np.cross(b - a, c - a)
                norm = np.linalg.norm(gn, axis=-1, keepdims=True)
                gn = gn / np.maximum(norm, 1e-20)
                n0[oi, t : t + f] = gn
            # material_idx -1 → default row 0; else shift past it.
            mi = mesh.material_idx
            tri_mat[oi, t : t + f] = 0 if mi < 0 else mi + 1
            tri_valid[oi, t : t + f] = 1.0
            t += f

    # Morton-reorder each object's triangles and bake cluster AABBs. The
    # effective cluster size must divide t_pad so a global cluster index c
    # maps to triangle base c*cl_eff across instance-concatenated soups.
    from ..geometry.bvh import build_clusters

    if streamed:
        cluster_size = _DMA_CLUSTER
    else:
        # Largest power-of-two divisor of t_pad, capped at cluster_size.
        cl_eff = 8
        while (
            cl_eff * 2 <= min(cluster_size, t_pad) and t_pad % (cl_eff * 2) == 0
        ):
            cl_eff *= 2
        cluster_size = cl_eff
    n_clusters = t_pad // cluster_size
    cl_min = np.zeros((num_objects, n_clusters, 3), np.float32)
    cl_max = np.full((num_objects, n_clusters, 3), -1.0, np.float32)
    cl_valid = np.zeros((num_objects, n_clusters), np.float32)
    cl_count = np.zeros((num_objects, n_clusters), np.int32)
    per_tri = [v0, e1, e2, uv0, duv1, duv2, n0, dn1, dn2, tri_mat, tri_valid]
    for oi in range(num_objects):
        bvh = build_clusters(
            v0[oi], e1[oi], e2[oi], tri_valid[oi] > 0, cluster_size=cluster_size
        )
        for arr in per_tri:
            arr[oi] = arr[oi][bvh.order]
        nc = bvh.cluster_min.shape[0]
        cl_min[oi, :nc] = np.where(
            np.isfinite(bvh.cluster_min), bvh.cluster_min, 0.0
        )
        cl_max[oi, :nc] = np.where(
            np.isfinite(bvh.cluster_max), bvh.cluster_max, -1.0
        )
        cl_valid[oi, :nc] = bvh.cluster_valid
        n_valid = int((tri_valid[oi] > 0).sum())
        for c in range(n_clusters):
            cl_count[oi, c] = int(
                np.clip(n_valid - c * cluster_size, 0, cluster_size)
            )

    arrays = dict(
        v0=v0, e1=e1, e2=e2,
        uv0=uv0, duv1=duv1, duv2=duv2,
        n0=n0, dn1=dn1, dn2=dn2,
        tri_mat=tri_mat, tri_valid=tri_valid,
        cl_min=cl_min, cl_max=cl_max, cl_valid=cl_valid, cl_count=cl_count,
        mat_color=mat_color, mat_tex=mat_tex,
        mat_rough=mat_rough, mat_metal=mat_metal,
        tex_data=tex_data,
        tex_offset=tex_offset, tex_width=tex_width, tex_height=tex_height,
        tex_mip_offset=tex_mip_offset, tex_mip_w=tex_mip_w,
        tex_mip_h=tex_mip_h, tex_fit_level=tex_fit_level,
        light_dir=np.asarray([DEFAULT_LIGHT_DIR], np.float32),
        light_color=np.asarray([DEFAULT_LIGHT_COLOR], np.float32),
    )
    return SceneData(
        **{k: torch.from_numpy(v).to(device) for k, v in arrays.items()},
        fb_rows=fb_rows,
    )


def configure_lighting(scene: SceneData, direction=None, color=None, *, lights=None) -> SceneData:
    """Replace the directional light(s) — the analog of the engine's
    ``configureLighting`` (reference ``src/mgr.cpp:356-359``), which takes
    a list of ``{active, direction, color}`` descriptors.

    Either ``configure_lighting(scene, direction, color)`` (one light,
    the reference app's usage) or
    ``configure_lighting(scene, lights=[(dir, color), ...])``. Pure
    update: returns a new SceneData."""
    if lights is None:
        lights = [(direction, color)]
    dev = scene.device
    dirs = torch.tensor(
        np.asarray([d for d, _ in lights], np.float32).reshape(-1, 3), device=dev
    )
    cols = torch.tensor(
        np.asarray([c for _, c in lights], np.float32).reshape(-1, 3), device=dev
    )
    return dataclasses.replace(scene, light_dir=dirs, light_color=cols)
