"""Shading constants, texture sampling and the packed-pixel view.

One or more directional lambert lights plus a constant ambient term,
matching the lighting model the reference configures (``configureLighting``
usage, reference ``src/mgr.cpp:356-359``). The shading itself runs inside
the render kernel (``ops/raytrace_cuda.py``), but for the 9-output route's
planar epilogue (``shade_lambert_planar``); this module keeps what both
sides share:

  * ``AMBIENT = 0.2`` constant ambient.
  * Textures: repeat wrap, OBJ UV convention (v = 0 at the bottom of the
    image), nearest or bilinear filtering — the JAX package's
    ``ops/shade.py`` sampling expressions, here on the kernel's inputs
    (the material table and the packed texel pool) so that the render
    kernel's plain version samples exactly as the kernel does. Scenes
    baked with mip chains sample through ``ops/mips.py`` on the mip table
    (``mip_table``), and take trilinear filtering too.
  * Misses produce RGBA (0, 0, 0, 255), depth 0.0, segmask -1.
"""

from __future__ import annotations

import numpy as np
import torch

AMBIENT = 0.2
# The in-kernel texture route's budget (the JAX package's
# _TEX_INKERNEL_MAX_ROWS rows of 128 texels, and one lane per material).
TEX_MAX_TEXELS = 128 * 128
TEX_MAX_MATERIALS = 128
FILTERS = ("nearest", "bilinear")
MIP_FILTERS = FILTERS + ("trilinear",)


def material_table(scene) -> torch.Tensor:
    """``[6, M]`` f32: each material's colour rgb and its texture's texel
    offset, width and height (exact in f32 below 2^24) — the rows of the JAX
    kernel's ``mp`` table (``raytrace_pallas.py:4166-4172``)."""
    mt = scene.mat_tex.long()
    f32 = torch.float32
    return torch.stack([
        scene.mat_color[:, 0], scene.mat_color[:, 1], scene.mat_color[:, 2],
        scene.tex_offset[mt].to(f32), scene.tex_width[mt].to(f32),
        scene.tex_height[mt].to(f32),
    ]).contiguous()


def mip_table(scene) -> torch.Tensor:
    """``[4 + 3L, M]`` f32 for a scene with ``L`` mip levels: each
    material's colour rgb, its texture's coarse fallback level, then the
    offset, width and height of each level (exact in f32 below 2^24) — the
    rows of the JAX kernel's paged param table
    (``raytrace_pallas.py:4210-4224``) without its k/255 lookup rows, since
    ``dequant`` is an IEEE divide."""
    mt = scene.mat_tex.long()
    f32 = torch.float32
    rows = [scene.mat_color[:, 0], scene.mat_color[:, 1], scene.mat_color[:, 2],
            scene.tex_fit_level[mt].to(f32)]
    for level in range(int(scene.tex_mip_offset.shape[1])):
        rows += [scene.tex_mip_offset[mt, level].to(f32),
                 scene.tex_mip_w[mt, level].to(f32),
                 scene.tex_mip_h[mt, level].to(f32)]
    return torch.stack(rows).contiguous()


def texel_pool(scene) -> torch.Tensor:
    """i32 ``[texels]``: ``r | g << 8 | b << 16`` of each texel (with mip
    chains the whole pool, fallback region and fine levels). The bake's
    texels are ``u8 / 255``, so the u8 round trip is exact
    (``raytrace_pallas.py:4185-4186``)."""
    q = (scene.tex_data * 255.0 + 0.5).to(torch.int32)
    return (q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)).contiguous()


def dequant(k: torch.Tensor) -> torch.Tensor:
    """u8 values (i32) → f32 ``k / 255``, an IEEE divide: bitwise the bake's
    ``np.float32(k) / 255``. The divisor is a tensor on purpose: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    misrounds 126 of the 256 values."""
    return k.to(torch.float32) / torch.full((), 255.0, device=k.device)


def _wrap(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Repeat wrap of an index in [-1, n] (``raytrace_pallas.py:3140-3144``)."""
    i = torch.where(i < 0, i + n, i)
    return torch.where(i >= n, i - n, i)


def sample_texture(mats: torch.Tensor, pool: torch.Tensor, mat: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor, texture_filter: str):
    """Material colour times the texel at ``(u, v)`` → ``(r, g, b)`` f32,
    each shaped like ``mat`` (f32 material ids). Repeat wrap, v flipped;
    nearest clamps to the last texel, bilinear puts texel centres at
    half-integers (``shade.py`` ``sample_texture_nearest`` /
    ``sample_texture_bilinear``, as the JAX kernel computes them at
    ``raytrace_pallas.py:3060-3167``)."""
    m = mat.long()

    def row(k):
        return mats[k][m]

    base = [row(0), row(1), row(2)]
    wf, hf = row(4), row(5)
    w_i = wf.to(torch.int32)
    h_i = hf.to(torch.int32)
    off_i = row(3).to(torch.int32)
    uu = u - torch.floor(u)  # repeat wrap
    vv = v - torch.floor(v)

    def fetch(y, x):
        return pool[(off_i + y * w_i + x).long()]

    if texture_filter == "nearest":
        # astype(int32) truncates toward zero; uu, 1 - vv lie in [0, 1].
        tx = torch.minimum(torch.clamp_min((uu * wf).to(torch.int32), 0), w_i - 1)
        ty = torch.minimum(torch.clamp_min(((1.0 - vv) * hf).to(torch.int32), 0),
                           h_i - 1)
        texel = fetch(ty, tx)
        return tuple(base[c] * dequant((texel >> (8 * c)) & 255) for c in range(3))
    if texture_filter != "bilinear":
        raise ValueError(f"texture_filter must be one of {FILTERS}, got {texture_filter!r}")
    fx = uu * wf - 0.5
    fy = (1.0 - vv) * hf - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    ax = fx - x0f
    ay = fy - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    xa, xb = _wrap(x0, w_i), _wrap(x0 + 1, w_i)
    ya, yb = _wrap(y0, h_i), _wrap(y0 + 1, h_i)
    t00, t10 = fetch(ya, xa), fetch(ya, xb)
    t01, t11 = fetch(yb, xa), fetch(yb, xb)
    out = []
    for c in range(3):
        sh = 8 * c
        c00 = dequant((t00 >> sh) & 255)
        c10 = dequant((t10 >> sh) & 255)
        c01 = dequant((t01 >> sh) & 255)
        c11 = dequant((t11 >> sh) & 255)
        top = c00 * (1.0 - ax) + c10 * ax
        bot = c01 * (1.0 - ax) + c11 * ax
        out.append(base[c] * (top * (1.0 - ay) + bot * ay))
    return tuple(out)


def shade_lambert_planar(scene, mat_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         nx: torch.Tensor, ny: torch.Tensor, nz: torch.Tensor,
                         hit_mask: torch.Tensor, texture_filter: str = "nearest",
                         lit=None) -> torch.Tensor:
    """The 9-output route's shading epilogue (the JAX ``shade.py``
    ``shade_lambert_planar``, :77-172) → packed RGBA i32 shaped like
    ``mat_id``: the normals (pre-flipped) over their norm, per light the
    clamped lambert term over the light's norm, times its visibility
    ``lit [..., L]`` when given; the material's colour (and on a textured
    pool its texture sampled at (u, v), nearest or bilinear, from the
    scene's f32 texels: repeat wrap, v flipped, bilinear texel centres at
    half-integers and a floored modulo); ambient 0.2 plus the lights, black
    off ``hit_mask``. The JAX one-hot matmuls of the material table are
    gathers here (a one-hot row times finite values is the value). Its
    reciprocal square roots are correctly rounded (taken in f64)."""
    f32 = torch.float32

    def rsqrt(x):
        return (1.0 / torch.sqrt(x.double())).to(f32)

    tiny = float(np.float32(1e-20))
    inv_len = rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, tiny))
    n_lights = int(scene.light_dir.shape[0])
    ndotls = []
    for li in range(n_lights):
        lx, ly, lz = scene.light_dir[li, 0], scene.light_dir[li, 1], scene.light_dir[li, 2]
        l_inv = rsqrt(torch.clamp_min(lx * lx + ly * ly + lz * lz, tiny))
        nd = -(nx * lx + ny * ly + nz * lz) * (inv_len * l_inv)
        nd = torch.clamp_min(nd, 0.0)
        if lit is not None:
            nd = nd * lit[..., li]
        ndotls.append(nd)
    m = mat_id.long()
    base = [scene.mat_color[:, c][m] for c in range(3)]
    if int(scene.tex_data.shape[0]) > 1:
        tex_id = scene.mat_tex.long()[m]
        w = scene.tex_width[tex_id]
        h = scene.tex_height[tex_id]
        off = scene.tex_offset[tex_id]
        uu = u - torch.floor(u)
        vv = v - torch.floor(v)
        if texture_filter == "bilinear":
            wf, hf = w.to(f32), h.to(f32)
            fx = uu * wf - 0.5
            fy = (1.0 - vv) * hf - 0.5
            x0f = torch.floor(fx)
            y0f = torch.floor(fy)
            ax = fx - x0f
            ay = fy - y0f

            def texel_ch(xi, yi, ch):  # jnp.mod: a floored modulo
                xm = torch.remainder(xi.to(torch.int32), w)
                ym = torch.remainder(yi.to(torch.int32), h)
                return scene.tex_data[:, ch][(off + ym * w + xm).long()]

            def lerp_ch(ch):
                t00 = texel_ch(x0f, y0f, ch)
                t10 = texel_ch(x0f + 1, y0f, ch)
                t01 = texel_ch(x0f, y0f + 1, ch)
                t11 = texel_ch(x0f + 1, y0f + 1, ch)
                top = t00 * (1 - ax) + t10 * ax
                bot = t01 * (1 - ax) + t11 * ax
                return top * (1 - ay) + bot * ay

            base = [base[c] * lerp_ch(c) for c in range(3)]
        else:
            # astype(int32) truncates toward zero.
            x = torch.minimum(torch.clamp_min((uu * w.to(f32)).to(torch.int32), 0), w - 1)
            y = torch.minimum(torch.clamp_min(((1.0 - vv) * h.to(f32)).to(torch.int32), 0),
                              h - 1)
            flat = (off + y * w + x).long()
            base = [base[c] * scene.tex_data[:, c][flat] for c in range(3)]
    ambient = float(np.float32(AMBIENT))
    diffuse = float(np.float32(1.0 - AMBIENT))
    packed = torch.full_like(mat_id, int(np.uint32(0xFF000000).view(np.int32)),
                             dtype=torch.int32)
    for c in range(3):
        s = torch.zeros((), dtype=f32, device=nx.device)
        for li in range(n_lights):
            s = s + ndotls[li] * scene.light_color[li, c]
        col = torch.clamp(base[c] * (ambient + diffuse * s), 0.0, 1.0)
        col = torch.where(hit_mask, col, 0.0)
        packed = packed | ((col * 255.0 + 0.5).to(torch.int32) << (8 * c))
    return packed


def packed_to_rgba8(packed: torch.Tensor) -> torch.Tensor:
    """Packed 32-bit pixels ``[...]`` (i32 or u32) → u8 ``[..., 4]``, a view
    in little-endian byte order, i.e. RGBA."""
    if not packed.is_contiguous():
        packed = packed.contiguous()
    return packed.view(torch.uint8).reshape(*packed.shape, 4)
