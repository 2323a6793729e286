// K7's texel path, shared by csrc/shade_mip.cu (the second launch of the
// two-launch design) and csrc/render_resident.cu (the texel pieces of every
// render variant, and the mip sample folded into K1's index visit, whose
// entry csrc/render_mip.cu builds): the mip level, the taps and their row
// span, the window keys and base of a TPU tile, the clamp, the sample and
// the packed colour. Each expression is the one of
// madrona_renderer_tpu/ops/raytrace_pallas.py's paged-texture shading
// (:3203-3663) that ops/mips.py computes in torch ops; with --fmad=false and
// IEEE divide the kernels and the plain version agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMipLane = 128;      // texels a pool row; pixels a TPU tile row
constexpr int kMipPageRows = 128;  // TEX_PAGE_ROWS: rows of one window
constexpr int kMipBig = 1 << 30;   // an empty window key
constexpr int kMipNearest = 0;     // the filters, ops/raytrace_cuda.py's
constexpr int kMipBilinear = 1;    // _MIP_FILTER_CODES
constexpr int kMipTrilinear = 2;
constexpr float kMipAmbient = 0.2f;
constexpr float kMipDiffuse = (float)(1.0 - 0.2);

// K7's launch arguments beside RenderArgs (the folded entry's second
// parameter; RenderArgs keeps its size): the mip table's level count, the
// fallback region's rows, and the TPU tiling (ops/mips.py::tile_geometry).
struct MipArgs {
  int n_levels, fb_rows, tile_sub, tiles_x, n_tiles;
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// u8 → f32 texel value: an IEEE divide, bitwise np.float32(k) / 255 (the
// bake's tex_data = u8 / 255).
__device__ __forceinline__ float dequant(int k) {
  return __fdiv_rn((float)k, 255.0f);
}

// Repeat wrap of an index in [-1, n] (:3140-3144).
__device__ __forceinline__ int wrap(int i, int n) {
  i = i < 0 ? i + n : i;
  return i >= n ? i - n : i;
}

// Lambert + ambient over the base colour, RGBA8's byte.
__device__ __forceinline__ uint32_t quantize(float base, float s) {
  const float c = clip01(base * (kMipAmbient + kMipDiffuse * s));
  return (uint32_t)(int)(c * 255.f + 0.5f);
}

// sum_l [fp >= 2^l], l = 1 .. L-1 (ops/mips.py::mip_level).
__device__ __forceinline__ int mip_level(float fp, int n_levels) {
  int lvl = 0;
  for (int l = 1; l < n_levels; ++l) lvl += fp >= (float)(1 << l) ? 1 : 0;
  return lvl;
}

// The taps of one level (:3259-3296): flat pool indices, and for bilinear
// the weights. Offsets and sizes travel as f32 (exact below 2^24); the table
// is [4 + 3L, n_mats]: colour rgb, coarse level, then offset, width, height
// per level.
struct Taps {
  int flat[4];
  float ax, ay;
};

template <bool BILINEAR>
__device__ __forceinline__ Taps taps_at(const float* __restrict__ table, int n_mats, int mat,
                                        float uu, float vv, int lvl) {
  const float off = table[(4 + 3 * lvl) * n_mats + mat];
  const float wf = table[(5 + 3 * lvl) * n_mats + mat];
  const float hf = table[(6 + 3 * lvl) * n_mats + mat];
  const int w_i = (int)wf, h_i = (int)hf, off_i = (int)off;
  Taps t;
  if (!BILINEAR) {
    // A plain cast truncates toward zero, as astype(int32) does.
    const int tx = min(max((int)(uu * wf), 0), w_i - 1);
    const int ty = min(max((int)((1.0f - vv) * hf), 0), h_i - 1);
    t.flat[0] = off_i + ty * w_i + tx;
    t.ax = t.ay = 0.f;
    return t;
  }
  const float fx = uu * wf - 0.5f;
  const float fy = (1.0f - vv) * hf - 0.5f;
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  t.ax = fx - x0f;
  t.ay = fy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int xa = wrap(x0, w_i), xb = wrap(x0 + 1, w_i);
  const int ya = wrap(y0, h_i), yb = wrap(y0 + 1, h_i);
  t.flat[0] = off_i + ya * w_i + xa;  // (0, 0)
  t.flat[1] = off_i + ya * w_i + xb;  // (1, 0)
  t.flat[2] = off_i + yb * w_i + xa;  // (0, 1)
  t.flat[3] = off_i + yb * w_i + xb;  // (1, 1)
  return t;
}

template <bool BILINEAR>
__device__ __forceinline__ void row_span(const Taps& t, int& lo, int& hi) {
  lo = hi = t.flat[0] / kMipLane;
  if (BILINEAR) {
    for (int k = 1; k < 4; ++k) {
      const int r = t.flat[k] / kMipLane;
      lo = min(lo, r);
      hi = max(hi, r);
    }
  }
}

// The texel colour of one level's taps (:3579-3597).
template <bool BILINEAR>
__device__ __forceinline__ void sample(const int* __restrict__ pool, const Taps& t,
                                       float c[3]) {
  if (!BILINEAR) {
    const int texel = pool[t.flat[0]];
    for (int ch = 0; ch < 3; ++ch) c[ch] = dequant((texel >> (8 * ch)) & 255);
    return;
  }
  const int t00 = pool[t.flat[0]], t10 = pool[t.flat[1]];
  const int t01 = pool[t.flat[2]], t11 = pool[t.flat[3]];
  for (int ch = 0; ch < 3; ++ch) {
    const int sh = 8 * ch;
    const float c00 = dequant((t00 >> sh) & 255);
    const float c10 = dequant((t10 >> sh) & 255);
    const float c01 = dequant((t01 >> sh) & 255);
    const float c11 = dequant((t11 >> sh) & 255);
    const float top = c00 * (1.0f - t.ax) + c10 * t.ax;
    const float bot = c01 * (1.0f - t.ax) + c11 * t.ax;
    c[ch] = top * (1.0f - t.ay) + bot * t.ay;
  }
}

// The TPU tile (ops/mips.py::tile_ids) of pixel (x, y): tile_sub-row x
// 128-column rectangles when tiles_x > 1, else bands of tile_sub * 128
// flattened pixels.
__device__ __forceinline__ int tpu_tile(const MipArgs& m, int x, int y, int width) {
  return m.tiles_x > 1 ? (y / m.tile_sub) * m.tiles_x + x / kMipLane
                       : (y * width + x) / (m.tile_sub * kMipLane);
}

// A geometric hit's part in its tile's two window keys (:3330-3336): its
// primary taps' row span at its level, where the taps reach past the
// fallback region and the span fits one window, lowers any-fine (anyf) and,
// magnified (level 0), preferred (pref). Misses take no part.
template <bool BILINEAR>
__device__ __forceinline__ void window_keys(const float* __restrict__ table, int n_mats,
                                            const MipArgs& m, int mat, float u, float v,
                                            float fp, int& pref, int& anyf) {
  const int lvl = mip_level(fp, m.n_levels);
  int lo, hi;
  row_span<BILINEAR>(taps_at<BILINEAR>(table, n_mats, mat, u - floorf(u), v - floorf(v), lvl),
                     lo, hi);
  if (hi >= m.fb_rows && hi - lo < kMipPageRows) {
    anyf = min(anyf, lo);
    if (lvl == 0) pref = min(pref, lo);
  }
}

// The tile's window base from its keys: the least row of its magnified
// anchors, else of any, 8-aligned; 0 for a tile without one.
__device__ __forceinline__ int window_base(int pref, int anyf) {
  int r0 = pref < kMipBig ? pref : anyf;
  r0 = r0 < kMipBig ? r0 : 0;
  return (r0 / 8) * 8;
}

// A shaded hit's base colour (the material colour times the texel) with
// its tile's window at base_row (:3340-3367, :3593-3628): a fine pixel
// (found, its taps past the fallback region) whose primary taps leave the
// window samples its material's coarse chain (level max(level, fit));
// under trilinear a pixel in the window whose blend is live and whose
// secondary taps are neither resident nor in the window keeps the primary
// level alone (blend killed). The sample reads the whole pool: a tap
// outside the TPU's window copy is either clamped or weighted 0.
template <int FILTER>
__device__ __forceinline__ void mip_base(const float* __restrict__ table,
                                         const int* __restrict__ pool, int n_mats,
                                         const MipArgs& m, int mat, bool found, float u,
                                         float v, float fp, int base_row, float& br,
                                         float& bg, float& bb) {
  constexpr bool BILINEAR = FILTER != kMipNearest;  // the primary taps
  const float uu = u - floorf(u), vv = v - floorf(v);
  const int lvl = mip_level(fp, m.n_levels);
  const int top = m.n_levels - 1;
  int lo, hi;
  row_span<BILINEAR>(taps_at<BILINEAR>(table, n_mats, mat, uu, vv, lvl), lo, hi);
  const bool fine = found && hi >= m.fb_rows;
  const bool in_window = lo >= base_row && hi < base_row + kMipPageRows;
  const int fit = (int)table[3 * n_mats + mat];
  const int lvl_f = fine && !in_window ? max(lvl, fit) : lvl;
  float col[3];
  sample<BILINEAR>(pool, taps_at<BILINEAR>(table, n_mats, mat, uu, vv, lvl_f), col);
  if (FILTER == kMipTrilinear) {
    // The blend is live where fp / 2^lvl - 1 > 0 at the unclamped level
    // (:3352-3355).
    const bool live = fp / (float)(1 << lvl) - 1.0f > 0.0f;
    int slo, shi;
    row_span<true>(taps_at<true>(table, n_mats, mat, uu, vv, min(lvl + 1, top)), slo, shi);
    const bool sec_ok = !live || shi < m.fb_rows ||
                        (slo >= base_row && shi < base_row + kMipPageRows);
    const bool kill = fine && in_window && !sec_ok;
    float wgt = clip01(fp / (float)(1 << lvl_f) - 1.0f);
    wgt = kill ? 0.f : wgt;
    float col1[3];
    sample<true>(pool, taps_at<true>(table, n_mats, mat, uu, vv, min(lvl_f + 1, top)), col1);
    for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] * (1.0f - wgt) + col1[ch] * wgt;
  }
  br = table[mat] * col[0];
  bg = table[n_mats + mat] * col[1];
  bb = table[2 * n_mats + mat] * col[2];
}

}  // namespace
