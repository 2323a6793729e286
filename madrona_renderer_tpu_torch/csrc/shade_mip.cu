// K7, second launch: mip level, per-tile window clamp, mip sampling and
// the packed rgb, from the hand-off of csrc/render_resident.cu's mip mode.
//
// Replaces the paged-texture shading of
// madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel (tex_paged,
// :3203-3663; launched at raytrace_pallas.py:4872). The plain PyTorch
// version is ops/raytrace_cuda.py::shade_mip_plain, on ops/mips.py; both
// compute the same expressions in the same order, so with --fmad=false and
// IEEE divide the two agree bit for bit.
//
// What it computes, per (view, pixel), in one block per view and TPU tile
// (ops/mips.py::tile_geometry: bands of tile_sub x 128 flattened pixels,
// or tile_sub-row x 128-column rectangles on wide images):
//   1. the level: footprint fp from the hand-off, level = sum_l [fp >= 2^l]
//      (:3237-3240), exact compares;
//   2. the primary taps at that level (nearest: one, bilinear and
//      trilinear: four, with wrap) and their span of 128-texel pool rows
//      (:3259-3329);
//   3. the tile's window base: the least row_lo of the tile's magnified
//      (level 0) anchoring pixels, else of any anchoring pixel, 8-aligned,
//      where a pixel anchors when it hit geometry, its taps reach past the
//      fallback region and its span fits one window (:3330-3339). The
//      TPU chose one window per tile of its own tiling; the CUDA block is
//      that tile, so the minimum is a block reduction;
//   4. the clamp (:3340-3367): a fine pixel whose taps leave the window
//      samples its material's coarse chain (level max(level, fit)); under
//      trilinear a pixel in the window whose blend is live and whose
//      secondary taps are neither resident nor in the window keeps the
//      primary level alone (blend killed);
//   5. the sample (:3593-3628) from the whole pool in global memory — the
//      TPU's window copy is a decision here, not a copy: a tap outside the
//      window is either clamped to the coarse chain or enters with weight 0
//      (a finite k/255 texel times 0), so the bits are the TPU's;
//   6. lambert + ambient from the hand-off's sums, RGBA8 packed, camera
//      mask (:3630-3663).
//
// Layout: code i32 [V, H, Wd] (material | 1 << 16 geometric hit | 1 << 17
// shaded hit), handoff f32 [6, V, H, Wd] (u, v, fp, lambert r, g, b), cams
// f32 [V, NCOL], table f32 [4 + 3L, M] (colour rgb, coarse fallback level,
// then offset, width, height per level), pool i32 [texels], rgb u32
// [V, H, Wd].
//
// Bound on an H100: per pixel 28 B of hand-off read and 4 B of rgb written
// (about 540 MB per step at 4096 views x 64x64, 0.16 ms), against some 80
// FP32 operations (nearest) to 260 (trilinear), each its own instruction
// under --fmad=false: bytes bound it. The pool (a 256^2 chain, about
// 350 KB) sits in L2.
// The design is the simple one: 256 threads a block, each taking every
// 256th pixel of the tile twice (once for the window keys, once to shade),
// recomputing the taps rather than keeping them. Left for a later change:
// folding this launch into the render kernel, whose 16x16 blocks are not
// the TPU's tiles, to save the hand-off's round trip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;       // texels a pool row; pixels a tile row
constexpr int kPageRows = 128;   // TEX_PAGE_ROWS: rows of one window
constexpr int kBig = 1 << 30;
constexpr int kFoundBit = 1 << 16;
constexpr int kShadedBit = 1 << 17;
constexpr int kMatMask = 0xFFFF;

constexpr int kNearest = 0;
constexpr int kBilinear = 1;
constexpr int kTrilinear = 2;

constexpr float kAmbient = 0.2f;
constexpr float kDiffuse = (float)(1.0 - 0.2);
constexpr uint32_t kAlpha = 0xFF000000u;

struct Args {
  const int* code;
  const float* handoff;
  const float* cams;
  const float* table;
  const int* pool;
  uint32_t* rgb;
  int n_cols, cam_valid_col, n_mats, n_levels, fb_rows, height, width,
      tile_sub, tiles_x;
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

__device__ __forceinline__ uint32_t quantize(float base, float s) {
  const float c = clip01(base * (kAmbient + kDiffuse * s));
  return (uint32_t)(int)(c * 255.f + 0.5f);
}

__device__ __forceinline__ float dequant(int k) {
  return __fdiv_rn((float)k, 255.0f);
}

__device__ __forceinline__ int wrap(int i, int n) {
  i = i < 0 ? i + n : i;
  return i >= n ? i - n : i;
}

// sum_l [fp >= 2^l], l = 1 .. L-1 (ops/mips.py::mip_level).
__device__ __forceinline__ int mip_level(float fp, int n_levels) {
  int lvl = 0;
  for (int l = 1; l < n_levels; ++l) lvl += fp >= (float)(1 << l) ? 1 : 0;
  return lvl;
}

// The taps of one level (:3259-3296): flat pool indices, and for bilinear
// the weights. Offsets and sizes travel as f32 (exact below 2^24).
struct Taps {
  int flat[4];
  float ax, ay;
};

template <bool BILINEAR>
__device__ __forceinline__ Taps taps_at(const Args& a, int mat, float uu,
                                        float vv, int lvl) {
  const float off = a.table[(4 + 3 * lvl) * a.n_mats + mat];
  const float wf = a.table[(5 + 3 * lvl) * a.n_mats + mat];
  const float hf = a.table[(6 + 3 * lvl) * a.n_mats + mat];
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
  lo = hi = t.flat[0] / kLane;
  if (BILINEAR) {
    for (int k = 1; k < 4; ++k) {
      const int r = t.flat[k] / kLane;
      lo = min(lo, r);
      hi = max(hi, r);
    }
  }
}

// The texel colour of one level's taps (:3579-3597).
template <bool BILINEAR>
__device__ __forceinline__ void sample(const int* __restrict__ pool,
                                       const Taps& t, float c[3]) {
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

// Pixel j of the block's tile → its flat index in the view, or -1 for the
// tile's overhang past the image (which never widens the window, :3243).
__device__ __forceinline__ int tile_pixel(const Args& a, int tile, int j) {
  const int sub = j / kLane, lane = j % kLane;
  if (a.tiles_x > 1) {
    const int y = (tile / a.tiles_x) * a.tile_sub + sub;
    const int x = (tile % a.tiles_x) * kLane + lane;
    return y < a.height ? y * a.width + x : -1;
  }
  const int p = tile * a.tile_sub * kLane + j;
  return p < a.height * a.width ? p : -1;
}

template <int FILTER>
__global__ void __launch_bounds__(kThreads) shade_mip_kernel(const Args a) {
  constexpr bool BILINEAR = FILTER != kNearest;  // the primary taps
  const int view = blockIdx.x, tile = blockIdx.y;
  const int P = a.height * a.width;
  const size_t plane = (size_t)gridDim.x * P;
  const int* code = a.code + (size_t)view * P;
  const float* hf = a.handoff + (size_t)view * P;
  const int tile_pix = a.tile_sub * kLane;

  // Pass 1: the tile's two window keys (:3330-3336). The loop count is the
  // same for every thread, so every thread reaches the reductions.
  int pref = kBig, anyf = kBig;
  for (int j = threadIdx.x; j < tile_pix; j += kThreads) {
    const int p = tile_pixel(a, tile, j);
    if (p < 0) continue;
    const int c = code[p];
    if (!(c & kFoundBit)) continue;
    const float u = hf[p], v = hf[plane + p];
    const int lvl = mip_level(hf[2 * plane + p], a.n_levels);
    int lo, hi;
    row_span<BILINEAR>(
        taps_at<BILINEAR>(a, c & kMatMask, u - floorf(u), v - floorf(v), lvl), lo,
        hi);
    if (hi >= a.fb_rows && hi - lo < kPageRows) {
      anyf = min(anyf, lo);
      if (lvl == 0) pref = min(pref, lo);
    }
  }
  __shared__ int s_min[2][kThreads / 32];
  pref = __reduce_min_sync(0xffffffffu, pref);
  anyf = __reduce_min_sync(0xffffffffu, anyf);
  if (threadIdx.x % 32 == 0) {
    s_min[0][threadIdx.x / 32] = pref;
    s_min[1][threadIdx.x / 32] = anyf;
  }
  __syncthreads();
  pref = s_min[0][0];
  anyf = s_min[1][0];
  for (int w = 1; w < kThreads / 32; ++w) {
    pref = min(pref, s_min[0][w]);
    anyf = min(anyf, s_min[1][w]);
  }
  int r0 = pref < kBig ? pref : anyf;
  r0 = r0 < kBig ? r0 : 0;
  const int base_row = (r0 / 8) * 8;

  // Pass 2: clamp, sample, shade, pack.
  const float* cam = a.cams + (size_t)view * a.n_cols;
  const bool cam_ok = cam[a.cam_valid_col] > 0.f;
  uint32_t* rgb = a.rgb + (size_t)view * P;
  for (int j = threadIdx.x; j < tile_pix; j += kThreads) {
    const int p = tile_pixel(a, tile, j);
    if (p < 0) continue;
    const int c = code[p];
    // A pixel that shades nothing packs to opaque black whatever its base.
    if (!cam_ok || !(c & kShadedBit)) {
      rgb[p] = kAlpha;
      continue;
    }
    const int mat = c & kMatMask;
    const float u = hf[p], v = hf[plane + p], fp = hf[2 * plane + p];
    const float uu = u - floorf(u), vv = v - floorf(v);
    const int lvl = mip_level(fp, a.n_levels);
    const int top = a.n_levels - 1;
    int lo, hi;
    row_span<BILINEAR>(taps_at<BILINEAR>(a, mat, uu, vv, lvl), lo, hi);
    const bool fine = (c & kFoundBit) && hi >= a.fb_rows;
    const bool in_window = lo >= base_row && hi < base_row + kPageRows;
    const int fit = (int)a.table[3 * a.n_mats + mat];
    const int lvl_f = fine && !in_window ? max(lvl, fit) : lvl;
    float col[3];
    sample<BILINEAR>(a.pool, taps_at<BILINEAR>(a, mat, uu, vv, lvl_f), col);
    if (FILTER == kTrilinear) {
      // The blend is live where fp / 2^lvl - 1 > 0 at the unclamped level
      // (:3352-3355); a live pixel in the window whose secondary taps are
      // neither resident nor in the window keeps its primary level alone.
      const bool live = fp / (float)(1 << lvl) - 1.0f > 0.0f;
      int slo, shi;
      row_span<true>(taps_at<true>(a, mat, uu, vv, min(lvl + 1, top)), slo, shi);
      const bool sec_ok = !live || shi < a.fb_rows ||
                          (slo >= base_row && shi < base_row + kPageRows);
      const bool kill = fine && in_window && !sec_ok;
      float wgt = clip01(fp / (float)(1 << lvl_f) - 1.0f);
      wgt = kill ? 0.f : wgt;
      float col1[3];
      sample<true>(a.pool, taps_at<true>(a, mat, uu, vv, min(lvl_f + 1, top)),
                   col1);
      for (int ch = 0; ch < 3; ++ch)
        col[ch] = col[ch] * (1.0f - wgt) + col1[ch] * wgt;
    }
    const float br = a.table[mat] * col[0];
    const float bg = a.table[a.n_mats + mat] * col[1];
    const float bb = a.table[2 * a.n_mats + mat] * col[2];
    rgb[p] = quantize(br, hf[3 * plane + p]) |
             (quantize(bg, hf[4 * plane + p]) << 8) |
             (quantize(bb, hf[5 * plane + p]) << 16) | kAlpha;
  }
}

template <int FILTER>
int launch(const Args& a, int num_views, int n_tiles, cudaStream_t stream) {
  shade_mip_kernel<FILTER><<<dim3(num_views, n_tiles), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the filter's variant (0 nearest, 1 bilinear, 2 trilinear) on
// `stream`, on the caller's current device: one block per view and TPU
// tile, n_tiles = tiles_x * ceil(height / tile_sub) (2D tiles) or
// ceil(height * width / (tile_sub * 128)) (bands, tiles_x = 1). Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown filter.
int mrt_shade_mip(const int* code, const float* handoff, const float* cams,
                  const float* table, const int* pool, uint32_t* rgb,
                  int num_views, int n_cols, int cam_valid_col, int n_mats,
                  int n_levels, int fb_rows, int height, int width,
                  int tile_sub, int tiles_x, int n_tiles, int filter,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Args a{code, handoff, cams, table, pool, rgb, n_cols, cam_valid_col,
               n_mats, n_levels, fb_rows, height, width, tile_sub, tiles_x};
  switch (filter) {
    case kNearest: return launch<kNearest>(a, num_views, n_tiles, st);
    case kBilinear: return launch<kBilinear>(a, num_views, n_tiles, st);
    case kTrilinear: return launch<kTrilinear>(a, num_views, n_tiles, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
