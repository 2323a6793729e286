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
// recomputing the taps rather than keeping them. It serves every mode of K7
// but the one K1's index visit takes (prep rows, raytraced, cold, on tile
// teams: csrc/render_mip.cu folds this launch into the render kernel, one
// launch a step without the hand-off's round trip); the texel path both
// share is csrc/mip_sample.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mip_sample.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFoundBit = 1 << 16;
constexpr int kShadedBit = 1 << 17;
constexpr int kMatMask = 0xFFFF;
constexpr uint32_t kAlpha = 0xFF000000u;

struct Args {
  const int* code;
  const float* handoff;
  const float* cams;
  const float* table;
  const int* pool;
  uint32_t* rgb;
  int n_cols, cam_valid_col, n_mats;
  MipArgs m;
  int height, width;
};

// Pixel j of the block's tile → its flat index in the view, or -1 for the
// tile's overhang past the image (which never widens the window, :3243).
__device__ __forceinline__ int tile_pixel(const Args& a, int tile, int j) {
  const int sub = j / kMipLane, lane = j % kMipLane;
  if (a.m.tiles_x > 1) {
    const int y = (tile / a.m.tiles_x) * a.m.tile_sub + sub;
    const int x = (tile % a.m.tiles_x) * kMipLane + lane;
    return y < a.height ? y * a.width + x : -1;
  }
  const int p = tile * a.m.tile_sub * kMipLane + j;
  return p < a.height * a.width ? p : -1;
}

template <int FILTER>
__global__ void __launch_bounds__(kThreads) shade_mip_kernel(const Args a) {
  constexpr bool BILINEAR = FILTER != kMipNearest;  // the primary taps
  const int view = blockIdx.x, tile = blockIdx.y;
  const int P = a.height * a.width;
  const size_t plane = (size_t)gridDim.x * P;
  const int* code = a.code + (size_t)view * P;
  const float* hf = a.handoff + (size_t)view * P;
  const int tile_pix = a.m.tile_sub * kMipLane;

  // Pass 1: the tile's two window keys (:3330-3336). The loop count is the
  // same for every thread, so every thread reaches the reductions.
  int pref = kMipBig, anyf = kMipBig;
  for (int j = threadIdx.x; j < tile_pix; j += kThreads) {
    const int p = tile_pixel(a, tile, j);
    if (p < 0) continue;
    const int c = code[p];
    if (!(c & kFoundBit)) continue;
    window_keys<BILINEAR>(a.table, a.n_mats, a.m, c & kMatMask, hf[p], hf[plane + p],
                          hf[2 * plane + p], pref, anyf);
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
  const int base_row = window_base(pref, anyf);

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
    float br, bg, bb;
    mip_base<FILTER>(a.table, a.pool, a.n_mats, a.m, c & kMatMask, (c & kFoundBit) != 0,
                     hf[p], hf[plane + p], hf[2 * plane + p], base_row, br, bg, bb);
    rgb[p] = quantize(br, hf[3 * plane + p]) | (quantize(bg, hf[4 * plane + p]) << 8) |
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
  const MipArgs m{n_levels, fb_rows, tile_sub, tiles_x, n_tiles};
  const Args a{code, handoff, cams, table, pool, rgb, n_cols, cam_valid_col, n_mats, m,
               height, width};
  switch (filter) {
    case kMipNearest: return launch<kMipNearest>(a, num_views, n_tiles, st);
    case kMipBilinear: return launch<kMipBilinear>(a, num_views, n_tiles, st);
    case kMipTrilinear: return launch<kMipTrilinear>(a, num_views, n_tiles, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
