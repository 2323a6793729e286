// K7 folded into K1's index visit: one launch a step renders a view's
// pixels on the index visit's tile teams and samples their mip chains in
// the same block, where the two-launch design (csrc/render_resident.cu's
// mip hand-off, then csrc/shade_mip.cu) writes 28 B a pixel to device
// memory and reads it back.
//
// Replaces, with csrc/render_resident.cu's index visit (visit_body,
// index_tile, mip_pass), madrona_renderer_tpu/ops/raytrace_pallas.py::
// _render_kernel in its resident culled paged-texture variant (tex_paged,
// :3203-3663; launched at raytrace_pallas.py:4872) on prep rows,
// raytraced, cold, in index order. The plain PyTorch version is
// ops/raytrace_cuda.py::render_resident_plain with fb_rows
// (render_handoff_plain, then shade_mip_plain); with --fmad=false and IEEE
// divide the kernel agrees with it, and with the two launches, bit for bit.
//
// Why one block holds it all: the window clamp is decided per TPU tile
// (ops/mips.py::tile_geometry: bands of tile_sub x 128 flattened pixels, or
// tile_sub-row x 128-column rectangles), and every TPU tile lies inside one
// view. The index visit is one block a view, so the block sees every pixel
// of each of its TPU tiles: the teams hold each pixel's winner (best_t,
// best_idx: 8 B, 32 KB at 64x64, 128 KB at 128x128) in shared memory; after
// a block barrier the keys pass resolves each hit again from its record and
// attribute rows with the same expressions and lowers its tile's two window
// keys (pref, anyf) as shared-memory integer minima (order-free: the TPU's
// bits); after another the sample pass reads them.
//
// Bound on an H100: the rows, cluster table, cameras, mip table and pool
// read once, depth, segmask and rgb written (12 B a pixel), against the
// operations of the render (K1's ray, gates, tests and resolve) and of the
// sample (the level, taps, clamp and filter: 80 FP32 operations a pixel
// nearest, some 260 trilinear), each its own instruction under
// --fmad=false; chip_smoke.py works out both for its inputs.

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

// The folded entry: K1's index visit on prep rows with the mip sample,
// kIndexPixels pixels a thread, 1 or 2 groups a block, a block a view, at
// most 65536 / (kThreads * kIndexMaxGroups * kMipMinBlocks) registers a
// thread: 64 (a minimum of one block, 80-90 registers, ran 5-24% slower
// at 64x64 and 1-2% faster at 128x128 on an H100).
constexpr int kMipMinBlocks = 2;

template <int FILTER>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, kMipMinBlocks)
render_mip_kernel(const RenderArgs a, const MipArgs m) {
  visit_body<kGeoPrep, false, kTexMip, false, false, kIndexPixels, FILTER>(a, nullptr,
                                                                          BinArgs{}, nullptr, m);
}

int mip_variant(const RenderArgs& a, const MipArgs& m, int num_views, int filter, int groups,
                int* query, cudaStream_t stream) {
  if (groups < 1 || groups > kIndexMaxGroups) return (int)cudaErrorInvalidValue;
  const size_t smem = index_smem<kGeoPrep>(a, &m);
  switch (filter) {
    case kMipNearest:
      return index_entry(render_mip_kernel<kMipNearest>, smem, num_views, groups, query,
                         stream, a, m);
    case kMipBilinear:
      return index_entry(render_mip_kernel<kMipBilinear>, smem, num_views, groups, query,
                         stream, a, m);
    case kMipTrilinear:
      return index_entry(render_mip_kernel<kMipTrilinear>, smem, num_views, groups, query,
                         stream, a, m);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the folded K7 entry of `filter` (0 nearest, 1 bilinear, 2
// trilinear) on `stream`, on the caller's current device: prep rows,
// raytraced, one camera a world; table is the mip table [4 + 3L, n_mats]
// (shade.mip_table), pool the texel pool; depth, segmask and rgb in their
// final form. The TPU tiling: tile_sub, tiles_x and n_tiles of
// ops/mips.py::tile_geometry(height, width). groups: the index visit's
// groups a block (1 or 2). Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for an unknown filter or plan.
int mrt_render_mip(const float* rows, const float* clusters, const float* cams,
                   const float* table, const int* pool, int n_mats, float* depth,
                   int* segmask, uint32_t* rgb, int num_views, int S, int CC,
                   int cluster_size, int n_cols, int n_lights, int height, int width,
                   int seg_div, float two_over_w, float two_over_h, int n_levels, int fb_rows,
                   int tile_sub, int tiles_x, int n_tiles, int filter, int groups,
                   void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, table, pool, n_mats, depth, segmask,
                                   rgb, nullptr, nullptr, 1, S, CC, cluster_size, n_cols,
                                   n_lights, height, width, seg_div, two_over_w, two_over_h,
                                   kTexNearest);
  const MipArgs m{n_levels, fb_rows, tile_sub, tiles_x, n_tiles};
  return mip_variant(a, m, num_views, filter, groups, nullptr, (cudaStream_t)stream);
}

// The folded entry (filter, groups) at these sizes: threads a block,
// registers, local memory bytes a thread and blocks a multiprocessor, in
// out[0..3]. Returns 0, or the CUDA error of the query.
int mrt_render_mip_occupancy(int filter, int groups, int S, int CC, int n_cols, int n_lights,
                             int height, int width, int n_tiles, int* out) {
  RenderArgs a{};
  a.S = S;
  a.CC = CC;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  a.height = height;
  a.width = width;
  const MipArgs m{0, 0, 0, 0, n_tiles};
  return mip_variant(a, m, 0, filter, groups, out, nullptr);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
