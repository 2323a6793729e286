// K4's parent design: the tile-binned visit of the streamed route on
// render_body's one 16x16 block a (view, tile) (csrc/render_resident.cu,
// included below, with its variant dispatch: the BINNED walk), with its own
// entry point, route and C interface in this translation unit. The route's
// raw and K10 rows and its shadow sweeps (raw_shadows, raw_wt_shadows: K8's
// any-hit sweep per light, every cluster in index order) launch these
// entries; the tile-group entries on prep rows (csrc/render_binned.cu) are
// held bitwise against them
// (chip_smoke.py forces this design through a plan of 0 groups,
// raytrace_cuda.binned_plan).
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in its
// binned variant on 2D tiles with per-band triangle ranges (binned,
// tri_ranges, tri_tie: :1796-1800, :2222-2660, :2681-2691; the bins
// :4762-4810), launched at :4872. Per (view, 16x16 block) the kernel walks
// the bin of the bin tile the block lies in (bins [W*C, n_bins, 1 + CC]:
// the count, then the cluster ids front to back, raytrace_cuda.
// band_cluster_bins at a square tile of 16 * 2^bin_shift pixels that blocks
// share) with the ordered walk's gates (the occlusion early exit, the row
// gate on the clusters' 8-row-band spans, the slab test with its tie slack)
// and a cp.async double buffer; the cluster table, the bin and the spans are
// read from device memory (each gate's reads the same word for every
// thread: a broadcast), and each gate takes two block barriers. On prep rows
// the rows are row-sorted per cluster (raytrace_cuda.cluster_row_sort /
// row_sorted: geometry rows 0-9 permuted, row 10 the original index) and
// the block's two 8-row bands (warps 0-3 and 4-7) each sweep only the sorted
// lanes [lo, hi) of their image band (ranges [W, CC, n_bands]) where the
// cluster's span touches the band; exact-t ties go to the lower original
// index, so the frames are the index-order sweep's (raytrace_cuda.
// render_resident_plain), bit for bit. On raw rows a visited cluster's valid
// prefix is swept, as on the ordered walk. The 9-output mode (:3664-3670;
// prep, raw and K10 rows, raytrace and raster) writes t, z, the original
// index, the material, uv and the normal, unmasked, for the epilogue. The
// seeded entries of this design (K9) are csrc/render_seeded.cu's, K11's
// (the dmxu sweep on it) csrc/render_dmxu.cu's.
//
// Bound on an H100: the walk's work (positions gated, slab tests, the
// triangle tests of the swept lanes) at about 27 FP32 operations per prep
// test; chip_smoke.py counts them from ops/walk_replay.binned_walk for its
// inputs.

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_binned_kernel(const RenderArgs a, const BinArgs b) {
  render_body<GEO, RASTER, TEX, true, true>(a, StreamArgs{nullptr, nullptr}, b);
}

// K4's launch of one variant: the streamed grid, and shared memory for the
// two stage buffers and the camera row.
struct BinnedRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const BinArgs& b, int num_views,
                 cudaStream_t stream) {
    return launch_grid(render_binned_kernel<GEO, RASTER, TEX>, a, num_views,
                       binned_smem<GEO>(a), stream, a, b);
  }
};

}  // namespace

extern "C" {

// Launches the parent design's binned variant (geo, raster, tex_filter) on
// `stream`, on the caller's current device, with mrt_render_resident's arguments but for the
// visit: bins, spans (8-row bands) and, with prep rows (geo 0) and only
// then, ranges; the bin of block (bx, by) is
// (by >> bin_shift) * bins_x + (bx >> bin_shift) of n_bins a view, and
// ranges hold n_bands bands a cluster; tex_filter 4 is the 9-output mode
// (geo 0, 1 or 3), written as in mrt_render_none. rows, cluster_size and S
// must keep
// every cluster's rows 16-byte aligned. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for an unknown variant
// or a missing input.
int mrt_render_binned_blocks(const float* rows, const float* clusters, const float* cams,
                      const float* mats, const int* pool, int n_mats, float* depth,
                      int* segmask, uint32_t* rgb, int* code, float* handoff,
                      const int* bins, const int* spans, const int* ranges,
                      int num_views, int num_cams, int S, int CC, int cluster_size,
                      int n_cols, int n_lights, int height, int width, int seg_div,
                      float two_over_w, float two_over_h, int raster, int tex_filter,
                      int geo, int bins_x, int bin_shift, int n_bins, int n_bands,
                      void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (bins == nullptr || spans == nullptr || (ranges == nullptr) != (geo != kGeoPrep))
    return (int)cudaErrorInvalidValue;
  if (cluster_size % 4 != 0 || S % 4 != 0 || ((uintptr_t)rows & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const BinArgs b{bins, spans, reinterpret_cast<const int2*>(ranges), bins_x, bin_shift,
                  n_bins, n_bands};
  return launch_variant<BinnedRoute>(a, b, num_views, geo, raster, tex_filter,
                                     (cudaStream_t)stream);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
