// K4 on resident rows: the tile-binned walk of a resident world's clusters,
// the render kernel's body (csrc/render_resident.cu, included below, with
// its variant dispatch) in its RWALK mode with BINNED, with its own entry
// point, route and C interface in this translation unit, which builds
// beside the others.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its binned variant on the resident SMEM rows (binned, :2681-2691, the walk
// front_to_back_sweep :1755-1785; the bins band_cluster_bins, :4762-4810),
// launched at :4872, which render_core takes for resident worlds with
// accel="binned", or "auto" with 64 or more clusters and 4 or more TPU tiles
// (:4272-4280). Per (view, 16x16 block) the world's geometry rows, the
// cluster table and the camera row sit in shared memory, as on K1, and the
// block walks the bin of the bin tile it lies in (bins [W*C, n_bins,
// 1 + CC]: the count, then the cluster ids front to back,
// raytrace_cuda.band_cluster_bins at a square tile of 16 * 2^bin_shift
// pixels that blocks share), read in device memory as the streamed K4 reads
// it (each id is the same word for every thread: a broadcast): the early
// exit, the slab test with its tie slack, and the valid prefix of each
// visited cluster swept from shared memory, exact-t ties to the lower
// triangle index, so the frames are the index-order sweep's
// (raytrace_cuda.render_resident_plain), bit for bit. There are no row
// spans, row sort or triangle ranges on the resident route (the JAX package
// builds them for its deferred sweep only, :4373-4378, :4402-4410). Every
// mode of K1 has its entry here, and the 9-output mode (:3664-3670) on the
// prep, raw and K10 rows, raytrace and raster, its raytrace entries seeded
// too.
//
// Bound on an H100: as K3 on resident rows (csrc/render_resident_ordered.cu),
// over the bin's clusters; chip_smoke.py counts the walk's work, with the bin
// entries its blocks read, from ops/walk_replay.resident_walk. Shared memory
// is K1's; the bins are [views, bins, 1 + CC] i32 in device memory (at most
// 2^25 entries, bin_tile_for).

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_resident_binned_kernel(const RenderArgs a, const BinArgs b) {
  render_body<GEO, RASTER, TEX, false, true, true>(a, StreamArgs{nullptr, nullptr}, b,
                                                    nullptr);
}

// K9's entries of this route: the raytrace variants, seeded.
template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads)
render_resident_binned_seeded_kernel(const RenderArgs a, const BinArgs b,
                                    const float* __restrict__ seed) {
  render_body<GEO, false, TEX, false, true, true, true>(a, StreamArgs{nullptr, nullptr}, b,
                                                       seed);
}

// K4's resident launch of one variant: K1's grid and shared memory.
struct ResidentBinnedRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const Seeded<BinArgs>& v, int num_views,
                 cudaStream_t stream) {
    const size_t smem = resident_smem<GEO>(a);
    if (v.seed == nullptr)
      return launch_grid(render_resident_binned_kernel<GEO, RASTER, TEX>, a, num_views,
                         smem, stream, a, v.x);
    if constexpr (RASTER) {
      return (int)cudaErrorInvalidValue;  // K9 raytraces only
    } else {
      return launch_grid(render_resident_binned_seeded_kernel<GEO, TEX>, a, num_views, smem,
                         stream, a, v.x, v.seed);
    }
  }
};

}  // namespace

extern "C" {

// Launches the resident binned variant (geo, raster, tex_filter) on
// `stream`, on the caller's current device, seeded by `seed` ([num_views,
// height, width] f32, K9; raytrace variants only) unless it is null, with
// mrt_render_resident's arguments but for the visit: bins [num_views,
// n_bins, 1 + CC], the bin of block (bx, by) being
// (by >> bin_shift) * bins_x + (bx >> bin_shift); tex_filter 4 is the
// 9-output mode (geo 0, 1 or 3), written as in mrt_render_none. Returns
// cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for an unknown
// variant or missing bins.
int mrt_render_resident_binned(const float* rows, const float* clusters,
                               const float* cams, const float* mats, const int* pool,
                               int n_mats, float* depth, int* segmask, uint32_t* rgb,
                               int* code, float* handoff, const int* bins,
                               const float* seed, int num_views, int num_cams, int S,
                               int CC, int cluster_size, int n_cols, int n_lights,
                               int height, int width, int seg_div, float two_over_w,
                               float two_over_h, int raster, int tex_filter, int geo,
                               int bins_x, int bin_shift, int n_bins, void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (bins == nullptr) return (int)cudaErrorInvalidValue;
  const BinArgs b{bins, nullptr, nullptr, bins_x, bin_shift, n_bins, 0};
  return launch_variant<ResidentBinnedRoute>(a, Seeded<BinArgs>{b, seed}, num_views, geo,
                                             raster, tex_filter, (cudaStream_t)stream);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
