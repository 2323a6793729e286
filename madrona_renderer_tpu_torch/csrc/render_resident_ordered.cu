// K3 on resident rows: the front-to-back walk of a resident world's
// clusters, the render kernel's body (csrc/render_resident.cu, included
// below, with its variant dispatch) in its RWALK mode, with its own entry
// point, route and C interface in this translation unit, which builds
// beside the others.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its ordered variant on the resident SMEM rows (ordered, :2692-2699, the
// walk front_to_back_sweep :1755-1785; the order camera_cluster_order,
// :4819-4832), launched at :4872, which render_core takes for resident
// worlds of 4 or more clusters that it does not bin (:4291-4292). One block
// a view (visit_body in csrc/render_resident.cu): the world's geometry rows,
// the cluster table, the camera row and the view's cluster order
// (raytrace_cuda.camera_cluster_order: the clusters by ascending
// camera-to-AABB distance, invalid ones last) are filled into shared memory
// once, and the block's tile groups of 16x16 threads each walk one tile at a
// time: a walk stops at the first invalid cluster or at the first that no
// pixel of its tile can reach (best_t^2 <= 0.998 * approach distance^2),
// skips a cluster whose slab test (tmin * 0.999 < best_t, so a tie is never
// culled) no ray of its tile passes, and sweeps the rest's valid prefix from
// shared memory. Exact-t ties go to the lower triangle index, so the frames
// are the index-order sweep's (raytrace_cuda.render_resident_plain), bit for
// bit. With K9's seed each pixel's search starts at min(seed, far), which
// lets the walk stop sooner. Every mode of K1 has its entry here, and the
// 9-output mode (the factory's shaded = False outputs, :3664-3670) on the
// prep, raw and K10 rows, raytrace and raster, its raytrace entries seeded
// too: the same walk, then the winner's t, z, idx, material, uv and normal,
// unmasked, for the epilogue.
//
// Bound on an H100: K1's per-pixel work (ray generation, resolve, shading)
// plus, per position a tile reaches, the approach distance and the exit
// test, per gated position the slab test, and the triangle tests of the
// visited clusters (about 28 FP32 operations a prep test, 37 raw, 44
// watertight); chip_smoke.py counts the walk's work from
// ops/walk_replay.resident_walk for its inputs. The order adds 4 bytes a
// cluster to the block's shared memory (at most 1.5 KB at the resident
// budget's 384 clusters of 8). A tile's two gates of a position share one
// barrier of its group; nothing is staged.

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads * visit_groups<GEO>(), 1)
render_resident_ordered_kernel(const RenderArgs a, const StreamArgs s) {
  visit_body<GEO, RASTER, TEX, false, false>(a, s.order, BinArgs{}, nullptr);
}

// K9's entries of this route: the raytrace variants, seeded.
template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads * visit_groups<GEO>(), 1)
render_resident_ordered_seeded_kernel(const RenderArgs a, const StreamArgs s,
                                     const float* __restrict__ seed) {
  visit_body<GEO, false, TEX, false, true>(a, s.order, BinArgs{}, seed);
}

// K3's launch of one variant (or its occupancy query: v.query): a block a
// view, the order in shared memory.
struct OrderedRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const VisitArgs<StreamArgs>& v, int num_views,
                 cudaStream_t stream) {
    const size_t smem = visit_smem<GEO>(a, true);
    if (v.seed == nullptr)
      return visit_launch<GEO>(render_resident_ordered_kernel<GEO, RASTER, TEX>, v.query,
                               num_views, smem, stream, a, v.x);
    if constexpr (RASTER) {
      return (int)cudaErrorInvalidValue;  // K9 raytraces only
    } else {
      return visit_launch<GEO>(render_resident_ordered_seeded_kernel<GEO, TEX>, v.query, num_views,
                               smem, stream, a, v.x, v.seed);
    }
  }
};

}  // namespace

extern "C" {

// Launches the ordered variant (geo, raster, tex_filter) on `stream`, on
// the caller's current device, seeded by `seed` ([num_views, height, width]
// f32, K9; raytrace variants only) unless it is null, with
// mrt_render_resident's arguments but for the visit: order [num_views, CC], each view's
// cluster visit order; tex_filter 4 is the 9-output mode (geo 0, 1 or 3),
// written to depth, segmask, code and handoff as in mrt_render_none. The
// geometry fill copies 16-byte pieces: rows must be 16-byte aligned and S a
// multiple of 4. Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for an unknown variant or a missing
// order, or cudaErrorMisalignedAddress.
int mrt_render_resident_ordered(const float* rows, const float* clusters,
                                const float* cams, const float* mats, const int* pool,
                                int n_mats, float* depth, int* segmask, uint32_t* rgb,
                                int* code, float* handoff, const int* order,
                                const float* seed, int num_views, int num_cams, int S,
                                int CC, int cluster_size, int n_cols, int n_lights,
                                int height, int width, int seg_div, float two_over_w,
                                float two_over_h, int raster, int tex_filter, int geo,
                                void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  if (S % 4 != 0 || ((uintptr_t)rows & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const VisitArgs<StreamArgs> v{{order, nullptr}, seed, nullptr};
  return launch_variant<OrderedRoute>(a, v, num_views, geo, raster, tex_filter,
                                      (cudaStream_t)stream);
}

// The variant's (geo, raster, tex_filter, seeded) threads a block,
// registers, local memory bytes a thread and blocks a multiprocessor at
// S slots, CC clusters, n_cols camera columns and n_lights lights, in
// out[0..3]. Returns 0, or the CUDA error of the query.
int mrt_render_resident_ordered_occupancy(int geo, int raster, int tex_filter, int seeded,
    int S, int CC, int n_cols, int n_lights, int* out) {
  RenderArgs a{};
  a.S = S;
  a.CC = CC;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  static const float kSeeded = 0.f;  // any non-null seed picks the seeded entry
  const VisitArgs<StreamArgs> v{{}, seeded ? &kSeeded : nullptr, out};
  return launch_variant<OrderedRoute>(a, v, 0, geo, raster, tex_filter, nullptr);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
