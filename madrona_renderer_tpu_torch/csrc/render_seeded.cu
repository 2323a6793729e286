// K9 on K1 (index order) and on the streamed binned walk's parent design
// (render_body's 16x16 blocks: the route's raw and K10 rows and shadow
// sweeps, and the reference that csrc/render_binned.cu's seeded tile
// groups on prep rows are held to; the streamed
// ordered walk's seeded entries are csrc/render_streamed.cu's): the render
// kernel's body (csrc/render_resident.cu, included below, with its variant
// dispatch) in its SEEDED mode, with its own entry points, route and C
// interface in this translation unit, which builds beside the others, so
// that csrc/render_resident.cu's and csrc/render_binned_blocks.cu's entries
// keep their code (a seed pointer in them moved 29 of their times past 1.5%
// on an H100, port_tools/tree_ab.py, and their seeded instantiations in the
// same translation units moved 13 entries' registers,
// port_tools/ptxas_regs.py).
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its seeded variant (seeded, :1064-1069, :1205-1209; the seed's tile layout
// _pack_seed_tiles :3968-3972), launched at :4872, which render_core builds
// for a seed_t (:4146-4158), the JAX package's warm start's (ops/warmstart.py
// :39, :99). Per pixel best_t starts at min(seed, far) rather than far
// (seed [W*C, H, Wd] f32; a thread past the image edge starts at 0, so it
// accepts nothing and never holds a walk's exit back), and everything else
// is the cold variant's: a hit must lie strictly inside the window (t <
// best_t; the walks' tie rule t == best_t && i < best_idx needs an accepted
// triangle), so a seed at or below a pixel's nearest hit renders it as a
// miss. The raytrace variants only: the rasterizer takes no seed, as in the
// JAX package.
//
// Bound on an H100: the cold variant's, with the seed read once (4 bytes a
// pixel) and its min (1 FP32 operation a thread); the walk's work is what the
// seed leaves (chip_smoke.py replays it, seeded, with ops/walk_replay.py). The
// design is the cold kernel's: the seed changes one initial value. The
// binned parent design's 9-output entries (prep, raw and K10 rows) are
// seeded here too; K1's seeded 9-output entries are csrc/render_none.cu's.

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads)
render_resident_seeded_kernel(const RenderArgs a, const float* __restrict__ seed) {
  render_body<GEO, false, TEX, false, false, false, true>(a, StreamArgs{nullptr, nullptr},
                                                          BinArgs{}, seed);
}

template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads)
render_binned_seeded_kernel(const RenderArgs a, const BinArgs b,
                            const float* __restrict__ seed) {
  render_body<GEO, false, TEX, true, true, false, true>(a, StreamArgs{nullptr, nullptr}, b,
                                                        seed);
}

// The visit of a seeded launch: with b.bins the streamed binned walk, else
// K1's index order.
struct Visits {
  BinArgs b;
};

// K9's launch of one variant, on its route's grid and shared memory.
struct SeededRoute {
  static constexpr bool kNine = true;  // the streamed binned walk's only
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const Seeded<Visits>& v, int num_views,
                 cudaStream_t stream) {
    if constexpr (RASTER) {
      return (int)cudaErrorInvalidValue;  // K9 raytraces only
    } else {
      if (v.x.b.bins != nullptr)
        return launch_grid(render_binned_seeded_kernel<GEO, TEX>, a, num_views,
                           binned_smem<GEO>(a), stream, a, v.x.b, v.seed);
      if constexpr (TEX == kTexNine) {
        return (int)cudaErrorInvalidValue;
      } else {
        return launch_grid(render_resident_seeded_kernel<GEO, TEX>, a, num_views,
                           resident_smem<GEO>(a), stream, a, v.seed);
      }
    }
  }
};

}  // namespace

extern "C" {

// Launches the seeded variant (geo, tex_filter; raster must be 0) on
// `stream`, on the caller's current device, with mrt_render_binned's
// arguments and `seed` ([num_views, height, width] f32): with bins, spans
// and (geo 0 only) ranges the streamed binned walk, with neither K1's index
// order; tex_filter 4 (the 9-output mode, geo 0, 1 or 3) on the streamed
// binned walk only. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for an unknown variant, a raster one,
// a missing seed or visit input.
int mrt_render_seeded(const float* rows, const float* clusters, const float* cams,
                      const float* mats, const int* pool, int n_mats, float* depth,
                      int* segmask, uint32_t* rgb, int* code, float* handoff,
                      const int* spans, const int* bins,
                      const int* ranges, const float* seed, int num_views, int num_cams,
                      int S, int CC, int cluster_size, int n_cols, int n_lights, int height,
                      int width, int seg_div, float two_over_w, float two_over_h,
                      int raster, int tex_filter, int geo, int bins_x, int bin_shift,
                      int n_bins, int n_bands, void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (seed == nullptr || ((bins != nullptr) != (spans != nullptr)) ||
      (bins != nullptr && (ranges == nullptr) != (geo != kGeoPrep)))
    return (int)cudaErrorInvalidValue;
  if (spans != nullptr &&
      (cluster_size % 4 != 0 || S % 4 != 0 || ((uintptr_t)rows & 15) != 0))
    return (int)cudaErrorMisalignedAddress;
  const Visits x{BinArgs{bins, spans, reinterpret_cast<const int2*>(ranges), bins_x,
                         bin_shift, n_bins, n_bands}};
  return launch_variant<SeededRoute>(a, Seeded<Visits>{x, seed}, num_views, geo, raster,
                                     tex_filter, (cudaStream_t)stream);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
