// K11: the deferred matmul sweep of the streamed route, with its own entry
// points, route and C interface in this translation unit, which builds
// beside the others, so that the older sources' entries keep their code.
// Its ordered visit's entries walk the ordered walk's tile groups
// (stream_body / stream_tile in csrc/render_streamed.cu, included below
// without that source's entries, MRT_STREAMED_BODY_ONLY, in their DMXU mode;
// render_streamed.cu includes csrc/render_resident.cu's helpers and variant
// dispatch) on prep and raw rows, on raytrace_cuda.streamed_plan's plan
// (dmxu=True); render_body's 16x16 blocks in their DMXU mode are the parent
// design, which every tile-group entry is held bitwise against (chip_smoke.py
// forces it through a plan of 0 groups). The binned visit's entries here are
// render_body's blocks: the route on raw rows, and the parent design that the
// binned walk's tile groups on prep rows (csrc/render_binned.cu) are held to
// (raytrace_cuda.binned_plan).
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its dmxu variant (MRT_DEFERRED_MXU=1: dmxu and rowskip, :908-918; the
// sweep :1825-2001, called at :2169-2170; the flags :4296-4321, :4432),
// launched at :4872, which render_core builds on the streamed route's
// deferred visits (binned, or ordered from 4 clusters a world) without
// shadows and without the watertight decision. The walk is the streamed
// route's (raytrace_cuda.dmxu_route): the view's front-to-back order in
// shared memory with the occlusion early exit and the block's span and
// slab gates (K3 + K5), or the bin of the block's bin tile in device memory
// (K4); on render_body's blocks each visited cluster's rows land in a
// cp.async double buffer, two block barriers a gated position (the tile
// groups' staging is below). What differs is the sweep of a visited
// cluster. The TPU kernel forms the
// numerators of every slot for a pixel row as one product on its matrix
// unit, [10, cs]^T x [10, 4 * 128], block-diagonal over (d, d, d, 1), and
// takes the cluster's first minimum by an iota-min. Here each thread
// (pixel) sweeps every slot of the cluster, padding included (a padding
// slot fails through det = 0, which gives inv = 0 and t = 0): det = D . d,
// u = (A . d) / det, v = (Q . d) / det, t = t_num / det, each dot three
// products summed x, y, z (built --fmad=false), accepted on
// min(u, v) >= -eps, u + v <= 1 + eps, t > t_lo (per pixel in raster mode)
// and t < far; the cluster's first minimum (strict <: the lower slot keeps
// an exact tie) is merged into the running best with the port's tie rule
// (t < best_t || t == best_t && gi < best_gi), not the TPU kernel's strict
// <, so the frames are the index-order sweep's (render_resident_plain with
// dmxu), K5's and K4's, bit for bit. On prep rows (one camera, no shadows)
// the staged rows are the pack-time D, A, Q, t_num; on raw rows (more
// cameras a world) the block forms them in the staged buffer from v0, e1,
// e2 and its camera origin (:1876-1903), one thread a slot, and carries the
// winner's (u, v) to the resolve. With rowskip (the TPU tiling has more
// than one tile across: 256 wide and up; raytrace_cuda.dmxu_route) each
// warp, two image rows of the 16x16 block, skips a cluster whose row span
// (the route's spans: 16-row hull ordered, 8-row hull binned; any
// conservative span gives the same frames) misses its two rows: the gate is
// warp-uniform. The binned visit streams the rows unsorted (no row sort, no
// triangle ranges, as the JAX package turns tri_ranges off under dmxu). The
// resolve, shading and export are the streamed route's, and the 9-output
// mode's (:3664-3670, the JAX dmxu switch does not exclude it: t, z, idx,
// the material, uv and the normal, unmasked, for the epilogue). The raytrace
// entries have seeded twins (K9: best_t starts at min(seed, far)).
//
// The tile groups (the ordered visit's design for the card): a block is G
// groups of 256 threads (at most 4, 64 registers a thread), each walking one
// 16x16 tile of the block's share of a view at a time over one fill of the
// view's positions (K5's walk: the same order, gates, slack and exit
// threshold, so ops/walk_replay.dmxu_walk replays it), one named-barrier
// vote a gated position, cp.async.bulk staging of a visited cluster's 10
// stage rows (prep: D, A, Q, t_num; raw: v0, e1, e2, turned in place into the
// view's D, A, Q, t_num after the wait, one thread a slot, then the group's
// barrier) on two mbarrier'd buffers; the sweep reads D and t_num as float4
// over four slots and makes the four tests in slot order (prep_test's
// expressions), each warp's two rows gated on the span under rowskip; the
// cluster's first minimum merged with the lower-index tie rule.
//
// Bound on an H100 (either design: the same walk and tests): per (pixel,
// slot) test 28 FP32 operations (det 5, the guarded reciprocal 3, u 6, v 6,
// t 1, the acceptance and the minimum 7), on the raw rows 35 a block and slot
// for D, A, Q and t_num; the walk's gates as K5's. chip_smoke.py counts the
// tests for its inputs from ops/walk_replay.dmxu_walk. No wgmma: TF32 would
// round the numerators otherwise than the plain version does (a 3xTF32 split
// on the tensor cores is a later redesign, as for K12).

#define MRT_STREAMED_BODY_ONLY
#include "render_streamed.cu"

namespace {

// K11 on the ordered walk's tile groups (stream_body with DMXU), cold and
// seeded.
template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads * kStreamGroups, 1)
render_streamed_dmxu_groups_kernel(const RenderArgs a, const StreamArgs s, const int parts,
                                   const int rowskip) {
  stream_body<GEO, RASTER, TEX, false, true>(a, s, parts, nullptr, rowskip);
}

template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads * kStreamGroups, 1)
render_streamed_dmxu_groups_seeded_kernel(const RenderArgs a, const StreamArgs s,
                                          const int parts, const int rowskip,
                                          const float* __restrict__ seed) {
  stream_body<GEO, false, TEX, true, true>(a, s, parts, seed, rowskip);
}

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_streamed_dmxu_kernel(const RenderArgs a, const StreamArgs s, const int rowskip) {
  render_body<GEO, RASTER, TEX, true, false, false, false, true, true>(a, s, BinArgs{},
                                                                       nullptr, rowskip);
}

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_binned_dmxu_kernel(const RenderArgs a, const BinArgs b, const int rowskip) {
  render_body<GEO, RASTER, TEX, true, true, false, false, true, true>(
      a, StreamArgs{nullptr, nullptr}, b, nullptr, rowskip);
}

template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads)
render_streamed_dmxu_seeded_kernel(const RenderArgs a, const StreamArgs s,
                                   const float* seed, const int rowskip) {
  render_body<GEO, false, TEX, true, false, false, true, true, true>(a, s, BinArgs{}, seed,
                                                                     rowskip);
}

template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads)
render_binned_dmxu_seeded_kernel(const RenderArgs a, const BinArgs b, const float* seed,
                                 const int rowskip) {
  render_body<GEO, false, TEX, true, true, false, true, true, true>(
      a, StreamArgs{nullptr, nullptr}, b, seed, rowskip);
}

// The visit of a K11 launch: with b.bins the binned walk, else the ordered
// walk (s.order and s.spans); the row gate on or off; K9's seed (null: the
// cold entries); the ordered walk's plan (tile groups a block, 0 for
// render_body's 16x16 blocks, and blocks a view) and, for an occupancy query
// of its tile groups instead of a launch, where its four numbers go.
struct DmxuVisit {
  StreamArgs s;
  BinArgs b;
  int rowskip;
  const float* seed;
  int groups, parts;
  int* query;
};

// K11's launch of one variant, on its visit's grid and shared memory: prep
// and raw rows only (no shadow sweep, no watertight decision), raytrace and
// raster, the seeded entries raytrace only; the ordered walk on its tile
// groups unless its plan has none.
struct DmxuRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const DmxuVisit& x, int num_views,
                 cudaStream_t stream) {
    if constexpr (GEO != kGeoPrep && GEO != kGeoRaw) {
      return (int)cudaErrorInvalidValue;
    } else {
      const bool binned = x.b.bins != nullptr;
      if (!binned && x.groups != 0) {
        if (x.groups < 0 || x.groups > kStreamGroups || x.parts < 1 || a.CC > kClusterMask ||
            a.cluster_size >= (1 << (31 - kCountShift)))
          return (int)cudaErrorInvalidValue;
        const size_t smem = stream_smem<GEO, true>(a, x.groups);
        if (x.seed == nullptr)
          return stream_launch(render_streamed_dmxu_groups_kernel<GEO, RASTER, TEX>, x,
                               num_views, smem, stream, a, x.s, x.parts, x.rowskip);
        if constexpr (RASTER) {
          return (int)cudaErrorInvalidValue;  // K9 raytraces only
        } else {
          return stream_launch(render_streamed_dmxu_groups_seeded_kernel<GEO, TEX>, x,
                               num_views, smem, stream, a, x.s, x.parts, x.rowskip, x.seed);
        }
      }
      if (x.query != nullptr || x.groups != 0) return (int)cudaErrorInvalidValue;
      if (x.seed == nullptr) {
        if (binned)
          return launch_grid(render_binned_dmxu_kernel<GEO, RASTER, TEX>, a, num_views,
                             binned_smem<GEO>(a), stream, a, x.b, x.rowskip);
        return launch_grid(render_streamed_dmxu_kernel<GEO, RASTER, TEX>, a, num_views,
                           streamed_smem<GEO>(a), stream, a, x.s, x.rowskip);
      }
      if constexpr (RASTER) {
        return (int)cudaErrorInvalidValue;  // K9 raytraces only
      } else {
        if (binned)
          return launch_grid(render_binned_dmxu_seeded_kernel<GEO, TEX>, a, num_views,
                             binned_smem<GEO>(a), stream, a, x.b, x.seed, x.rowskip);
        return launch_grid(render_streamed_dmxu_seeded_kernel<GEO, TEX>, a, num_views,
                           streamed_smem<GEO>(a), stream, a, x.s, x.seed, x.rowskip);
      }
    }
  }
};

}  // namespace

extern "C" {

// Launches K11's variant (geo, raster, tex_filter) on `stream`, on the
// caller's current device, with mrt_render_binned's arguments but for the
// visit: with bins (and spans at 8-row bands) the binned walk, on
// render_body's 16x16 blocks, else order and spans (16-row bands) the
// ordered walk on `groups` tile groups a block (1-4) and `parts` blocks a
// view, or with groups 0 on render_body's 16x16 blocks (the parent design);
// seed (or null: the cold entries; raster must then be 0) as K9's; geo 0
// (prep rows) or 1 (raw rows); rowskip 1 gates each warp's two rows on the
// cluster's span; tex_filter 4 is the 9-output mode, written as in
// mrt_render_none. rows, cluster_size and S must keep every cluster's rows
// 16-byte aligned; on the tile groups CC below 65,536. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for an unknown variant, a
// missing input or a bad plan.
int mrt_render_dmxu(const float* rows, const float* clusters, const float* cams,
                    const float* mats, const int* pool, int n_mats, float* depth,
                    int* segmask, uint32_t* rgb, int* code, float* handoff,
                    const int* order, const int* spans, const int* bins, const float* seed,
                    int num_views, int num_cams, int S, int CC, int cluster_size, int n_cols,
                    int n_lights, int height, int width, int seg_div, float two_over_w,
                    float two_over_h, int raster, int tex_filter, int geo, int bins_x,
                    int bin_shift, int n_bins, int rowskip, int groups, int parts,
                    void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (clusters == nullptr || spans == nullptr || (order == nullptr) == (bins == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cluster_size % 4 != 0 || S % 4 != 0 || ((uintptr_t)rows & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const DmxuVisit x{StreamArgs{order, spans},
                    BinArgs{bins, spans, nullptr, bins_x, bin_shift, n_bins, 0},
                    rowskip,
                    seed,
                    groups,
                    parts,
                    nullptr};
  return launch_variant<DmxuRoute>(a, x, num_views, geo, raster, tex_filter,
                                   (cudaStream_t)stream);
}

// The ordered walk's tile-group entry (geo, raster, tex_filter, seeded):
// threads a block, registers, local memory bytes a thread and blocks a
// multiprocessor with `groups` tile groups (1-4) at CC clusters of
// cluster_size, n_cols camera columns and n_lights lights, in out[0..3].
// Returns 0, or the CUDA error of the query.
int mrt_render_dmxu_occupancy(int geo, int raster, int tex_filter, int seeded, int groups,
                              int CC, int cluster_size, int n_cols, int n_lights, int* out) {
  RenderArgs a{};
  a.CC = CC;
  a.cluster_size = cluster_size;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  if (groups < 1) return (int)cudaErrorInvalidValue;
  static const float kSeeded = 0.f;  // any non-null seed picks the seeded entry
  const DmxuVisit x{{}, BinArgs{}, 0, seeded ? &kSeeded : nullptr, groups, 1, out};
  return launch_variant<DmxuRoute>(a, x, 0, geo, raster, tex_filter, nullptr);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
