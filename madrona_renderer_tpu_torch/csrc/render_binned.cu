// K4 and K11 on the streamed binned visit on prep rows (one camera a world,
// no shadows: the binned paths'), on tile groups: the binned walk of
// csrc/render_resident.cu's bin_body (included below, with its variant
// dispatch), with its own entry points, route, launch plan and C interface
// in this translation unit, which builds beside the others. K4's and K11's
// seeded twins (K9) are here too. The entries on raw and K10 rows and the
// shadow sweeps', and the parent design every entry here is held to, are
// render_body's 16x16 blocks: csrc/render_binned_blocks.cu (K4),
// csrc/render_seeded.cu (K4 seeded) and csrc/render_dmxu.cu (K11's binned
// visit, cold and seeded), whose sources stay as they were, so that their
// other entries keep their code. On raw and K10 rows the tile groups ran
// 0.8-9% slower than those blocks on 64 worlds of the varied big-mesh
// terrain (two cameras the worst), K11 on raw rows 3.6% slower to 17%
// faster (an H100; PERF.md §6): those rows keep them.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel,
// launched at :4872, in its binned variant on 2D tiles with per-band
// triangle ranges (K4: binned, tri_ranges, tri_tie: :1796-1800,
// :2222-2660, :2681-2691; the bins :4762-4810) and its dmxu variant on the
// binned visit (K11: MRT_DEFERRED_MXU=1, dmxu and rowskip, :908-918, the
// sweep :1825-2001), with the factory's other switches as
// csrc/render_resident.cu's header sets them out (GEO: prep; RASTER; TEX:
// none, nearest, bilinear, the mip hand-off and the 9-output mode), and
// K9's seed (seeded, :1064-1069, :1205-1209).
//
// What it computes, per (view, pixel): K1's ray, then the walk of the bin of
// the bin tile its 16x16 tile lies in (bins [W*C, n_bins, 1 + CC]: the
// count, then the cluster ids front to back, raytrace_cuda.
// band_cluster_bins at a square tile of 16 * 2^bin_shift pixels): the walk
// stops at the first cluster that is invalid or that no pixel of the tile
// can reach (best_t^2 <= 0.998 * approach distance^2, :1740-1780), skips
// one whose 8-row-band span misses the tile's rows or whose slab test
// (tmin * 0.999 < best_t) no ray of the tile passes, and sweeps the rest.
// K4 (the rows row-sorted per cluster: rows 0-9 permuted, row 10 the
// original index) sweeps, in each 8-row band of the tile where the span
// touches it, the sorted lanes [lo, hi) of the band (ranges [W, CC,
// n_bands]). K11 sweeps every slot (unsorted rows) and merges the
// cluster's first minimum; with rowskip each warp's two rows are gated on
// the span. Exact-t ties go to the lower triangle index (K4: the lower
// original index), so the
// frames are the index-order sweep's (raytrace_cuda.render_resident_plain),
// bit for bit, and the positions walked are those of
// ops/walk_replay.binned_walk / dmxu_walk.
//
// The design (bin_body, bin_tile). A block is G groups of 256 threads
// (blockDim (16, 16 G), at most 4: 64 registers a thread); a group walks one
// 16x16 tile at a time. A view's bin tiles are dealt to its B blocks by
// turns (block b takes b, b + B, ...: the costly rows spread over the
// blocks), and a block's groups take the tiles of its bin tiles, one bin
// tile after another, from a shared counter, so that the tiles of a 32-px
// bin tile (512x512) go to one block (raytrace_cuda.binned_plan: G and B,
// binned_tiles: the tiles a block takes). Each group holds kBinChunk (256)
// positions of its tile's bin at a time, 10 words a position as the
// streamed ordered walk's (PosHead: the exit threshold, the row span, the
// cluster id with its valid count; the AABB less the camera origin), written
// by its threads, one a position, when the walk first reaches the chunk: a
// gate reads its terms from shared memory with no chain of device-memory
// loads. The exit test takes the group's largest best_t^2, which holds
// until a sweep, so a position whose row gate fails needs no barrier; the
// others take one named-barrier vote of the group (exit and slab test
// together). Staging is stream_walk's: one cp.async.bulk a row onto two
// mbarrier'd buffers per group, the parity carried across tiles, prep rows
// with row 10. The prep sweeps (K4's lanes, K11's slots) read D and t_num
// as float4 over four lanes and make the four tests in lane order. The
// block holds the head, the groups' buffers and records and the camera row:
// 384 + 4 * (2 G rows cs + 2560 G + columns) bytes, whatever the cluster
// count.
//
// Bound on an H100: the parent design's (chip_smoke.py's k4 and dmxu
// bounds from ops/walk_replay.binned_walk / dmxu_walk's work for its
// inputs: per gated position the slab test, per swept lane 29 FP32
// operations, per K11 (pixel, slot) test 28), which this design leaves as it
// was: the same walk.

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

template <bool RASTER, int TEX, bool DMXU>
__global__ void __launch_bounds__(kThreads * kStreamGroups, 1)
render_binned_kernel(const RenderArgs a, const BinArgs b, const int parts, const int rowskip) {
  bin_body<RASTER, TEX, false, DMXU>(a, b, parts, nullptr, rowskip);
}

// K9's entries of this route: the raytrace variants, seeded.
template <int TEX, bool DMXU>
__global__ void __launch_bounds__(kThreads * kStreamGroups, 1)
render_binned_seeded_kernel(const RenderArgs a, const BinArgs b, const int parts,
                            const int rowskip, const float* __restrict__ seed) {
  bin_body<false, TEX, true, DMXU>(a, b, parts, seed, rowskip);
}

// A launch's visit inputs, K9's seed (null: the cold entries), K11's switch
// and row gate, its plan (tile groups a block, blocks a view) and, for an
// occupancy query instead of a launch, where its four numbers go.
struct BinnedLaunch {
  BinArgs b;
  const float* seed;
  int dmxu, rowskip;
  int groups, parts;
  int* query;
};

template <bool RASTER, int TEX, bool DMXU>
int launch_binned(const RenderArgs& a, const BinnedLaunch& x, int num_views,
                  cudaStream_t stream) {
  const size_t smem = bin_smem<DMXU>(a, x.groups);
  if (x.seed == nullptr)
    return stream_launch(render_binned_kernel<RASTER, TEX, DMXU>, x, num_views, smem, stream, a,
                         x.b, x.parts, x.rowskip);
  if constexpr (RASTER) {
    return (int)cudaErrorInvalidValue;  // K9 raytraces only
  } else {
    return stream_launch(render_binned_seeded_kernel<TEX, DMXU>, x, num_views, smem, stream, a,
                         x.b, x.parts, x.rowskip, x.seed);
  }
}

// The route's launch of one variant (or its occupancy query): K4 and K11
// on prep rows (the other rows' entries are render_body's blocks').
struct BinnedRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const BinnedLaunch& x, int num_views,
                 cudaStream_t stream) {
    if (x.groups < 1 || x.groups > kStreamGroups || x.parts < 1)
      return (int)cudaErrorInvalidValue;
    if constexpr (GEO != kGeoPrep) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (x.dmxu) return launch_binned<RASTER, TEX, true>(a, x, num_views, stream);
      return launch_binned<RASTER, TEX, false>(a, x, num_views, stream);
    }
  }
};

}  // namespace

extern "C" {

// Launches the binned variant (raster, tex_filter on prep rows, geo 0;
// K11's with dmxu 1) on `stream`, on the caller's current device, seeded by
// `seed`
// ([num_views, height, width] f32, K9; raytrace variants only) unless it is
// null, with mrt_render_resident's arguments and the visit's: bins
// [num_views, n_bins, 1 + CC], spans [num_views, 2, CC] at 8-row bands and,
// under K4 (dmxu 0) and only then, ranges [W, CC, n_bands, 2]; the bin of
// tile (tx, ty) is (ty >> bin_shift) * bins_x + (tx >> bin_shift); rowskip 1
// gates each warp's two rows on the span (K11); the plan: `groups` tile
// groups a block (1-4) and `parts` blocks a view. tex_filter 4 is the
// 9-output mode, written as in mrt_render_none. The stage copies move whole rows of a cluster: rows
// must be 16-byte aligned and S and cluster_size multiples of 4; CC below
// 65,536. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unknown variant, a missing input or a bad
// plan, or cudaErrorMisalignedAddress.
int mrt_render_binned(const float* rows, const float* clusters, const float* cams,
                      const float* mats, const int* pool, int n_mats, float* depth,
                      int* segmask, uint32_t* rgb, int* code, float* handoff,
                      const int* bins, const int* spans, const int* ranges, const float* seed,
                      int num_views, int num_cams, int S, int CC, int cluster_size, int n_cols,
                      int n_lights, int height, int width, int seg_div, float two_over_w,
                      float two_over_h, int raster, int tex_filter, int geo, int bins_x,
                      int bin_shift, int n_bins, int n_bands, int dmxu, int rowskip,
                      int groups, int parts, void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (clusters == nullptr || bins == nullptr || spans == nullptr ||
      (ranges == nullptr) != (dmxu != 0) || CC > kClusterMask ||
      cluster_size >= (1 << (31 - kCountShift)))
    return (int)cudaErrorInvalidValue;
  if (cluster_size % 4 != 0 || S % 4 != 0 || ((uintptr_t)rows & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const BinnedLaunch x{BinArgs{bins, spans, reinterpret_cast<const int2*>(ranges), bins_x,
                               bin_shift, n_bins, n_bands},
                       seed, dmxu, rowskip, groups, parts, nullptr};
  return launch_variant<BinnedRoute>(a, x, num_views, geo, raster, tex_filter,
                                     (cudaStream_t)stream);
}

// The variant's (geo, raster, tex_filter, seeded, dmxu) threads a block,
// registers, local memory bytes a thread and blocks a multiprocessor with
// `groups` tile groups at clusters of cluster_size, n_cols camera columns
// and n_lights lights, in out[0..3]. Returns 0, or the CUDA error of the
// query.
int mrt_render_binned_occupancy(int geo, int raster, int tex_filter, int seeded, int dmxu,
                                int groups, int cluster_size, int n_cols, int n_lights,
                                int* out) {
  RenderArgs a{};
  a.cluster_size = cluster_size;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  static const float kSeeded = 0.f;  // any non-null seed picks the seeded entry
  const BinnedLaunch x{BinArgs{}, seeded ? &kSeeded : nullptr, dmxu, 0, groups, 1, out};
  return launch_variant<BinnedRoute>(a, x, 0, geo, raster, tex_filter, nullptr);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
