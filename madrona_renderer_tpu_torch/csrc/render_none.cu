// K1-none, the non-culled resident sweep, and the 9-output mode of K1 and
// K1-none: the render kernel's body (csrc/render_resident.cu, included
// below) with its own entry points, route and C interface in this
// translation unit, which builds beside the others, so that the older
// sources' entries keep their code.
//
// K1-none replaces madrona_renderer_tpu/ops/raytrace_pallas.py::
// _render_kernel in its non-culled variant (culled = cluster_size > 0 false,
// :885), launched at :4911, which render_core takes for accel="none" and,
// under accel="auto", for worlds of fewer than 16 triangles or a single
// cluster (use_clusters, :4040-4044). Per (view, 16x16 block) the world's
// geometry rows (prep: the pack-time D/A/Q/t_num; raw: v0/e1/e2 with the
// block's hoisted tv, q, t_num; K10: the block's a, b, c and the validity)
// and the camera row sit in shared memory, as K1's do, but there is no
// cluster table and no slab test: every thread tests every triangle of the
// world in index order, first minimum on t (strict <: the lowest index wins
// an exact tie), and with shadows every triangle per light. Every GEO,
// RASTER and TEX code of K1 has its entry here, and each raytrace variant
// its seeded twin (K9: best_t starts at min(seed, far), as the JAX
// non-culled launch takes the seed, :4911-4923). The frames are K1's, bit
// for bit (the culls only skip work), and the plain version is K1's:
// raytrace_cuda.render_resident_plain, which sweeps every triangle.
//
// The 9-output mode (TEX = kTexNine; the factory's shaded = False outputs,
// :3664-3670) writes the JAX kernel's unshaded outputs instead of rgb, for
// the scenes render_core does not shade in the kernel (textured pools past
// the in-kernel route's 16,384 texels or 128 materials without mip chains,
// :4065-4073): t (0 on a miss), z = t * cos, idx (-1 on a miss), the
// material, uv = uv0 + uc*duv1 + vc*duv2 and the normal flipped toward the
// viewer (zeros on a miss), unmasked; ops/shade.py::shade_lambert_planar
// shades them and ops/raytrace_ref.py::compute_lit traces their shadow rays
// in the epilogue (raytrace_cuda.frames_from_core, the JAX
// _frames_from_core :4962-5018). It runs on the prep, raw and K10 raw rows
// (no in-kernel shadow rays), through K1's culled index-order sweep
// (render_resident_*_nine) and K1-none's (render_none_*_nine), each seeded
// too; the culled visits' 9-output entries (K3 and K4 on resident rows,
// K3 + K5, K4 and K11, and their seeded twins) are their routes' own
// sources'. Its outputs take the mip hand-off's slots: t in depth, idx in
// segmask, the material in code and z, uv x, uv y and the normal in the six
// hand-off planes.
//
// Bound on an H100: K1's per-pixel work (ray generation, resolve, shading;
// the 9-output mode stops before the shading), and per thread every
// triangle test of the world (27 FP32 operations on prep rows, 36 raw,
// 43 watertight, the raw rows' hoisted terms once per block and triangle);
// shadows, per thread and light every shadow triangle test (52, of which
// the 17 that depend only on the light and the triangle are charged once a
// block). chip_smoke.py counts them for its inputs. The parent design is
// K1's: one thread per pixel, one 16x16 block a tile, the rows in shared
// memory, broadcast reads. On enough views K1-none on prep rows and on K10's
// rows, raytraced and cold, untextured or nearest or bilinear, takes the
// index visit's tile teams instead (raytrace_cuda.index_plan with culled
// False): one block a view, the records filled once a view (prep: D with
// t_num, A, Q; K10: a with the validity, b, c, each three float4), no
// cluster table, every team sweeping every slot for its tile, several
// pixels a thread (index_tile and wt_tile with CULL false, in
// csrc/render_resident.cu); so does K1's 9-output mode on prep rows
// (render_resident_nine_index_kernel: K1's records, cluster table and
// gates, index_tile's resolve writing the nine outputs, kNinePixels pixels
// a thread). The other modes keep the parent: the 9-output mode on raw and
// K10 rows and K1-none's, and every seeded or raster entry.

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_none_kernel(const RenderArgs a) {
  render_body<GEO, RASTER, TEX, false, false, false, false, false>(
      a, StreamArgs{nullptr, nullptr});
}

template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads)
render_none_seeded_kernel(const RenderArgs a, const float* seed) {
  render_body<GEO, false, TEX, false, false, false, true, false>(
      a, StreamArgs{nullptr, nullptr}, BinArgs{}, seed);
}

// K1's 9-output mode: the culled index-order sweep.
template <int GEO, bool RASTER>
__global__ void __launch_bounds__(kThreads)
render_resident_nine_kernel(const RenderArgs a) {
  render_body<GEO, RASTER, kTexNine, false>(a, StreamArgs{nullptr, nullptr});
}

template <int GEO>
__global__ void __launch_bounds__(kThreads)
render_resident_nine_seeded_kernel(const RenderArgs a, const float* seed) {
  render_body<GEO, false, kTexNine, false, false, false, true>(
      a, StreamArgs{nullptr, nullptr}, BinArgs{}, seed);
}

// K1's 9-output mode on the index visit's tile teams: prep rows, raytraced,
// cold; K1's records, cluster table and gates (index_tile), kNinePixels
// pixels a thread, 1 or 2 groups a block, a block a view; at most 64
// registers a thread, as K1's entries. Of 2 and 4 pixels, each at 64 and
// at up to 128 registers, 4 at 64 ran fastest: 2 pixels 10% and 4 at 78
// registers 8% slower (port_tools/index_plan_ab.py on an H100).
constexpr int kNinePixels = 4;

__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 4 / kIndexMaxGroups)
render_resident_nine_index_kernel(const RenderArgs a) {
  visit_body<kGeoPrep, false, kTexNine, false, false, kNinePixels>(a, nullptr, BinArgs{},
                                                                    nullptr);
}

// The 9-output team entry (geo 0) at `groups` groups a block (with
// `query`, its occupancy instead of a launch).
int nine_index_variant(const RenderArgs& a, int num_views, int geo, int groups, int* query,
                       cudaStream_t stream) {
  if (groups < 1 || groups > kIndexMaxGroups || geo != kGeoPrep) return (int)cudaErrorInvalidValue;
  return index_entry(render_resident_nine_index_kernel, index_smem<kGeoPrep>(a), num_views,
                     groups, query, stream, a);
}

// K1-none on the index visit's tile teams: prep rows (kNonePixels pixels a
// thread) and K10's rows (kWtPixels, as K10's), raytraced, cold;
// untextured, nearest or bilinear; 1 or 2 groups a block, a block a view;
// at most 64 registers a thread, as K1's and K10's entries.
template <int TEX>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 4 / kIndexMaxGroups)
render_none_index_kernel(const RenderArgs a) {
  visit_body<kGeoPrep, false, TEX, false, false, kNonePixels, kMipNearest, false>(
      a, nullptr, BinArgs{}, nullptr);
}

template <int TEX>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 4 / kIndexMaxGroups)
render_none_index_wt_kernel(const RenderArgs a) {
  visit_body<kGeoRawWt, false, TEX, false, false, kWtPixels, kMipNearest, false>(
      a, nullptr, BinArgs{}, nullptr);
}

template <int GEO, int TEX>
int none_index_launch(const RenderArgs& a, int num_views, int groups, int* query,
                      cudaStream_t stream) {
  if constexpr (GEO == kGeoRawWt)
    return index_entry(render_none_index_wt_kernel<TEX>, index_smem<GEO>(a), num_views, groups,
                       query, stream, a);
  else
    return index_entry(render_none_index_kernel<TEX>, index_smem<GEO>(a), num_views, groups,
                       query, stream, a);
}

template <int GEO>
int none_index_tex(const RenderArgs& a, int num_views, int tex_filter, int groups, int* query,
                   cudaStream_t stream) {
  switch (tex_filter) {
    case kTexNone:
      return none_index_launch<GEO, kTexNone>(a, num_views, groups, query, stream);
    case kTexNearest:
      return none_index_launch<GEO, kTexNearest>(a, num_views, groups, query, stream);
    case kTexBilinear:
      return none_index_launch<GEO, kTexBilinear>(a, num_views, groups, query, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The teams' entry (geo 0 or 3) at `groups` groups a block (with `query`,
// its occupancy instead of a launch).
int none_index_variant(const RenderArgs& a, int num_views, int geo, int tex_filter, int groups,
                       int* query, cudaStream_t stream) {
  if (groups < 1 || groups > kIndexMaxGroups) return (int)cudaErrorInvalidValue;
  if (geo == kGeoPrep)
    return none_index_tex<kGeoPrep>(a, num_views, tex_filter, groups, query, stream);
  if (geo == kGeoRawWt)
    return none_index_tex<kGeoRawWt>(a, num_views, tex_filter, groups, query, stream);
  return (int)cudaErrorInvalidValue;
}

// A launch's choice: K1's culled sweep (9-output mode only) or K1-none,
// and K9's seed (null: cold).
struct NoneArgs {
  const float* seed;
  bool culled;
};

// One variant on K1's grid and shared memory (without the cluster table
// when not culled: CC is 0 there); K1's culled sweep only in the 9-output
// mode (its other entries are csrc/render_resident.cu's and
// csrc/render_seeded.cu's).
struct NoneRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const NoneArgs& v, int num_views,
                 cudaStream_t stream) {
    const size_t smem = resident_smem<GEO>(a);
    if constexpr (RASTER) {
      if (v.seed != nullptr) return (int)cudaErrorInvalidValue;  // K9 raytraces only
      if (!v.culled)
        return launch_grid(render_none_kernel<GEO, true, TEX>, a, num_views, smem, stream, a);
      if constexpr (TEX == kTexNine)
        return launch_grid(render_resident_nine_kernel<GEO, true>, a, num_views, smem,
                           stream, a);
      return (int)cudaErrorInvalidValue;
    } else {
      if (!v.culled) {
        if (v.seed == nullptr)
          return launch_grid(render_none_kernel<GEO, false, TEX>, a, num_views, smem, stream,
                             a);
        return launch_grid(render_none_seeded_kernel<GEO, TEX>, a, num_views, smem, stream,
                           a, v.seed);
      }
      if constexpr (TEX == kTexNine) {
        if (v.seed == nullptr)
          return launch_grid(render_resident_nine_kernel<GEO, false>, a, num_views, smem,
                             stream, a);
        return launch_grid(render_resident_nine_seeded_kernel<GEO>, a, num_views, smem,
                           stream, a, v.seed);
      }
      return (int)cudaErrorInvalidValue;
    }
  }
};

}  // namespace

extern "C" {

// Launches K1-none (culled 0) or K1's culled index-order sweep (culled 1,
// the 9-output mode only) in the variant (geo, raster, tex_filter) on
// `stream`, on the caller's current device, seeded by `seed` ([num_views,
// height, width] f32, K9; raytrace variants only) unless it is null, with
// mrt_render_resident's arguments but for the visit (clusters may be null
// and CC 0 when not culled). tex_filter 4 is the 9-output mode (geo 0, 1 or
// 3): t in depth, idx in segmask, the material in code, and z, uv x, uv y,
// nx, ny, nz in the six planes of handoff. groups 0: the parent design (one
// 16x16 block a tile, every variant); 1 or 2: the index visit's tile teams,
// a block a view, raster 0 and no seed: K1-none (culled 0, geo 0 or 3,
// tex_filter 0, 1 or 2; CC 0) or K1's 9-output mode (culled 1, geo 0,
// tex_filter 4). Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for an unknown variant or plan.
int mrt_render_none(const float* rows, const float* clusters, const float* cams,
                    const float* mats, const int* pool, int n_mats, float* depth,
                    int* segmask, uint32_t* rgb, int* code, float* handoff,
                    const float* seed, int num_views, int num_cams, int S, int CC,
                    int cluster_size, int n_cols, int n_lights, int height, int width,
                    int seg_div, float two_over_w, float two_over_h, int raster,
                    int tex_filter, int geo, int culled, int groups, void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (culled && clusters == nullptr) return (int)cudaErrorInvalidValue;
  if (groups == 0)
    return launch_variant<NoneRoute>(a, NoneArgs{seed, culled != 0}, num_views, geo, raster,
                                     tex_filter, (cudaStream_t)stream);
  if (raster || seed != nullptr) return (int)cudaErrorInvalidValue;
  if (culled) {
    if (tex_filter != kTexNine) return (int)cudaErrorInvalidValue;
    return nine_index_variant(a, num_views, geo, groups, nullptr, (cudaStream_t)stream);
  }
  if (CC != 0) return (int)cudaErrorInvalidValue;
  return none_index_variant(a, num_views, geo, tex_filter, groups, nullptr,
                            (cudaStream_t)stream);
}

// K1-none's team entry (geo, tex_filter, groups) at these sizes: threads a
// block, registers, local memory bytes a thread and blocks a
// multiprocessor, in out[0..3]. Returns 0, or the CUDA error of the query.
int mrt_render_none_occupancy(int geo, int tex_filter, int groups, int S, int n_cols,
                              int n_lights, int* out) {
  RenderArgs a{};
  a.S = S;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  return none_index_variant(a, 0, geo, tex_filter, groups, out, nullptr);
}

// K1's 9-output team entry (geo 0) at these sizes, as
// mrt_render_none_occupancy's.
int mrt_render_none_nine_occupancy(int geo, int groups, int S, int CC, int n_cols, int n_lights,
                                   int* out) {
  RenderArgs a{};
  a.S = S;
  a.CC = CC;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  return nine_index_variant(a, 0, geo, groups, out, nullptr);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
