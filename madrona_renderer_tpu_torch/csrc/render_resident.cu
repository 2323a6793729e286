// K1 / K1-raw / K8 / K10 / K2 / K6, and K7 (folded, or its first launch): resident,
// cluster-culled, shaded ray-cast with the fused export, on prep or raw
// geometry rows, with the Möller–Trumbore or the watertight decision, with
// or without shadow rays, in its raytrace and raster conventions,
// untextured, textured, or handing mip-mapped texturing on. The body
// (render_body) also walks K11 on the streamed ordered visit and the
// streamed binned visit's parent design (K4, K11 and their K9 twins on one
// 16x16 block a tile: the binned entries on raw and K10 rows and the
// shadow sweeps', and the reference of the tile groups), built in their
// own sources; the streamed ordered walk (K3 + K5) and the binned walk on
// tile groups (K4 and K11 on prep rows: bin_body, below, built by
// csrc/render_binned.cu) have bodies of their own.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its resident culled shaded variant (defer_attrs, fused_export), launched
// at raytrace_pallas.py:4872, together with three of that factory's
// switches:
//   GEO: prep (K1: prep=True, uv_defer=True, the one-camera scenes without
//     shadows) or raw (K1-raw: prep off, uv_defer off — more than one
//     camera per world, or shadows, :4342-4355). The raw sweep reads the
//     v0 / e1 / e2 rows and this view's camera origin: tv = o - v0,
//     q = tv x e1, t_num = e2 . q (:1342-1348, once per block here), then
//     per pixel p = d x e2, det = e1 . p and u, v, t (:1373-1380), and
//     carries the winner's (u, v) (:1461-1467, resolved clipped at
//     :2739-2742). raw_shadows (K8, shadows=True) adds, after the resolve,
//     one cluster-culled any-hit sweep per directional light from the hit
//     point (:2847-2999), an occluded light adding nothing to the lambert
//     sum (:3030-3032, :3181-3182);
//     raw_wt and raw_wt_shadows (K10, watertight=True, :1235-1273,
//     :1382-1435; flags :4425-4436) sweep the raw rows with the Woop
//     decision instead (ops/watertight.py): per pixel the shear frame
//     (kz = argmax |d|, first maximum, kx and ky cyclic, reciprocal-multiply
//     shears: struct Shear), per triangle a = v0 - o, b = a + e1, c = a + e2
//     (once per block here) sheared, the three 2D edge functions u, v, w,
//     det = u + v + w, t = (u az + v bz + w cz) * (1/det), and acceptance
//     when the edge functions are all >= 0 or all <= 0, det != 0, the
//     pack's validity row 9 > 0, t > t_lo and t < best_t. The winner's
//     Möller–Trumbore (u, v), which the JAX sweep carries, are recomputed
//     from its raw rows in the resolve (the same expressions on the same
//     values: the same bits); the shadow rays stay Möller–Trumbore;
//   RASTER (K2, raster_clip=True): per-pixel t_lo = near / max(cosf, 1e-6)
//     (:1190-1196), depth = z = t * cosf (:2807), the z-far clip against
//     camera column 16 (:2819-2821, :3037-3039), segmask -1 everywhere
//     (_frames_from_core with_segmask=False, :4962-4975);
//   TEX (K6, textured=True): the winner resolve gathers the material and
//     uv = uv0 + uc*duv1 + vc*duv2 (:2784-2787) instead of the premultiplied
//     colour, and the shading samples the packed texel pool with nearest or
//     bilinear filtering (:3051-3202). TEX = mip (K7, tex_paged=True, the
//     scenes baked with mip chains) resolves the material, uv and texel
//     density (:2789-2796) and writes, instead of rgb, a per-pixel hand-off
//     for csrc/shade_mip.cu, which picks each pixel's mip level, applies the
//     per-tile window clamp and samples (:3203-3663): the material and the
//     hit flags, uv, the footprint t * (2/height) * tan_y * density (:3237)
//     and the three lambert sums (shadows applied). TEX = nine (the
//     factory's shaded = False outputs, :3664-3670, for the textured pools
//     render_core does not shade in the kernel) stops before the shading
//     and writes t, z, idx, the material, uv and the normal, unmasked, for
//     the epilogue (raytrace_cuda.frames_from_core); every culled visit has
//     it, each route in its own source (K1's and K1-none's in
//     csrc/render_none.cu).
// The plain PyTorch version is ops/raytrace_cuda.py::render_resident_plain;
// both compute the same expressions in the same order, so with --fmad=false
// (no mul+add contraction) and IEEE divide/sqrt the two agree bit for bit.
//
// What it computes, per (view, pixel):
//   1. ray generation from the camera row (origin, right/fwd/up, tan_x,
//      tan_y, near, far);
//   2. one AABB slab test per cluster, skipped for the whole block when no
//      thread of it can hit (block-wide OR, as the TPU kernel's jnp.any over
//      its tile — a per-pixel cull could drop an _EPS_BARY edge hit that
//      the reference keeps);
//   3. the Möller–Trumbore sweep over the cluster's valid prefix (prep:
//      the pack-time D/A/Q/t_num rows; raw: the pvec test), first-min on t
//      (strict <, ascending index: the lowest index wins exact ties, as
//      argmin does);
//   4. the winner's (u, v) (prep: recomputed from the same rows; raw: the
//      carried values), its normal (and, textured, its material and uv)
//      interpolated from the attribute rows, the normal flipped toward the
//      viewer;
//   5. raw_shadows: per light, from p = o + t*d (t = 0 on a miss) toward
//      -dir, the shadow ray's slab test per cluster (tmax > 0, skipped for
//      the whole block when no thread that is still unoccluded passes) and
//      the any-hit test against t > 1e-3 * (1 + t);
//   6. two-sided lambert + ambient 0.2 summed over the lights, times the
//      base colour (the premultiplied colour row, or the material colour
//      times the texel), RGBA8 packed;
//   7. the export masks: depth = t (raster: z) or 0, segmask = idx / T
//      (raster: -1) or -1, invalid camera → opaque black.
// Degenerate and padding triangles fail through inv = 0 → t = 0, in the
// primary sweep (t > t_lo > 0) and the shadow sweep (t > eps > 0).
//
// Layout (all f32 unless noted):
//   rows     [W, 40, S]   split pack: rows 0-9 prep D(3) A(3) Q(3) t_num or
//                         rows 0-9 raw v0(3) e1(3) e2(3) valid, rows 16-35
//                         attributes (uv0, duv1, duv2, n0, dn1, dn2, mat,
//                         premultiplied colour rgb, density)
//   clusters [W, 8, CC]   lo.xyz, hi.xyz, valid, valid-prefix count
//   cams     [W*C, NCOL]  see raytrace_cuda._pack_cams; view v belongs to
//                         world v / C and takes its origin from its own row
//   mats     [6, M]       textured only: colour rgb, texel offset, width,
//                         height of each material's texture (exact in f32)
//   pool     i32 [texels] textured only: r | g << 8 | b << 16 of each texel
//   depth    [W*C, H, Wd] f32, segmask i32, rgb packed u32 — the final
//                         layout, written directly.
//   code     i32 [W*C, H, Wd], handoff f32 [6, W*C, H, Wd] — the mip
//                         hand-off, written instead of rgb (28 B a pixel).
//
// Bound on an H100: FP32 work per pixel is about 110 operations for ray
// generation, resolve and shading (textured: some 30 more for the sample,
// bilinear about 60 more), 25 per cluster slab test and per visited
// triangle 27 (prep) or 36 (raw, with tv, q and t_num hoisted to 17 per
// block and triangle) or, watertight, about 50 (the shear 15, its selects
// 18, the edge functions 9, det 2, the signs 6, t 6 and the reciprocal, on
// the block's a, b, c; the winner's pvec (u, v) once per pixel); shadows
// add 24 per light and cluster and 52 per
// triangle the shadow sweep visits, of which the pvec, det and 1/det (17)
// depend only on the light and the triangle: the work needs them once per
// block, though each thread computes them. Each is its own instruction
// under --fmad=false (so against half the published 67 TFLOP/s); the writes are
// 12 B per pixel (about 200 MB per step at 4096 views x 64x64; in the mip
// hand-off mode 36 B, about 600 MB, of which K7's function, folded or not,
// needs the 12 B of depth, segmask and rgb).
// chip_smoke.py works out the exact counts for its inputs. The texel pool
// (at most 128 x 128 texels, 64 KB) stays in L1/L2: a texel read is one
// cached 4-byte load (bilinear: four).
//
// The parent design (render_body, below) is the simple one: one thread per
// pixel, one 16x16 block per (view, tile), the world's geometry rows (raw:
// with this view's hoisted
// tv, q, t_num), cluster rows and camera row in shared memory (broadcast
// reads in the sweeps), the winner's attributes, the material row and the
// texels read from global memory once per pixel. No wgmma or TMA: the work
// is scalar per pixel. The three switches and the route (STREAM) are
// template parameters, so each of this file's 40 variants compiles to its
// own kernel with no runtime branch on them. K10's block keeps 10 rows per triangle in
// shared memory (a, b, c and the validity: 120 KB at the budget's 3,072
// triangles, where K1-raw's 16 rows take 192 KB); its resolve and its
// shadow sweep read the raw rows from global memory (L1/L2). The resident
// visits (K3 and K4 on resident rows, below) fill a block's rows once a
// view and walk several tiles in it, and so does K1 (and K6) on prep rows,
// raytraced, untextured or nearest or bilinear (visit_body with PIX > 0,
// index_tile: tile teams of 64 threads, 4 pixels
// a thread, records of three float4 a triangle; render_index_kernel, taken
// by raytrace_cuda.index_plan), bit for bit the parent's, and so do two
// more modes: K7 folded (TEX = mip on the teams, its entry in
// csrc/render_mip.cu: the teams hold each pixel's winner in shared memory;
// after a block barrier mip_keys lowers each TPU tile's window keys there,
// after another mip_pass samples every pixel of the view; one launch where
// the parent design takes the hand-off and csrc/shade_mip.cu) and K8
// (shadow_tile, render_index_shadows_kernel: records of four float4 a
// triangle, the raw sweep's e1, e2 and the view's tv, q, t_num with v0, and
// each (light, triangle)'s shadow pvec and 1/det, formed once a view, so
// that the shadow test makes only the hit point's terms), K10 raytraced
// and cold (wt_tile, render_index_wt_kernel: records of three float4 a
// triangle, a with the validity, b and c, formed once a view; each pixel's
// shear frame once a tile), and K1-none on prep and K10 rows (the same
// tiles without the cluster gates, every slot of the world swept; its
// entries in csrc/render_none.cu), K1's 9-output mode on prep rows
// (index_tile's resolve writing the nine outputs; its entry in
// csrc/render_none.cu) and K1-raw (shadow_tile without its shadow sweep,
// render_index_raw_kernel: K8's records, each view's own tv, q, t_num
// formed once a view, so that four cameras a world form four views' terms)
// and K1's raster conventions on prep rows (K2, K2+K6: index_tile with each
// pixel's t-space near bound, render_index_raster_kernel).
// The other modes keep this design.
//
// The streamed route (STREAM): meshes whose rows do not fit the resident
// budget (32 * S * 4 bytes > 384 KB, the JAX package's dma_tris,
// :4265-4266). Its ordered visit (K3 + K5, the same factory's ordered,
// :1755-1785, deferred / dma_tris / prep-stream / band_gates sweep,
// :1787-2680) is csrc/render_streamed.cu's: one fill of the view's
// positions a block, tile groups on named barriers, bulk-copy staging.
// render_body's STREAM branch walks the same order with the same gates for
// K11 (csrc/render_dmxu.cu) and, through BINNED, each bin (the binned
// visit's parent design, below): per 16x16 block the walk stops at the
// first cluster that is invalid or that no pixel can reach
// (best_t^2 <= 0.998 * approach distance^2,
// :1740-1780), skips a cluster whose row span misses the block's rows or
// whose slab test no ray passes, and sweeps the rest from a double buffer
// that cp.async fills with the next candidate's geometry rows (10 prep
// rows, 9 raw rows plus the block's tv, q, t_num per staged triangle, or,
// watertight, the 10 raw rows turned in place into the block's a, b, c and
// the validity) while the current one is swept (walk_clusters). Exact-t
// ties go to the lower triangle index (t < best_t || t == best_t &&
// i < best_i), and the slab test passes tmin * 0.999 < best_t, so a
// cluster holding a triangle that ties the best hit is visited whatever
// the order: the frames are the index-order sweep's
// (render_resident_plain), bit for bit. The winner's (u, v) and attributes
// are resolved once, after the walk, from global memory; the shadow sweep
// (raw_shadows) walks every cluster in index order with its slab test and
// stages each visited cluster's raw rows the same way.
//
// The binned visit (K4): the same walk over the bin of the bin tile the
// tile lies in (raytrace_cuda.band_cluster_bins), its cluster ids front to
// back, instead of the view's whole order. Its parent design (BINNED,
// built by csrc/render_binned_blocks.cu, K4's seeded twins by
// csrc/render_seeded.cu, K11's by csrc/render_dmxu.cu): the walk's
// pointers to the order, the spans (at 8-row bands) and the cluster table
// point into device memory (every thread of a gate reads the same word),
// so the block's shared memory is the two stage buffers and the camera
// row; the route's raw, K10 and shadow rows launch it. Its design on tile
// groups (bin_body, built by csrc/render_binned.cu for K4 and K11 on prep
// rows, cold and seeded): G groups of 256 threads a block walk the tiles of the block's
// bin tiles, each group with its own records of 256 positions of its
// tile's bin in shared memory (the exit threshold, the 8-row span, the
// cluster id and count, the AABB less the camera origin), one named-barrier
// vote a gated position and bulk-copy staging (stream_walk, below). On
// prep rows the staged rows are row-sorted (row 10: the original index gi);
// each of the block's two 8-row bands (threads row-major: warps 0-3 and
// 4-7, so its gates are warp-uniform) sweeps, where the cluster's span
// touches the band, only the sorted lanes [lo, hi) of its image band
// (raytrace_cuda.cluster_row_sort), ties to the lower gi
// (t < best_t || t == best_t && gi < best_gi); the resolve reads the
// winner's prep rows at its sorted lane and its attributes at gi. A band
// below the image sweeps nothing and starts at best_t = 0, so it never
// holds the walk open. The tile groups sweep the same lanes, D and t_num
// read as float4 over four lanes.
//
// The resident visits (K3 and K4 on resident rows, visit_body, built by
// csrc/render_resident_ordered.cu and csrc/render_resident_binned.cu, each
// including this file and bringing its own entry point): the JAX factory's
// ordered and binned sweeps over the resident SMEM rows (:2681-2699; perm
// :4819-4832, bins :4762-4810), walking the view's front-to-back order (in
// shared memory) or the bin of the tile's bin tile (in device memory, as K4
// reads it) with the streamed walk's early exit and slab slack, but with no
// row gate and no staging: a visited cluster's valid prefix is swept from
// the shared rows, exact-t ties to the lower triangle index. One block a
// view: the world's geometry rows (one bulk asynchronous copy completing on
// an mbarrier; raw rows with the view's tv, q, t_num, K10's a, b, c and
// validity, formed once a view), the cluster table, the gate terms (each
// cluster's AABB relative to the view's camera origin and its early-exit
// threshold), the camera row and the order are filled once, and G groups of
// 256 threads (visit_groups) each take the view's 16x16 tiles from a shared
// counter and walk them, every gate over the group's own threads (a named
// barrier each), so one tile's barriers and shared loads overlap another's
// tests.
//
// K11 (the factory's dmxu / rowskip switches, :908-918, :1825-2001; DMXU,
// a template switch of the streamed route's two visits, built by
// csrc/render_dmxu.cu on render_body's blocks, the ordered visit's and the
// binned parent design's, and by csrc/render_binned.cu on the binned walk's
// tile groups, each bringing its own entry point): the walk and its
// staging as above, but a visited cluster's every
// slot is swept, padding included (a padding slot fails through det = 0),
// on prep rows or on the cluster's D, A, Q and t_num formed in the staged
// buffer for the block's camera from its raw rows; each thread takes the
// cluster's first minimum (ties to the lower slot) and merges it into its
// running best with the lower-index tie rule; with rowskip each warp (two
// pixel rows of the block) skips a cluster whose row span misses its rows.
// The tile groups read each cluster's D and t_num as float4 over four
// slots and make the four tests in slot order.
//
// K9 (the factory's seeded switch, :1064-1069, :1205-1209; SEEDED, a
// template switch of the raytrace variants of every route, each an entry of
// its own beside the cold one, whose code stays as it was: a runtime
// pointer in every entry moved 29 of the older entries' times past 1.5% on
// an H100 (port_tools/tree_ab.py);
// this file's routes' and the binned parent design's seeded entries build in
// csrc/render_seeded.cu, the other visits' in their own sources):
// with a seed ([W*C, H, Wd] f32) each pixel's best_t starts at
// min(seed, far) instead of far; a thread past the image edge starts at 0
// (the TPU's padding lanes, _pack_seed_tiles :3968-3972), so it accepts
// nothing and never holds a walk's exit back. A hit at exactly the seed is
// a miss: the strict test t < best_t rejects it, and the tie rule's
// t == best_t && i < best_idx cannot take it before a triangle has been
// accepted (best_idx = -1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mip_sample.cuh"

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;
constexpr int kPackRows = 40;   // rows per world in the split pack
constexpr int kPrepRows = 10;   // D(3) A(3) Q(3) t_num
constexpr int kRawRows = 9;     // v0(3) e1(3) e2(3)
constexpr int kHoistRows = 7;   // tv(3) q(3) t_num, per view
constexpr int kWtRows = 10;     // watertight: a(3) b(3) c(3) valid, per view
constexpr int kAttr0 = 16;      // first attribute row
constexpr int kClRows = 8;
constexpr int kCamLight0 = 17;  // first light column of a camera row
constexpr int kCamFarZ = 16;    // z-space far clip (raster)
constexpr int kBandRows = 8;    // the binned route's sweep bands: two a block

// Geometry rows and shadows (the GEO template parameter).
constexpr int kGeoPrep = 0;
constexpr int kGeoRaw = 1;
constexpr int kGeoRawShadows = 2;
constexpr int kGeoRawWt = 3;         // K10: the watertight decision
constexpr int kGeoRawWtShadows = 4;  // K10 with K8's shadow rays

// Texture modes (the TEX template parameter): untextured, the in-kernel
// filters, and the mip hand-off.
constexpr int kTexNone = 0;
constexpr int kTexNearest = 1;
constexpr int kTexBilinear = 2;
constexpr int kTexMip = 3;
// The 9-output mode: the unshaded outputs t, z, idx, mat, uv and the
// normal, written unmasked for the shading epilogue; its entries are each
// route's own (launch_tex: HasNine).
constexpr int kTexNine = 4;
// Hand-off code bits above the material id.
constexpr int kFoundBit = 1 << 16;
constexpr int kShadedBit = 1 << 17;

// The JAX constants: _EPS_DET, _EPS_BARY and 1 + _EPS_BARY are Python
// floats rounded once to f32; AMBIENT and 1 - AMBIENT likewise; 1e-6 is the
// raster cosine floor.
constexpr float kEpsDet = 1e-10f;
constexpr float kEpsBary = 1e-6f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-6);
constexpr float kAmbient = 0.2f;
constexpr float kDiffuse = (float)(1.0 - 0.2);
constexpr float kTiny = 1e-20f;
constexpr float kCosFloor = 1e-6f;
constexpr float kShadowEps = 1e-3f;  // SHADOW_EPS
constexpr uint32_t kAlpha = 0xFF000000u;
// The streamed walk: the occlusion early exit's rounding slack on squared
// distances (:1763-1775) and the slab test's on t (a tie must not be culled).
constexpr float kExitSlack = 0.998f;
constexpr float kSlabSlack = 0.999f;
// Walk decisions.
constexpr int kStop = 0;
constexpr int kSkip = 1;
constexpr int kVisit = 2;

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) > kTiny ? d : (d < 0.f ? -kTiny : kTiny);
}

__device__ __forceinline__ uint32_t quantize(float base, float s, bool hit) {
  float c = clip01(base * (kAmbient + kDiffuse * s));
  c = hit ? c : 0.f;
  return (uint32_t)(int)(c * 255.f + 0.5f);
}

// clip01, dequant, wrap and the mip texel path: csrc/mip_sample.cuh.

// The pvec test of a ray along d (:1373-1380, :2885-2903) on the raw
// sweep's terms of its origin and the triangle, h[k * st] for k = 0..6:
// tv = o - v0 (0-2), q = tv x e1 (3-5), t_num = e2 . q (6). p = d x e2,
// det = e1 . p, inv = 1/det (0 when |det| <= eps), u = (tv . p) * inv,
// v = (d . q) * inv, t = t_num * inv. The primary sweep passes its block's
// terms in shared memory (st = S), read where the expressions use them;
// the shadow sweep its own, in registers (st = 1).
__device__ __forceinline__ void pvec_test(float dx, float dy, float dz,
                                          float e1x, float e1y, float e1z,
                                          float e2x, float e2y, float e2z,
                                          const float* h, int st, float& u,
                                          float& v, float& t) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
  u = (h[0] * pvx + h[st] * pvy + h[2 * st] * pvz) * inv;
  v = (dx * h[3 * st] + dy * h[4 * st] + dz * h[5 * st]) * inv;
  t = h[6 * st] * inv;
}

// The Woop shear frame of one ray (watertight.py::shear_select, the JAX
// kernel's select form, :1244-1273): kz = argmax |d| with the first maximum
// on ties, kx = kz + 1 and ky = kz + 2 (mod 3), sz = 1 / d[kz],
// sx = d[kx] * sz, sy = d[ky] * sz.
struct Shear {
  bool kz_x, kz_y;
  float sx, sy, sz;

  __device__ __forceinline__ Shear(float dx, float dy, float dz) {
    const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
    kz_x = (adx >= ady) && (adx >= adz);
    kz_y = !kz_x && (ady >= adz);
    sz = 1.0f / sel_z(dx, dy, dz);
    sx = sel_x(dx, dy, dz) * sz;
    sy = sel_y(dx, dy, dz) * sz;
  }
  __device__ __forceinline__ float sel_z(float x, float y, float z) const {
    return kz_x ? x : (kz_y ? y : z);
  }
  __device__ __forceinline__ float sel_x(float x, float y, float z) const {
    return kz_x ? y : (kz_y ? z : x);
  }
  __device__ __forceinline__ float sel_y(float x, float y, float z) const {
    return kz_x ? z : (kz_y ? x : y);
  }
  // A vertex translated to the ray origin → its sheared coordinates
  // (watertight.py::sheared).
  __device__ __forceinline__ void shear(float x, float y, float z, float& px,
                                        float& py, float& pz) const {
    const float k = sel_z(x, y, z);
    px = sel_x(x, y, z) - sx * k;
    py = sel_y(x, y, z) - sy * k;
    pz = sz * k;
  }
};

// The frame of the variants without the watertight decision: nothing.
struct NoShear {
  __device__ __forceinline__ NoShear(float, float, float) {}
};

// K10's decision (:1393-1435, watertight.py::_edge_function_hit) on a
// triangle's vertices translated to the ray origin, g[k * st] for
// k = 0..8: a (0-2), b (3-5), c (6-8). Returns whether the edge functions
// accept (all >= 0 or all <= 0, det != 0) and then sets t; the caller ANDs
// the validity and the t window.
__device__ __forceinline__ bool woop_test(const Shear& f, const float* g,
                                          int st, float& t) {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  f.shear(g[0], g[st], g[2 * st], ax, ay, az);
  f.shear(g[3 * st], g[4 * st], g[5 * st], bx, by, bz);
  f.shear(g[6 * st], g[7 * st], g[8 * st], cx, cy, cz);
  const float u = cx * by - cy * bx;
  const float v = ax * cy - ay * cx;
  const float w = bx * ay - by * ax;
  const float det = u + v + w;
  const bool accept = det != 0.f && ((u >= 0.f && v >= 0.f && w >= 0.f) ||
                                     (u <= 0.f && v <= 0.f && w <= 0.f));
  if (accept) t = (u * az + v * bz + w * cz) * (1.0f / det);
  return accept;
}

// Möller–Trumbore on the pack-time prep rows (:1296-1316), g[k * st] for row
// k = 0..9: D(3), A(3), Q(3), t_num.
__device__ __forceinline__ void prep_test(float dx, float dy, float dz,
                                          const float* g, int st, float& u,
                                          float& v, float& t) {
  const float det = dx * g[0] + dy * g[st] + dz * g[2 * st];
  const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
  u = (dx * g[3 * st] + dy * g[4 * st] + dz * g[5 * st]) * inv;
  v = (dx * g[6 * st] + dy * g[7 * st] + dz * g[8 * st]) * inv;
  t = g[9 * st] * inv;
}

// Slab test of one ray against an AABB given as lo.xyz, hi.xyz rows of the
// cluster table (stride CC), column c (:1671-1697).
__device__ __forceinline__ void slab(const float* cl, int CC, int c, float ox,
                                     float oy, float oz, float ivx, float ivy,
                                     float ivz, float& tmin, float& tmax) {
  const float t1x = (cl[0 * CC + c] - ox) * ivx;
  const float t2x = (cl[3 * CC + c] - ox) * ivx;
  const float t1y = (cl[1 * CC + c] - oy) * ivy;
  const float t2y = (cl[4 * CC + c] - oy) * ivy;
  const float t1z = (cl[2 * CC + c] - oz) * ivz;
  const float t2z = (cl[5 * CC + c] - oz) * ivz;
  tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
}

// ---- The streamed route's staging: cp.async, 16 bytes a copy ------------ //
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of rows 0..n_rows-1 of cluster c (cs triangles from
// c * cs, row stride S in global memory) into buf [n_rows, cs], and commits
// them as one group. Each thread copies the same slots whatever c is.
__device__ __forceinline__ void stage_cluster(float* buf, const float* g_rows,
                                              int S, int cs, int c, int n_rows,
                                              int tid) {
  const int vec = cs / 4;
  const float* src = g_rows + (size_t)c * cs;
  for (int i = tid; i < n_rows * vec; i += kThreads) {
    const int r = i / vec;
    const int k = (i - r * vec) * 4;
    cp_async16(buf + r * cs + k, src + (size_t)r * S + k);
  }
  cp_async_commit();
}

// The streamed walk over positions 0..n-1. gate(p) returns kStop, kSkip or
// kVisit for the block (uniform: every thread reaches its barriers);
// stage(p, buf) issues a visited position's copies; visit(p, buf) sweeps it
// once they have landed. The next candidate is chosen, and its copies issued,
// before the current one is swept; after the sweep it is tested again (the
// sweep may have lowered best_t past it) and, if it fails, dropped. So the
// positions visited are those of the plain walk that gates every position
// on the best_t of the visits before it: the gates only tighten as best_t
// falls, and distances grow along the order.
template <class Gate, class Stage, class Visit>
__device__ __forceinline__ void walk_clusters(int n, float* buf0, float* buf1,
                                              Gate gate, Stage stage,
                                              Visit visit) {
  auto next = [&](int p) {
    for (; p < n; ++p) {
      const int g = gate(p);
      if (g == kVisit) return p;
      if (g == kStop) return -1;
    }
    return -1;
  };
  float* cur = buf0;
  float* spare = buf1;
  int pos = next(0);
  if (pos >= 0) stage(pos, cur);
  while (pos >= 0) {
    int nxt = next(pos + 1);
    if (nxt >= 0) {
      stage(nxt, spare);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    visit(pos, cur);
    __syncthreads();  // every thread is done with cur before it is refilled
    if (nxt >= 0) {
      const int g = gate(nxt);
      if (g != kVisit) {
        // Drop it: each thread waits for its own copies, then refills the
        // same slots.
        cp_async_wait<0>();
        nxt = g == kStop ? -1 : next(nxt + 1);
        if (nxt >= 0) stage(nxt, spare);
      }
    }
    pos = nxt;
    float* t = cur;
    cur = spare;
    spare = t;
  }
}

// Base colour of a textured hit: the material colour times the texel
// sampled at (u, v) with repeat wrap and v flipped (:3060-3167).
template <int TEX>
__device__ __forceinline__ void textured_base(const float* __restrict__ mats,
                                              const int* __restrict__ pool,
                                              int n_mats, int mat, float u,
                                              float v, float& br, float& bg,
                                              float& bb) {
  br = mats[0 * n_mats + mat];
  bg = mats[1 * n_mats + mat];
  bb = mats[2 * n_mats + mat];
  const float off_f = mats[3 * n_mats + mat];
  const float wf = mats[4 * n_mats + mat];
  const float hf = mats[5 * n_mats + mat];
  const int w_i = (int)wf;
  const int h_i = (int)hf;
  const int off_i = (int)off_f;
  const float uu = u - floorf(u);
  const float vv = v - floorf(v);
  if (TEX == kTexNearest) {
    // A plain cast truncates toward zero, as astype(int32) does.
    const int tx = min(max((int)(uu * wf), 0), w_i - 1);
    const int ty = min(max((int)((1.0f - vv) * hf), 0), h_i - 1);
    const int texel = pool[off_i + ty * w_i + tx];
    br = br * dequant(texel & 255);
    bg = bg * dequant((texel >> 8) & 255);
    bb = bb * dequant((texel >> 16) & 255);
  } else {
    // Texel centres at half-integers (:3131-3167).
    const float fx = uu * wf - 0.5f;
    const float fy = (1.0f - vv) * hf - 0.5f;
    const float x0f = floorf(fx);
    const float y0f = floorf(fy);
    const float ax = fx - x0f;
    const float ay = fy - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const int xa = wrap(x0, w_i), xb = wrap(x0 + 1, w_i);
    const int ya = wrap(y0, h_i), yb = wrap(y0 + 1, h_i);
    const int t00 = pool[off_i + ya * w_i + xa];
    const int t10 = pool[off_i + ya * w_i + xb];
    const int t01 = pool[off_i + yb * w_i + xa];
    const int t11 = pool[off_i + yb * w_i + xb];
    float c[3];
    for (int ch = 0; ch < 3; ++ch) {
      const int sh = 8 * ch;
      const float c00 = dequant((t00 >> sh) & 255);
      const float c10 = dequant((t10 >> sh) & 255);
      const float c01 = dequant((t01 >> sh) & 255);
      const float c11 = dequant((t11 >> sh) & 255);
      const float top = c00 * (1.0f - ax) + c10 * ax;
      const float bot = c01 * (1.0f - ax) + c11 * ax;
      c[ch] = top * (1.0f - ay) + bot * ay;
    }
    br = br * c[0];
    bg = bg * c[1];
    bb = bb * c[2];
  }
}

// Everything a launch passes to the kernel.
// The mip hand-off mode samples nothing and writes no rgb, so its two
// outputs share the texture inputs' slots: the argument block keeps the
// size it has without them (a larger one changes how the variants load it).
struct RenderArgs {
  const float* rows;      // [W, 40, S]
  const float* clusters;  // [W, 8, CC]
  const float* cams;      // [W*C, NCOL]
  union {
    const float* mats;    // [6, M] (textured)
    float* handoff;       // [6, W*C, H, Wd] (mip): u, v, fp, lambert rgb
  };
  union {
    const int* pool;      // [texels] (textured)
    int* code;            // [W*C, H, Wd] (mip): material | hit flags
  };
  float* depth;           // [W*C, H, Wd]
  int* segmask;
  uint32_t* rgb;          // (not mip)
  int n_mats, num_cams, S, CC, cluster_size, n_cols, n_lights, height, width,
      tiles_x, seg_div;
  float two_over_w, two_over_h;
};

// The streamed route's inputs, the second parameter of its entry point (the
// resident entry keeps its argument block as it was); the resident ordered
// visit's order (no spans).
struct StreamArgs {
  const int* order;  // [W*C, CC] cluster visit order of each view
  const int* spans;  // [W*C, 2, CC] pixel-row span (lo, hi) of each cluster
};

// The binned route's inputs (K4, csrc/render_binned.cu): the entry point's
// second parameter; the resident binned visit's bins (no spans, no ranges).
struct BinArgs {
  const int* bins;     // [W*C, n_bins, 1 + CC]: count, then the ids front to back
  const int* spans;    // [W*C, 2, CC] pixel-row spans at 8-row bands
  const int2* ranges;  // prep: [W, CC, n_bands] sorted-local (lo, hi) per band
  int bins_x, bin_shift, n_bins, n_bands;  // bin = (by >> shift) * bins_x + (bx >> shift)
};

template <int GEO>
__host__ __device__ constexpr int smem_geo_rows() {
  // prep: D, A, Q, t_num; raw: v0, e1, e2 and the hoisted tv, q, t_num;
  // watertight: a, b, c and the validity.
  return GEO == kGeoPrep ? kPrepRows
                         : (GEO >= kGeoRawWt ? kWtRows : kRawRows + kHoistRows);
}

// Rows a staged cluster holds on the binned route: the ordered walk's, and
// on prep rows the original index (row 10) too.
template <int GEO>
__host__ __device__ constexpr int binned_stage_rows() {
  return GEO == kGeoPrep ? kPrepRows + 1 : smem_geo_rows<GEO>();
}

// The span hooks of port_tools/resident_phase_probe.py and
// port_tools/index_phase_probe.py (empty here): MRT_PHASE in the resident
// visits' body (visit_body, below, K1's index visit on tile groups among
// them), MRT_INDEX in render_body's resident index branch (K1's parent
// design), each phase k as the probes number them.
#ifndef MRT_PHASE
#define MRT_PHASE_BEGIN
#define MRT_PHASE(k)
#define MRT_AFTER_FILL
#endif
#ifndef MRT_INDEX
#define MRT_INDEX_BEGIN
#define MRT_INDEX(k)
#define MRT_INDEX_AFTER_FILL
#endif
// K7 folded: what the index visit's block holds a pixel between its tiles
// and its keys and sample passes: the winner (best_t, best_idx), from which
// each pass resolves again (holding the hand-off's 28 B instead ran 2.1x
// slower at 64x64, one block an SM, and cannot hold a 128x128 view).
constexpr int kMipHoldWords = 2;

// The render kernel's body. STREAM false: the resident route (the world's
// geometry rows in shared memory, clusters in index order); true: the
// streamed route (see the header), with BINNED its binned visit's parent
// design (K4 on one 16x16 block a tile: the walk below reads the bin, the
// cluster table and the spans in device memory where the ordered walk reads
// its shared copies; the tile groups' walk is bin_body's). RWALK stays false:
// the resident visits have a body of their own (visit_body, below), and
// the slot keeps the other sources' template arguments as they are.
// SEEDED: K9, best_t starting from `seed` (unread otherwise). CULL false
// (K1-none, csrc/render_none.cu, resident index order only): no cluster
// table; every triangle is tested, in index order, and so is every
// triangle of the shadow sweep. DMXU (with STREAM, prep or raw rows, no
// shadows: csrc/render_dmxu.cu): K11's cluster sweep, with `rowskip` its
// per-warp row gate (unread otherwise).
template <int GEO, bool RASTER, int TEX, bool STREAM, bool BINNED = false,
          bool RWALK = false, bool SEEDED = false, bool CULL = true, bool DMXU = false>
__device__ __forceinline__ void render_body(const RenderArgs& a,
                                            const StreamArgs& st,
                                            const BinArgs& bn = BinArgs{},
                                            const float* seed = nullptr,
                                            int rowskip = 0) {
  constexpr bool RAW = GEO != kGeoPrep;
  constexpr bool SHADOWS = GEO == kGeoRawShadows || GEO == kGeoRawWtShadows;
  constexpr bool WT = GEO >= kGeoRawWt;
  static_assert(!DMXU || (STREAM && (GEO == kGeoPrep || GEO == kGeoRaw)),
                "K11 sweeps the streamed visits' prep or raw rows");
  static_assert(!RWALK, "the resident visits' body is visit_body");
  // The streamed binned visit on prep rows: row-sorted rows and triangle
  // ranges (K11 streams its rows unsorted).
  constexpr bool RANGED = BINNED && STREAM && GEO == kGeoPrep && !DMXU;
  const int S = a.S, CC = a.CC;
  extern __shared__ __align__(16) float smem[];
  MRT_INDEX_BEGIN;
  // Resident: [smem_geo_rows, S]; streamed: two staged clusters, each
  // [smem_geo_rows, cluster_size], then the view's order and spans.
  const int geo_floats = STREAM ? 2 * smem_geo_rows<GEO>() * a.cluster_size
                                : smem_geo_rows<GEO>() * S;
  float* s_geo = smem;
  float* s_cl = s_geo + geo_floats;                   // [8, CC]
  float* s_cam = s_cl + kClRows * CC;                 // [NCOL]
  int* s_order = reinterpret_cast<int*>(s_cam + a.n_cols);  // [CC]
  int* s_span = s_order + CC;                               // [2, CC]

  const int view = blockIdx.x;
  const int world = view / a.num_cams;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float* g_rows = a.rows + (size_t)world * kPackRows * S;
  const float* g_cl = a.clusters + (size_t)world * kClRows * CC;
  const float* g_cam = a.cams + (size_t)view * a.n_cols;
  constexpr int kLoadRows =
      WT ? kWtRows : (RAW ? kRawRows : (RANGED ? kPrepRows + 1 : kPrepRows));
  if constexpr (BINNED && STREAM) {
    // K4: shared memory holds the two stage buffers and the camera row; the
    // cluster table, the bin of the block's bin tile (count, then ids) and
    // the 8-row-band spans are read in device memory through the pointers
    // the ordered walk reads its shared copies by.
    const int bx = blockIdx.y % a.tiles_x, by = blockIdx.y / a.tiles_x;
    const int bin = (by >> bn.bin_shift) * bn.bins_x + (bx >> bn.bin_shift);
    s_cam = s_geo + 2 * binned_stage_rows<GEO>() * a.cluster_size;
    s_cl = const_cast<float*>(g_cl);
    s_order = const_cast<int*>(bn.bins + ((size_t)view * bn.n_bins + bin) * (1 + CC) + 1);
    s_span = const_cast<int*>(bn.spans + (size_t)view * 2 * CC);
  }
  if constexpr (!STREAM && !WT) {
    for (int i = tid; i < kLoadRows * S; i += kThreads) s_geo[i] = g_rows[i];
  }
  if constexpr (!BINNED || !STREAM) {
    for (int i = tid; i < kClRows * CC; i += kThreads) s_cl[i] = g_cl[i];
  }
  for (int i = tid; i < a.n_cols; i += kThreads) s_cam[i] = g_cam[i];
  if constexpr (!STREAM && WT) {
    // K10's per-(view, triangle) terms (:1393-1402), once per block:
    // a = v0 - o, b = a + e1, c = a + e2 with this view's camera origin,
    // and the validity.
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    for (int i = tid; i < S; i += kThreads) {
      const float ax = g_rows[i] - ox;
      const float ay = g_rows[S + i] - oy;
      const float az = g_rows[2 * S + i] - oz;
      s_geo[i] = ax;
      s_geo[S + i] = ay;
      s_geo[2 * S + i] = az;
      s_geo[3 * S + i] = ax + g_rows[3 * S + i];
      s_geo[4 * S + i] = ay + g_rows[4 * S + i];
      s_geo[5 * S + i] = az + g_rows[5 * S + i];
      s_geo[6 * S + i] = ax + g_rows[6 * S + i];
      s_geo[7 * S + i] = ay + g_rows[7 * S + i];
      s_geo[8 * S + i] = az + g_rows[8 * S + i];
      s_geo[9 * S + i] = g_rows[9 * S + i];
    }
  } else if constexpr (!STREAM) {
    if (RAW) {
      // The per-(view, triangle) terms of the raw sweep (:1342-1348), once
      // per block: tv = o - v0, q = tv x e1, t_num = e2 . q, with this
      // view's camera origin.
      const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
      float* s_h = s_geo + kRawRows * S;
      for (int i = tid; i < S; i += kThreads) {
        const float e1x = g_rows[3 * S + i], e1y = g_rows[4 * S + i],
                    e1z = g_rows[5 * S + i];
        const float e2x = g_rows[6 * S + i], e2y = g_rows[7 * S + i],
                    e2z = g_rows[8 * S + i];
        const float tvx = ox - g_rows[i];
        const float tvy = oy - g_rows[S + i];
        const float tvz = oz - g_rows[2 * S + i];
        const float qx = tvy * e1z - tvz * e1y;
        const float qy = tvz * e1x - tvx * e1z;
        const float qz = tvx * e1y - tvy * e1x;
        s_h[i] = tvx;
        s_h[S + i] = tvy;
        s_h[2 * S + i] = tvz;
        s_h[3 * S + i] = qx;
        s_h[4 * S + i] = qy;
        s_h[5 * S + i] = qz;
        s_h[6 * S + i] = e2x * qx + e2y * qy + e2z * qz;
      }
    }
  } else if constexpr (!BINNED) {
    const int* g_order = st.order + (size_t)view * CC;
    const int* g_span = st.spans + (size_t)view * 2 * CC;
    for (int i = tid; i < CC; i += kThreads) s_order[i] = g_order[i];
    for (int i = tid; i < 2 * CC; i += kThreads) s_span[i] = g_span[i];
  }
  __syncthreads();
  MRT_INDEX_AFTER_FILL;
  MRT_INDEX(3);

  const int tile = blockIdx.y;
  const int px = (tile % a.tiles_x) * kTileX + threadIdx.x;
  const int py = (tile / a.tiles_x) * kTileY + threadIdx.y;

  const float ox = s_cam[0], oy = s_cam[1], oz = s_cam[2];
  const float rxx = s_cam[3], rxy = s_cam[4], rxz = s_cam[5];
  const float fx = s_cam[6], fy = s_cam[7], fz = s_cam[8];
  const float ux = s_cam[9], uy = s_cam[10], uz = s_cam[11];
  const float tan_x = s_cam[12], tan_y = s_cam[13];
  const float near = s_cam[14], far = s_cam[15];

  // Ray generation (raytrace_pallas.py:1180-1188). Threads past the image
  // edge trace their ray too: they take part in the block-wide culls and
  // write nothing.
  const float ra = (((float)px + 0.5f) * a.two_over_w - 1.0f) * tan_x;
  const float rb = (1.0f - ((float)py + 0.5f) * a.two_over_h) * tan_y;
  float dx = ra * rxx + fx + rb * ux;
  float dy = ra * rxy + fy + rb * uy;
  float dz = ra * rxz + fz + rb * uz;
  const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;
  // Raster: a fragment with z < znear is clipped before the depth test, so
  // the per-pixel t-space lower bound is znear / cos(angle to forward).
  const float cosf_ = dx * fx + dy * fy + dz * fz;
  const float t_lo = RASTER ? near / fmaxf(cosf_, kCosFloor) : near;

  const float ivx = 1.0f / safe_dir(dx);
  const float ivy = 1.0f / safe_dir(dy);
  const float ivz = 1.0f / safe_dir(dz);
  // K10: the ray's shear frame, once per thread (:1235-1273).
  const std::conditional_t<WT, Shear, NoShear> shear(dx, dy, dz);

  // best_t starts at far: every accepted hit has t < far (:1199-1211). The
  // raw sweep carries the winner's (u, v) as well (:1461-1467).
  float best_t = far, best_u = 0.f, best_v = 0.f;
  if constexpr (SEEDED) {
    // K9: min(seed, far) as jnp.minimum takes it (a NaN seed stays NaN and
    // accepts nothing); 0 past the image edge.
    const bool in_image = px < a.width && py < a.height;
    const float s = in_image ? seed[((size_t)view * a.height + py) * a.width + px] : 0.f;
    best_t = s > far ? far : s;
  }
  int best_idx = -1;
  // RANGED: the winner's sorted lane (its geometry rows), best_idx its
  // original index (its attributes, the tie rule, the segmask).
  [[maybe_unused]] int best_lane = -1;
  // The rows the resolve reads: resident in shared memory, streamed in
  // global memory (the same [rows, S] layout); K10's raw rows are in global
  // memory (its block holds a, b, c).
  const float* geo = (STREAM || WT) ? g_rows : s_geo;
  const float* g0 = geo;  // prep: D; raw: v0
  const float* g1 = geo + S;
  const float* g2 = geo + 2 * S;
  const float* g3 = geo + 3 * S;  // prep: A; raw: e1
  const float* g4 = geo + 4 * S;
  const float* g5 = geo + 5 * S;
  const float* g6 = geo + 6 * S;  // prep: Q; raw: e2
  const float* g7 = geo + 7 * S;
  const float* g8 = geo + 8 * S;
  const float* g9 = geo + 9 * S;  // prep: t_num; raw: tv, q, t_num; K10: valid

  const int cs = a.cluster_size;
  float* buf0 = s_geo;  // streamed: the two staged clusters
  float* buf1 = s_geo + smem_geo_rows<GEO>() * cs;
  if constexpr (BINNED) buf1 = s_geo + binned_stage_rows<GEO>() * cs;
  if constexpr (!STREAM && !CULL) {
    // K1-none: every triangle in index order (the JAX non-culled launch,
    // :4911); invalid and padding triangles fail through inv = 0 or, K10,
    // the validity row.
    MRT_INDEX(2);
    for (int i = 0; i < S; ++i) {
      if constexpr (WT) {
        float t;
        if (woop_test(shear, s_geo + i, S, t) && s_geo[9 * S + i] > 0.f && t > t_lo &&
            t < best_t) {
          best_t = t;
          best_idx = i;
        }
      } else {
        float u, v, t;
        if constexpr (RAW) {
          pvec_test(dx, dy, dz, g3[i], g4[i], g5[i], g6[i], g7[i], g8[i], g9 + i, S, u, v,
                    t);
        } else {
          prep_test(dx, dy, dz, s_geo + i, S, u, v, t);
        }
        if ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > t_lo) &&
            (t < best_t)) {
          best_t = t;
          best_idx = i;
          if (RAW) {
            best_u = u;
            best_v = v;
          }
        }
      }
    }
  } else if constexpr (!STREAM) {
    // The resident sweep keeps its own copy of the slab and prep tests
    // (slab() and prep_test() compute the same expressions): ptxas's
    // register allocation of these variants moves with the source's shape.
    for (int c = 0; c < CC; ++c) {
      MRT_INDEX(1);
      // Slab test of the cluster's world-space AABB (:1671-1697); it keeps
      // the scalar near in raster mode too (t_lo >= near, so it only
      // over-visits).
      const float t1x = (s_cl[0 * CC + c] - ox) * ivx;
      const float t2x = (s_cl[3 * CC + c] - ox) * ivx;
      const float t1y = (s_cl[1 * CC + c] - oy) * ivy;
      const float t2y = (s_cl[4 * CC + c] - oy) * ivy;
      const float t1z = (s_cl[2 * CC + c] - oz) * ivz;
      const float t2z = (s_cl[5 * CC + c] - oz) * ivz;
      const float tmin =
          fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      const float tmax =
          fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      const bool possible = (tmax >= tmin) && (tmax > near) && (tmin < best_t);
      // Every thread reaches this barrier: the loop bound is uniform.
      const int any_hit = __syncthreads_or(possible);
      if (!any_hit || !(s_cl[6 * CC + c] > 0.f)) continue;
      MRT_INDEX(2);
      const int base = c * a.cluster_size;
      const int cnt = (int)s_cl[7 * CC + c];
      for (int i = base; i < base + cnt; ++i) {
        if constexpr (WT) {
          // K10: the Woop decision on the block's a, b, c and validity.
          float t;
          if (woop_test(shear, s_geo + i, S, t) && s_geo[9 * S + i] > 0.f &&
              t > t_lo && t < best_t) {
            best_t = t;
            best_idx = i;
          }
        } else {
          float u, v, t;
          if (RAW) {
            // The pvec test on the raw rows, with the block's tv, q, t_num.
            pvec_test(dx, dy, dz, g3[i], g4[i], g5[i], g6[i], g7[i], g8[i],
                      g9 + i, S, u, v, t);
          } else {
            // Möller–Trumbore on the pack-time rows (:1296-1316).
            const float det = dx * g0[i] + dy * g1[i] + dz * g2[i];
            const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
            u = (dx * g3[i] + dy * g4[i] + dz * g5[i]) * inv;
            v = (dx * g6[i] + dy * g7[i] + dz * g8[i]) * inv;
            t = g9[i] * inv;
          }
          const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                          (t > t_lo) && (t < best_t);
          if (ok) {
            best_t = t;
            best_idx = i;
            if (RAW) {
              best_u = u;
              best_v = v;
            }
          }
        }
      }
    }
  } else {
    // K3 + K5: the front-to-back streamed walk.
    const int row0 = (tile / a.tiles_x) * kTileY;
    auto gate = [&](int p) {
      const int c = s_order[p];
      if (!(s_cl[6 * CC + c] > 0.f)) return kStop;  // invalid clusters sort last
      // Occlusion early exit (approach_dist2, :1740-1780): no pixel's best
      // hit lies beyond this cluster's AABB, nor beyond any later one's.
      const float ax =
          fmaxf(fmaxf(s_cl[0 * CC + c] - ox, ox - s_cl[3 * CC + c]), 0.0f);
      const float ay =
          fmaxf(fmaxf(s_cl[1 * CC + c] - oy, oy - s_cl[4 * CC + c]), 0.0f);
      const float az =
          fmaxf(fmaxf(s_cl[2 * CC + c] - oz, oz - s_cl[5 * CC + c]), 0.0f);
      const float d2 = ax * ax + ay * ay + az * az;
      if (!__syncthreads_or(best_t * best_t > d2 * kExitSlack)) return kStop;
      // Row gate: the cluster's image rows miss the block's.
      if (s_span[c] > row0 + kTileY - 1 || s_span[CC + c] < row0) return kSkip;
      float tmin, tmax;
      slab(s_cl, CC, c, ox, oy, oz, ivx, ivy, ivz, tmin, tmax);
      const bool possible =
          (tmax >= tmin) && (tmax > near) && (tmin * kSlabSlack < best_t);
      return __syncthreads_or(possible) ? kVisit : kSkip;
    };
    auto stage = [&](int p, float* buf) {
      stage_cluster(buf, g_rows, S, cs, s_order[p], kLoadRows, tid);
    };
    auto visit = [&](int p, float* buf) {
      const int c = s_order[p];
      const int base = c * cs;
      const int cnt = (int)s_cl[7 * CC + c];
      if constexpr (WT) {
        // K10: the staged v0, e1, e2 turned in place into this view's
        // a = v0 - o, b = a + e1, c = a + e2 (:1393-1402).
        for (int k = tid; k < cnt; k += kThreads) {
          const float ax = buf[k] - ox;
          const float ay = buf[cs + k] - oy;
          const float az = buf[2 * cs + k] - oz;
          buf[k] = ax;
          buf[cs + k] = ay;
          buf[2 * cs + k] = az;
          buf[3 * cs + k] = ax + buf[3 * cs + k];
          buf[4 * cs + k] = ay + buf[4 * cs + k];
          buf[5 * cs + k] = az + buf[5 * cs + k];
          buf[6 * cs + k] = ax + buf[6 * cs + k];
          buf[7 * cs + k] = ay + buf[7 * cs + k];
          buf[8 * cs + k] = az + buf[8 * cs + k];
        }
        __syncthreads();
      } else if constexpr (RAW) {
        // This view's tv, q, t_num of each staged triangle (:1342-1348).
        float* h = buf + kRawRows * cs;
        for (int k = tid; k < cnt; k += kThreads) {
          const float e1x = buf[3 * cs + k], e1y = buf[4 * cs + k],
                      e1z = buf[5 * cs + k];
          const float e2x = buf[6 * cs + k], e2y = buf[7 * cs + k],
                      e2z = buf[8 * cs + k];
          const float tvx = ox - buf[k];
          const float tvy = oy - buf[cs + k];
          const float tvz = oz - buf[2 * cs + k];
          const float qx = tvy * e1z - tvz * e1y;
          const float qy = tvz * e1x - tvx * e1z;
          const float qz = tvx * e1y - tvy * e1x;
          h[k] = tvx;
          h[cs + k] = tvy;
          h[2 * cs + k] = tvz;
          h[3 * cs + k] = qx;
          h[4 * cs + k] = qy;
          h[5 * cs + k] = qz;
          h[6 * cs + k] = e2x * qx + e2y * qy + e2z * qz;
        }
        __syncthreads();
      }
      for (int k = 0; k < cnt; ++k) {
        if constexpr (WT) {
          // K10's decision; the lower index wins an exact tie.
          const int i = base + k;
          float t;
          if (woop_test(shear, buf + k, cs, t) && buf[9 * cs + k] > 0.f &&
              t > t_lo && ((t < best_t) || (t == best_t && i < best_idx))) {
            best_t = t;
            best_idx = i;
          }
        } else {
          float u, v, t;
          if constexpr (RAW) {
            pvec_test(dx, dy, dz, buf[3 * cs + k], buf[4 * cs + k],
                      buf[5 * cs + k], buf[6 * cs + k], buf[7 * cs + k],
                      buf[8 * cs + k], buf + kRawRows * cs + k, cs, u, v, t);
          } else {
            prep_test(dx, dy, dz, buf + k, cs, u, v, t);
          }
          // The lower index wins an exact tie, whatever the visit order.
          const int i = base + k;
          const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                          (t > t_lo) &&
                          ((t < best_t) || (t == best_t && i < best_idx));
          if (ok) {
            best_t = t;
            best_idx = i;
            if (RAW) {
              best_u = u;
              best_v = v;
            }
          }
        }
      }
    };
    if constexpr (DMXU) {
      // K11 (:1825-2001): the cluster's every slot; its first minimum
      // (strict <, so the lower slot keeps an exact tie) merged into the
      // running best with the lower-index tie rule; the row gate per warp.
      const int wrow0 = row0 + 2 * (int)(threadIdx.y / 2);  // the warp's two image rows
      auto visit_m = [&](int p, float* buf) {
        const int c = s_order[p];
        if constexpr (RAW) {
          // The cluster's D = e2 x e1, A = e2 x tv, Q = tv x e1 and
          // t_num = e2 . Q for this view (tv = o - v0, :1876-1903), in place
          // of its staged v0, e1, e2: one thread a slot.
          for (int k = tid; k < cs; k += kThreads) {
            const float e1x = buf[3 * cs + k], e1y = buf[4 * cs + k],
                        e1z = buf[5 * cs + k];
            const float e2x = buf[6 * cs + k], e2y = buf[7 * cs + k],
                        e2z = buf[8 * cs + k];
            const float tvx = ox - buf[k];
            const float tvy = oy - buf[cs + k];
            const float tvz = oz - buf[2 * cs + k];
            const float qx = tvy * e1z - tvz * e1y;
            const float qy = tvz * e1x - tvx * e1z;
            const float qz = tvx * e1y - tvy * e1x;
            buf[k] = e2y * e1z - e2z * e1y;
            buf[cs + k] = e2z * e1x - e2x * e1z;
            buf[2 * cs + k] = e2x * e1y - e2y * e1x;
            buf[3 * cs + k] = e2y * tvz - e2z * tvy;
            buf[4 * cs + k] = e2z * tvx - e2x * tvz;
            buf[5 * cs + k] = e2x * tvy - e2y * tvx;
            buf[6 * cs + k] = qx;
            buf[7 * cs + k] = qy;
            buf[8 * cs + k] = qz;
            buf[9 * cs + k] = e2x * qx + e2y * qy + e2z * qz;
          }
          __syncthreads();
        }
        // Row skip (:1915-1990): the cluster's rows miss the warp's.
        if (rowskip && (s_span[c] > wrow0 + 1 || s_span[CC + c] < wrow0)) return;
        // t < cmin from cmin = far: the accepted t < far of the first
        // minimum, as the JAX iota-min takes it.
        float cmin = far, cu = 0.f, cv = 0.f;
        int lidx = -1;
        for (int k = 0; k < cs; ++k) {
          float u, v, t;
          prep_test(dx, dy, dz, buf + k, cs, u, v, t);
          if ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > t_lo) &&
              (t < cmin)) {
            cmin = t;
            lidx = k;
            cu = u;
            cv = v;
          }
        }
        const int gi = c * cs + lidx;
        if (lidx >= 0 && ((cmin < best_t) || (cmin == best_t && gi < best_idx))) {
          best_t = cmin;
          best_idx = gi;
          if (RAW) {
            best_u = cu;
            best_v = cv;
          }
        }
      };
      walk_clusters(BINNED ? s_order[-1] : CC, buf0, buf1, gate, stage, visit_m);
    } else if constexpr (!BINNED) {
      walk_clusters(CC, buf0, buf1, gate, stage, visit);
    } else if constexpr (!RANGED) {
      // K4 on raw rows: the bin's clusters (s_order[-1] of them) through
      // the ordered walk's gate and sweep.
      walk_clusters(s_order[-1], buf0, buf1, gate, stage, visit);
    } else {
      // K4 on prep rows, row-sorted: warps 0-3 sweep the block's first
      // 8-row band, warps 4-7 its second, each only where the cluster's
      // span touches the band and only the sorted lanes [lo, hi) of the
      // band's image band; row 10 holds each lane's original index, the
      // exact-tie rule's. A band below the image sweeps nothing and starts
      // at 0, so it never holds the walk open (:2245-2257).
      const int band_row0 = row0 + (threadIdx.y / kBandRows) * kBandRows;
      const int gband = band_row0 / kBandRows;
      const bool band_in = gband < bn.n_bands;
      if (!band_in) best_t = 0.f;
      const int2* g_range = bn.ranges + (size_t)world * CC * bn.n_bands + gband;
      auto visit_r = [&](int p, float* buf) {
        const int c = s_order[p];
        if (!band_in || s_span[c] > band_row0 + kBandRows - 1 ||
            s_span[CC + c] < band_row0)
          return;
        const int2 r = g_range[(size_t)c * bn.n_bands];
        for (int k = r.x; k < r.y; ++k) {
          float u, v, t;
          prep_test(dx, dy, dz, buf + k, cs, u, v, t);
          const int gi = (int)buf[kPrepRows * cs + k];
          const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                          (t > t_lo) && ((t < best_t) || (t == best_t && gi < best_idx));
          if (ok) {
            best_t = t;
            best_idx = gi;
            best_lane = c * cs + k;
          }
        }
      };
      walk_clusters(s_order[-1], buf0, buf1, gate, stage, visit_r);
    }
  }

  MRT_INDEX(3);
  const bool inside = px < a.width && py < a.height;
  // The shadow sweep below has block-wide barriers: every thread stays.
  if (!SHADOWS && !inside) return;

  // Winner resolve (:2725-2793): the clipped barycentrics — carried by the
  // raw sweep (:2739-2742), recomputed from the prep rows otherwise — and
  // the attributes read once from global memory. Untextured: the
  // premultiplied colour (rows 16-18); textured: material (row 15) and uv
  // (rows 0-5).
  float nx = 0.f, ny = 0.f, nz = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  float dens = 0.f;  // mip: the winner's texel density
  const bool found = best_idx >= 0;
  if (found && inside) {
    const int j = best_idx;
    float uc, vc;
    if constexpr (WT) {
      // The winner's Möller–Trumbore (u, v) (:1372-1380), which the JAX
      // sweep carries, from its raw rows: tv = o - v0, q = tv x e1,
      // t_num = e2 . q, then the pvec test.
      float h[7];
      h[0] = ox - g0[j];
      h[1] = oy - g1[j];
      h[2] = oz - g2[j];
      h[3] = h[1] * g5[j] - h[2] * g4[j];
      h[4] = h[2] * g3[j] - h[0] * g5[j];
      h[5] = h[0] * g4[j] - h[1] * g3[j];
      h[6] = g6[j] * h[3] + g7[j] * h[4] + g8[j] * h[5];
      float u, v, t;
      pvec_test(dx, dy, dz, g3[j], g4[j], g5[j], g6[j], g7[j], g8[j], h, 1, u, v, t);
      uc = clip01(u);
      vc = clip01(v);
    } else if (RAW) {
      uc = clip01(best_u);
      vc = clip01(best_v);
    } else if constexpr (RANGED) {
      // The winner's prep rows sit at its sorted lane.
      const int jr = best_lane;
      const float det = dx * g0[jr] + dy * g1[jr] + dz * g2[jr];
      const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
      uc = clip01((dx * g3[jr] + dy * g4[jr] + dz * g5[jr]) * inv);
      vc = clip01((dx * g6[jr] + dy * g7[jr] + dz * g8[jr]) * inv);
    } else {
      const float det = dx * g0[j] + dy * g1[j] + dz * g2[j];
      const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
      uc = clip01((dx * g3[j] + dy * g4[j] + dz * g5[j]) * inv);
      vc = clip01((dx * g6[j] + dy * g7[j] + dz * g8[j]) * inv);
    }
    const float* g_attr = g_rows + (size_t)kAttr0 * S;
    nx = g_attr[6 * S + j] + uc * g_attr[9 * S + j] + vc * g_attr[12 * S + j];
    ny = g_attr[7 * S + j] + uc * g_attr[10 * S + j] + vc * g_attr[13 * S + j];
    nz = g_attr[8 * S + j] + uc * g_attr[11 * S + j] + vc * g_attr[14 * S + j];
    if (TEX == kTexNone) {
      a0 = g_attr[16 * S + j];
      a1 = g_attr[17 * S + j];
      a2 = g_attr[18 * S + j];
    } else {
      a0 = g_attr[15 * S + j];
      a1 = g_attr[0 * S + j] + uc * g_attr[2 * S + j] + vc * g_attr[4 * S + j];
      a2 = g_attr[1 * S + j] + uc * g_attr[3 * S + j] + vc * g_attr[5 * S + j];
    }
    if (TEX == kTexMip) dens = g_attr[19 * S + j];
  }

  // Two-sided: flip the normal toward the viewer (:2800-2804).
  const float ndotd = nx * dx + ny * dy + nz * dz;
  const float flip = ndotd > 0.f ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;

  // Depth of the winner: t, and in raster mode camera-plane z (:2806-2807).
  const float t_hit = found ? best_t : 0.f;
  const float z = t_hit * cosf_;

  if constexpr (TEX == kTexNine) {
    // The 9-output mode (:2832-2834, :3664-3670): t, idx, the material and
    // five f32 planes, unmasked; a miss writes t 0, idx -1 and zeros.
    const size_t o = ((size_t)view * a.height + py) * a.width + px;
    const size_t plane = (size_t)gridDim.x * a.height * a.width;
    a.depth[o] = t_hit;
    a.segmask[o] = best_idx;
    a.code[o] = (int)a0;
    a.handoff[o] = z;
    a.handoff[plane + o] = a1;
    a.handoff[2 * plane + o] = a2;
    a.handoff[3 * plane + o] = nx;
    a.handoff[4 * plane + o] = ny;
    a.handoff[5 * plane + o] = nz;
    return;
  }

  // K8: one any-hit sweep per directional light from the hit point
  // (:2847-2999), bit li of occ_mask set when light li is occluded. A miss
  // sweeps from the camera origin (t_hit = 0); its result is dead.
  uint32_t occ_mask = 0;
  if (SHADOWS) {
    const float hx = ox + t_hit * dx;
    const float hy = oy + t_hit * dy;
    const float hz = oz + t_hit * dz;
    const float eps_sh = kShadowEps * (1.0f + t_hit);
    for (int li = 0; li < a.n_lights; ++li) {
      const float* l = s_cam + kCamLight0 + 6 * li;
      const float sdx = -l[0], sdy = -l[1], sdz = -l[2];
      const float ivsx = 1.0f / safe_dir(sdx);
      const float ivsy = 1.0f / safe_dir(sdy);
      const float ivsz = 1.0f / safe_dir(sdz);
      bool occ = false;
      if constexpr (!STREAM && !CULL) {
        // K1-none: every triangle, no slab test.
        for (int i = 0; i < S; ++i) {
          const float e1x = g3[i], e1y = g4[i], e1z = g5[i];
          const float e2x = g6[i], e2y = g7[i], e2z = g8[i];
          float h[7];
          h[0] = hx - g0[i];
          h[1] = hy - g1[i];
          h[2] = hz - g2[i];
          h[3] = h[1] * e1z - h[2] * e1y;
          h[4] = h[2] * e1x - h[0] * e1z;
          h[5] = h[0] * e1y - h[1] * e1x;
          h[6] = e2x * h[3] + e2y * h[4] + e2z * h[5];
          float u, v, t;
          pvec_test(sdx, sdy, sdz, e1x, e1y, e1z, e2x, e2y, e2z, h, 1, u, v, t);
          occ = occ || ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                        (t > eps_sh));
        }
      } else if constexpr (!STREAM) {
        for (int c = 0; c < CC; ++c) {
          MRT_INDEX(5);
          // The shadow ray's slab test (:2930-2948): tmax > 0, and pixels
          // already occluded drop out of the block-wide OR.
          const float t1x = (s_cl[0 * CC + c] - hx) * ivsx;
          const float t2x = (s_cl[3 * CC + c] - hx) * ivsx;
          const float t1y = (s_cl[1 * CC + c] - hy) * ivsy;
          const float t2y = (s_cl[4 * CC + c] - hy) * ivsy;
          const float t1z = (s_cl[2 * CC + c] - hz) * ivsz;
          const float t2z = (s_cl[5 * CC + c] - hz) * ivsz;
          const float tmin =
              fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
          const float tmax =
              fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
          const bool possible = (tmax >= tmin) && (tmax > 0.f) && !occ;
          const int go = __syncthreads_or(possible);
          if (!go || !(s_cl[6 * CC + c] > 0.f)) continue;
          MRT_INDEX(6);
          const int base = c * a.cluster_size;
          const int cnt = (int)s_cl[7 * CC + c];
          for (int i = base; i < base + cnt; ++i) {
            // Any-hit test along the light (:2885-2903), from the hit point.
            const float e1x = g3[i], e1y = g4[i], e1z = g5[i];
            const float e2x = g6[i], e2y = g7[i], e2z = g8[i];
            float h[7];  // tv, q, t_num of the hit point and the triangle
            h[0] = hx - g0[i];
            h[1] = hy - g1[i];
            h[2] = hz - g2[i];
            h[3] = h[1] * e1z - h[2] * e1y;
            h[4] = h[2] * e1x - h[0] * e1z;
            h[5] = h[0] * e1y - h[1] * e1x;
            h[6] = e2x * h[3] + e2y * h[4] + e2z * h[5];
            float u, v, t;
            pvec_test(sdx, sdy, sdz, e1x, e1y, e1z, e2x, e2y, e2z, h, 1, u, v, t);
            occ = occ || ((fminf(u, v) >= -kEpsBary) &&
                          (u + v <= kOnePlusEps) && (t > eps_sh));
          }
        }
      } else {
        // The same sweep on the streamed route: every cluster in index
        // order, each visited cluster's raw rows staged.
        auto gate_sh = [&](int c) {
          float tmin, tmax;
          slab(s_cl, CC, c, hx, hy, hz, ivsx, ivsy, ivsz, tmin, tmax);
          const bool possible = (tmax >= tmin) && (tmax > 0.f) && !occ;
          const int go = __syncthreads_or(possible);
          return go && s_cl[6 * CC + c] > 0.f ? kVisit : kSkip;
        };
        auto stage_sh = [&](int c, float* buf) {
          stage_cluster(buf, g_rows, S, cs, c, kRawRows, tid);
        };
        auto visit_sh = [&](int c, float* buf) {
          const int cnt = (int)s_cl[7 * CC + c];
          for (int k = 0; k < cnt; ++k) {
            const float e1x = buf[3 * cs + k], e1y = buf[4 * cs + k],
                        e1z = buf[5 * cs + k];
            const float e2x = buf[6 * cs + k], e2y = buf[7 * cs + k],
                        e2z = buf[8 * cs + k];
            float h[7];
            h[0] = hx - buf[k];
            h[1] = hy - buf[cs + k];
            h[2] = hz - buf[2 * cs + k];
            h[3] = h[1] * e1z - h[2] * e1y;
            h[4] = h[2] * e1x - h[0] * e1z;
            h[5] = h[0] * e1y - h[1] * e1x;
            h[6] = e2x * h[3] + e2y * h[4] + e2z * h[5];
            float u, v, t;
            pvec_test(sdx, sdy, sdz, e1x, e1y, e1z, e2x, e2y, e2z, h, 1, u, v, t);
            occ = occ || ((fminf(u, v) >= -kEpsBary) &&
                          (u + v <= kOnePlusEps) && (t > eps_sh));
          }
        };
        walk_clusters(CC, buf0, buf1, gate_sh, stage_sh, visit_sh);
      }
      if (occ) occ_mask |= 1u << li;
    }
    MRT_INDEX(3);
    if (!inside) return;
  }

  // Base colour. A miss samples material 0 at uv (0, 0): in range, and
  // masked below.
  float br = a0, bg = a1, bb = a2;
  if (TEX == kTexNearest || TEX == kTexBilinear)
    textured_base<TEX>(a.mats, a.pool, a.n_mats, (int)a0, a1, a2, br, bg, bb);

  // Lambert over the lights (:3015-3035), an occluded light adding nothing
  // (:3030-3032, :3181-3182).
  const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kTiny));
  float sr = 0.f, sg = 0.f, sb = 0.f;
  for (int li = 0; li < a.n_lights; ++li) {
    const float* l = s_cam + kCamLight0 + 6 * li;
    float nd = fmaxf(-(nx * l[0] + ny * l[1] + nz * l[2]) * n_inv, 0.f);
    if (SHADOWS && ((occ_mask >> li) & 1u)) nd = 0.f;
    sr = sr + nd * l[3];
    sg = sg + nd * l[4];
    sb = sb + nd * l[5];
  }

  // Fused export (:2809-2846, :3041-3050, :3186-3202).
  const bool shaded_hit = RASTER ? found && z < s_cam[kCamFarZ] : found;
  const bool cam_ok = s_cam[kCamLight0 + 6 * a.n_lights] > 0.f;
  const bool hit = shaded_hit && cam_ok;
  if (TEX == kTexMip) {
    // The hand-off to csrc/shade_mip.cu. The mip level reads the ray
    // distance t (raster too) of the geometric hit, 0 on a miss (:3237).
    const size_t o = ((size_t)view * a.height + py) * a.width + px;
    const size_t plane = (size_t)gridDim.x * a.height * a.width;
    a.depth[o] = hit ? (RASTER ? z : best_t) : 0.f;
    a.segmask[o] = hit && !RASTER ? best_idx / a.seg_div : -1;
    a.code[o] = (int)a0 | (found ? kFoundBit : 0) | (shaded_hit ? kShadedBit : 0);
    a.handoff[o] = a1;
    a.handoff[plane + o] = a2;
    a.handoff[2 * plane + o] = t_hit * a.two_over_h * tan_y * dens;
    a.handoff[3 * plane + o] = sr;
    a.handoff[4 * plane + o] = sg;
    a.handoff[5 * plane + o] = sb;
    return;
  }
  const uint32_t packed = quantize(br, sr, shaded_hit) |
                          (quantize(bg, sg, shaded_hit) << 8) |
                          (quantize(bb, sb, shaded_hit) << 16) | kAlpha;
  const size_t o = ((size_t)view * a.height + py) * a.width + px;
  if (RASTER) {
    a.depth[o] = hit ? z : 0.f;
    a.segmask[o] = -1;
  } else {
    a.depth[o] = hit ? best_t : 0.f;
    a.segmask[o] = hit ? best_idx / a.seg_div : -1;
  }
  a.rgb[o] = cam_ok ? packed : kAlpha;
}

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_resident_kernel(const RenderArgs a) {
  render_body<GEO, RASTER, TEX, false>(a, StreamArgs{nullptr, nullptr});
}

template <class Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Shared memory of a block: resident (its geometry rows, the cluster table
// and the camera row), streamed (the two staged clusters, the cluster table,
// the camera row, the order and the spans) and binned (the two staged
// clusters and the camera row).
template <int GEO>
size_t resident_smem(const RenderArgs& a) {
  return sizeof(float) *
         ((size_t)smem_geo_rows<GEO>() * a.S + (size_t)kClRows * a.CC + a.n_cols);
}

template <int GEO>
size_t streamed_smem(const RenderArgs& a) {
  return sizeof(float) * ((size_t)2 * smem_geo_rows<GEO>() * a.cluster_size +
                          (size_t)kClRows * a.CC + a.n_cols) +
         sizeof(int) * 3 * (size_t)a.CC;
}

template <int GEO>
size_t binned_smem(const RenderArgs& a) {
  return sizeof(float) *
         ((size_t)2 * binned_stage_rows<GEO>() * a.cluster_size + a.n_cols);
}

// A route's entry argument and K9's seed (null: the cold entries), for the
// routes with seeded entries.
template <class X>
struct Seeded {
  X x;
  const float* seed;
};

// One launch on the (views, tiles) grid of 16x16 blocks with `smem` bytes of
// dynamic shared memory; cudaGetLastError() after it.
template <class... Params, class... Args>
int launch_grid(void (*kernel)(Params...), const RenderArgs& a, int num_views,
                size_t smem, cudaStream_t stream, const Args&... args) {
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const int tiles_y = (a.height + kTileY - 1) / kTileY;
  const dim3 grid(num_views, a.tiles_x * tiles_y);
  const dim3 block(kTileX, kTileY);
  kernel<<<grid, block, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---- The resident visits: one block a view, G tile groups walking in it -- //

// Tile groups of 256 threads in a resident visit's block: 4 (1,024 threads,
// at most 64 registers a thread) on prep and raw rows, whose entries fit
// them without spills; 2 (128 registers) for K10's and the shadow sweeps'.
template <int GEO>
__host__ __device__ constexpr int visit_groups() {
  return GEO == kGeoPrep || GEO == kGeoRaw ? 4 : 2;
}

// A resident visit's per-view gate terms, rows of [kGateRows, CC] in
// shared memory: each cluster's AABB relative to the view's camera origin
// (lo - o, hi - o: the slab test's differences) and its early-exit
// threshold (the approach distance squared times kExitSlack), formed once a
// view with render_body's expressions.
constexpr int kGateRows = 7;

// The head of a resident visit block's shared memory: the geometry fill's
// mbarrier, the tile counter, each group's two tile slots and two vote
// words (one byte a warp), each pair used by turns so that one barrier a
// step separates a slot's writes from its reads.
struct VisitCtl {
  unsigned long long fill_bar;
  int next_tile;
  int tile[4][2];
  union {
    unsigned long long vote[4][2];
    int team_tile[8][2];  // K1's index visit: each tile team's two tile slots
  };
  // K7 folded: the attribute rows and the held pixels' offset in floats
  // from the block's shared memory, read back where they are used, so that
  // neither stays in a register through the teams' sweeps.
  const float* mip_attr;
  int mip_hold;
};
constexpr int kVisitCtlBytes = 128;
static_assert(sizeof(VisitCtl) <= kVisitCtlBytes, "the visit's shared head");
// A bulk copy's largest piece (the mbarrier counts every piece's bytes).
constexpr unsigned kBulkPiece = 32768;

// K1's index visit on tile teams (visit_body with PIX > 0 pixels a thread:
// the resident index order on prep rows, raytraced, untextured or with the
// nearest or bilinear filter). Its block holds 1 or 2 groups of 256 threads
// (the launch plan's, raytrace_cuda.index_plan), each 4 teams of 64, one
// 16x16 tile a team at a time, a named barrier a team (ids 1..8), and, in
// shared memory, each triangle's prep rows as a record of three float4 (D
// with t_num, A, Q). The resolve reads the winner's attribute rows, the
// material table and the texel pool in device memory (L1): a copy a view
// of the attribute rows into shared memory ran within 0.3% of it either
// way, and of the pool 1-2% slower on every textured input
// (port_tools/index_plan_ab.py). Of 1, 2 and 4 pixels a thread, 4 ran
// fastest on every input, so the build has 4; of 1, 2 and 4 groups a
// block (one vote a group over its four tiles, the design before the
// teams), 4 ran slowest on every input, and the teams' barriers (4 a group)
// leave ids for 2.
constexpr int kIndexMaxGroups = 2;
constexpr int kIndexPixels = 4;
// K8's pixels a thread on the teams: 4 (116-118 registers, 2 blocks of one
// group an SM) ran 6-31% slower at 64x64 than 2 (72 registers, 3 blocks)
// and 8-11% faster at 128x128 (port_tools/mip_shadow_ab.py on an H100).
constexpr int kShadowPixels = 2;
// K10's pixels a thread on the teams (wt_tile): each carries its shear
// frame and the slab test's reciprocals through the sweep. Of 1, 2 and 4
// (at 64, 72 and 89-93 registers: 4, 3 and 2 blocks of one group an SM), 2
// ran fastest, and 7% faster still held to 64 registers (4 blocks, no
// spills), as its entries are (port_tools/index_plan_ab.py on an H100).
constexpr int kWtPixels = 2;
// K1-none's on prep rows (index_tile without the cluster gates): 4 ran 5%
// faster than 2.
constexpr int kNonePixels = 4;
// K1-raw's on the teams (shadow_tile without its shadow sweep): 4 at 64
// registers (28 B of spill stores) ran 1% faster than 2 (56, no spills)
// and 3% faster than 4 at up to 128 (80) (port_tools/index_plan_ab.py on
// an H100).
constexpr int kRawPixels = 4;
// K2's and K2+K6's (index_tile in the raster conventions: each pixel also
// carries its t-space near bound through the sweep): 2 (59-64 registers,
// bilinear with 8 B of local memory) ran 9-16% faster than 4 (64, 16 B of
// local memory) on raster_256w_png's 256 views, where each team walks few
// tiles and a tile's pixel work (51-58% of it) sets the pace, and 7%
// slower on main's 4096 views, which no path rasterizes; up to 128
// registers (71-91) was slower on both (port_tools/index_plan_ab.py on an
// H100).
constexpr int kRasterPixels = 2;
constexpr int kIndexRecordFloats = 12;  // a triangle's record: three float4
// K8's and K1-raw's: four float4 a triangle, then (K8) one float4 a
// (light, triangle).
constexpr int kShadowRecordFloats = 16;

template <int GEO>
__host__ __device__ constexpr int index_record_floats(int n_lights) {
  return GEO == kGeoRawShadows ? kShadowRecordFloats + 4 * n_lights
                               : (GEO == kGeoRaw ? kShadowRecordFloats : kIndexRecordFloats);
}

// bar.sync on the named barrier `id` over kThreads threads: a tile group's
// __syncthreads.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// A tile group's __syncthreads_or: bar.red.or.pred on the named barrier
// `id` over kThreads threads.
__device__ __forceinline__ bool group_or(int id, bool p) {
  int r;
  asm volatile(
      "{\n\t.reg .pred pi, po;\n\t"
      "setp.ne.s32 pi, %1, 0;\n\t"
      "bar.red.or.pred po, %2, %3, pi;\n\t"
      "selp.s32 %0, 1, 0, po;\n\t}\n"
      : "=r"(r)
      : "r"((int)p), "r"(id), "n"(kThreads)
      : "memory");
  return r != 0;
}

// One thread's bulk asynchronous copy of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from device to shared memory, completing on
// the mbarrier `bar`, which it initialises for one arrival first.
__device__ __forceinline__ void bulk_fill(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(bytes)
               : "memory");
  for (unsigned off = 0; off < bytes; off += kBulkPiece) {
    const unsigned n = bytes - off < kBulkPiece ? bytes - off : kBulkPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(d + off),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(b)
        : "memory");
  }
}

// Waits until the mbarrier's first phase completes (the bulk copy landed).
__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
}

// One 16x16 tile of a resident visit, walked by one group (named barrier
// `bar`, its two vote words `vote`): K1's ray, the walk of the view's order
// (s_order) or of the tile's bin, then the resolve, the shadow sweep, the
// shading and the export, each expression as render_body computes it. The
// walk's gates are the tile's: the exit and the slab test of a position are
// each an OR over the group's threads, taken together at one barrier (each
// warp's OR of both in its byte of the position's vote word), exit first.
template <int GEO, bool RASTER, int TEX, bool BINNED, bool SEEDED>
__device__ __forceinline__ void visit_tile(const RenderArgs& a, const BinArgs& bn,
                                           const float* seed, const float* s_geo,
                                           const float* s_cl, const float* s_gate,
                                           const float* s_cam, const int* s_order,
                                           const float* g_rows, int view, int tile, int bar,
                                           unsigned long long* vote) {
  constexpr bool RAW = GEO != kGeoPrep;
  constexpr bool SHADOWS = GEO == kGeoRawShadows || GEO == kGeoRawWtShadows;
  constexpr bool WT = GEO >= kGeoRawWt;
  const int S = a.S, CC = a.CC, cs = a.cluster_size;
  const int ly = threadIdx.y % kTileY;
  const int bx = tile % a.tiles_x, by = tile / a.tiles_x;
  const int px = bx * kTileX + threadIdx.x;
  const int py = by * kTileY + ly;
  if constexpr (BINNED) {
    // K4: the bin of the tile's bin tile, in device memory.
    const int bin = (by >> bn.bin_shift) * bn.bins_x + (bx >> bn.bin_shift);
    s_order = bn.bins + ((size_t)view * bn.n_bins + bin) * (1 + CC) + 1;
  }

  const float ox = s_cam[0], oy = s_cam[1], oz = s_cam[2];
  const float rxx = s_cam[3], rxy = s_cam[4], rxz = s_cam[5];
  const float fx = s_cam[6], fy = s_cam[7], fz = s_cam[8];
  const float ux = s_cam[9], uy = s_cam[10], uz = s_cam[11];
  const float tan_x = s_cam[12], tan_y = s_cam[13];
  const float near = s_cam[14], far = s_cam[15];

  // Ray generation (raytrace_pallas.py:1180-1188). Threads past the image
  // edge trace their ray too: they take part in the tile's gates and write
  // nothing.
  const float ra = (((float)px + 0.5f) * a.two_over_w - 1.0f) * tan_x;
  const float rb = (1.0f - ((float)py + 0.5f) * a.two_over_h) * tan_y;
  float dx = ra * rxx + fx + rb * ux;
  float dy = ra * rxy + fy + rb * uy;
  float dz = ra * rxz + fz + rb * uz;
  const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;
  const float cosf_ = dx * fx + dy * fy + dz * fz;
  const float t_lo = RASTER ? near / fmaxf(cosf_, kCosFloor) : near;
  const float ivx = 1.0f / safe_dir(dx);
  const float ivy = 1.0f / safe_dir(dy);
  const float ivz = 1.0f / safe_dir(dz);
  const std::conditional_t<WT, Shear, NoShear> shear(dx, dy, dz);

  float best_t = far, best_u = 0.f, best_v = 0.f;
  if constexpr (SEEDED) {
    // K9: min(seed, far); 0 past the image edge.
    const bool in_image = px < a.width && py < a.height;
    const float s = in_image ? seed[((size_t)view * a.height + py) * a.width + px] : 0.f;
    best_t = s > far ? far : s;
  }
  int best_idx = -1;
  const float* geo = WT ? g_rows : s_geo;  // the rows the resolve reads
  const float* g0 = geo;  // prep: D; raw: v0
  const float* g1 = geo + S;
  const float* g2 = geo + 2 * S;
  const float* g3 = geo + 3 * S;  // prep: A; raw: e1
  const float* g4 = geo + 4 * S;
  const float* g5 = geo + 5 * S;
  const float* g6 = geo + 6 * S;  // prep: Q; raw: e2
  const float* g7 = geo + 7 * S;
  const float* g8 = geo + 8 * S;
  const float* g9 = geo + 9 * S;  // raw: tv, q, t_num
  const int lane_tid = ly * kTileX + threadIdx.x;  // 0-255 in the group
  const int warp = lane_tid >> 5;
  const bool lane0 = (lane_tid & 31) == 0;

  // The walk: the order (or the bin) with the early exit and the slab
  // slack; every gate is the tile's, so the group leaves the loop together.
  const int n = BINNED ? s_order[-1] : CC;
  for (int p = 0; p < n; ++p) {
    MRT_PHASE(1);
    const int c = s_order[p];
    if (!(s_cl[6 * CC + c] > 0.f)) break;  // invalid clusters sort last
    // Occlusion early exit (:1740-1780): no pixel's best hit lies beyond
    // this cluster's AABB, nor beyond any later one's; then the slab test
    // (:1671-1697), on the view's differences.
    const bool reach = best_t * best_t > s_gate[6 * CC + c];
    const float t1x = s_gate[0 * CC + c] * ivx;
    const float t2x = s_gate[3 * CC + c] * ivx;
    const float t1y = s_gate[1 * CC + c] * ivy;
    const float t2y = s_gate[4 * CC + c] * ivy;
    const float t1z = s_gate[2 * CC + c] * ivz;
    const float t2z = s_gate[5 * CC + c] * ivz;
    const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    const bool possible = (tmax >= tmin) && (tmax > near) && (tmin * kSlabSlack < best_t);
    const unsigned any = __reduce_or_sync(0xffffffffu, (reach ? 1u : 0u) | (possible ? 2u : 0u));
    unsigned long long* word = vote + (p & 1);
    if (lane0) reinterpret_cast<unsigned char*>(word)[warp] = (unsigned char)any;
    group_sync(bar);
    const unsigned long long v = *word;
    if (!(v & 0x0101010101010101ull)) break;
    if (!(v & 0x0202020202020202ull)) continue;
    MRT_PHASE(2);
    const int base = c * cs;
    const int cnt = (int)s_cl[7 * CC + c];
    for (int i = base; i < base + cnt; ++i) {
      // The lower index wins an exact tie, whatever the visit order.
      if constexpr (WT) {
        float t;
        if (woop_test(shear, s_geo + i, S, t) && s_geo[9 * S + i] > 0.f && t > t_lo &&
            ((t < best_t) || (t == best_t && i < best_idx))) {
          best_t = t;
          best_idx = i;
        }
      } else {
        float u, v, t;
        if constexpr (RAW) {
          pvec_test(dx, dy, dz, g3[i], g4[i], g5[i], g6[i], g7[i], g8[i], g9 + i, S, u, v, t);
        } else {
          prep_test(dx, dy, dz, s_geo + i, S, u, v, t);
        }
        const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > t_lo) &&
                        ((t < best_t) || (t == best_t && i < best_idx));
        if (ok) {
          best_t = t;
          best_idx = i;
          if (RAW) {
            best_u = u;
            best_v = v;
          }
        }
      }
    }
  }
  MRT_PHASE(3);

  const bool inside = px < a.width && py < a.height;
  // The shadow sweep below has the tile's barriers: every thread stays.
  if (!SHADOWS && !inside) return;

  // Winner resolve (:2725-2793), as render_body's.
  float nx = 0.f, ny = 0.f, nz = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  float dens = 0.f;
  const bool found = best_idx >= 0;
  if (found && inside) {
    const int j = best_idx;
    float uc, vc;
    if constexpr (WT) {
      float h[7];
      h[0] = ox - g0[j];
      h[1] = oy - g1[j];
      h[2] = oz - g2[j];
      h[3] = h[1] * g5[j] - h[2] * g4[j];
      h[4] = h[2] * g3[j] - h[0] * g5[j];
      h[5] = h[0] * g4[j] - h[1] * g3[j];
      h[6] = g6[j] * h[3] + g7[j] * h[4] + g8[j] * h[5];
      float u, v, t;
      pvec_test(dx, dy, dz, g3[j], g4[j], g5[j], g6[j], g7[j], g8[j], h, 1, u, v, t);
      uc = clip01(u);
      vc = clip01(v);
    } else if (RAW) {
      uc = clip01(best_u);
      vc = clip01(best_v);
    } else {
      const float det = dx * g0[j] + dy * g1[j] + dz * g2[j];
      const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
      uc = clip01((dx * g3[j] + dy * g4[j] + dz * g5[j]) * inv);
      vc = clip01((dx * g6[j] + dy * g7[j] + dz * g8[j]) * inv);
    }
    const float* g_attr = g_rows + (size_t)kAttr0 * S;
    nx = g_attr[6 * S + j] + uc * g_attr[9 * S + j] + vc * g_attr[12 * S + j];
    ny = g_attr[7 * S + j] + uc * g_attr[10 * S + j] + vc * g_attr[13 * S + j];
    nz = g_attr[8 * S + j] + uc * g_attr[11 * S + j] + vc * g_attr[14 * S + j];
    if (TEX == kTexNone) {
      a0 = g_attr[16 * S + j];
      a1 = g_attr[17 * S + j];
      a2 = g_attr[18 * S + j];
    } else {
      a0 = g_attr[15 * S + j];
      a1 = g_attr[0 * S + j] + uc * g_attr[2 * S + j] + vc * g_attr[4 * S + j];
      a2 = g_attr[1 * S + j] + uc * g_attr[3 * S + j] + vc * g_attr[5 * S + j];
    }
    if (TEX == kTexMip) dens = g_attr[19 * S + j];
  }

  // Two-sided: flip the normal toward the viewer (:2800-2804).
  const float ndotd = nx * dx + ny * dy + nz * dz;
  const float flip = ndotd > 0.f ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;
  const float t_hit = found ? best_t : 0.f;
  const float z = t_hit * cosf_;

  if constexpr (TEX == kTexNine) {
    // The 9-output mode (:2832-2834, :3664-3670), unmasked.
    const size_t o = ((size_t)view * a.height + py) * a.width + px;
    const size_t plane = (size_t)gridDim.x * a.height * a.width;
    a.depth[o] = t_hit;
    a.segmask[o] = best_idx;
    a.code[o] = (int)a0;
    a.handoff[o] = z;
    a.handoff[plane + o] = a1;
    a.handoff[2 * plane + o] = a2;
    a.handoff[3 * plane + o] = nx;
    a.handoff[4 * plane + o] = ny;
    a.handoff[5 * plane + o] = nz;
    return;
  }

  // K8: one any-hit sweep per directional light from the hit point
  // (:2847-2999), every cluster in index order, each gate the tile's.
  uint32_t occ_mask = 0;
  if constexpr (SHADOWS) {
    const float hx = ox + t_hit * dx;
    const float hy = oy + t_hit * dy;
    const float hz = oz + t_hit * dz;
    const float eps_sh = kShadowEps * (1.0f + t_hit);
    for (int li = 0; li < a.n_lights; ++li) {
      const float* l = s_cam + kCamLight0 + 6 * li;
      const float sdx = -l[0], sdy = -l[1], sdz = -l[2];
      const float ivsx = 1.0f / safe_dir(sdx);
      const float ivsy = 1.0f / safe_dir(sdy);
      const float ivsz = 1.0f / safe_dir(sdz);
      bool occ = false;
      for (int c = 0; c < CC; ++c) {
        const float t1x = (s_cl[0 * CC + c] - hx) * ivsx;
        const float t2x = (s_cl[3 * CC + c] - hx) * ivsx;
        const float t1y = (s_cl[1 * CC + c] - hy) * ivsy;
        const float t2y = (s_cl[4 * CC + c] - hy) * ivsy;
        const float t1z = (s_cl[2 * CC + c] - hz) * ivsz;
        const float t2z = (s_cl[5 * CC + c] - hz) * ivsz;
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        const bool possible = (tmax >= tmin) && (tmax > 0.f) && !occ;
        if (!group_or(bar, possible) || !(s_cl[6 * CC + c] > 0.f)) continue;
        const int base = c * cs;
        const int cnt = (int)s_cl[7 * CC + c];
        for (int i = base; i < base + cnt; ++i) {
          const float e1x = g3[i], e1y = g4[i], e1z = g5[i];
          const float e2x = g6[i], e2y = g7[i], e2z = g8[i];
          float h[7];
          h[0] = hx - g0[i];
          h[1] = hy - g1[i];
          h[2] = hz - g2[i];
          h[3] = h[1] * e1z - h[2] * e1y;
          h[4] = h[2] * e1x - h[0] * e1z;
          h[5] = h[0] * e1y - h[1] * e1x;
          h[6] = e2x * h[3] + e2y * h[4] + e2z * h[5];
          float u, v, t;
          pvec_test(sdx, sdy, sdz, e1x, e1y, e1z, e2x, e2y, e2z, h, 1, u, v, t);
          occ = occ || ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > eps_sh));
        }
      }
      if (occ) occ_mask |= 1u << li;
    }
    if (!inside) return;
  }

  // Base colour, lambert over the lights and the fused export, as
  // render_body's (:3015-3050, :3186-3202).
  float br = a0, bg = a1, bb = a2;
  if (TEX == kTexNearest || TEX == kTexBilinear)
    textured_base<TEX>(a.mats, a.pool, a.n_mats, (int)a0, a1, a2, br, bg, bb);
  const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kTiny));
  float sr = 0.f, sg = 0.f, sb = 0.f;
  for (int li = 0; li < a.n_lights; ++li) {
    const float* l = s_cam + kCamLight0 + 6 * li;
    float nd = fmaxf(-(nx * l[0] + ny * l[1] + nz * l[2]) * n_inv, 0.f);
    if (SHADOWS && ((occ_mask >> li) & 1u)) nd = 0.f;
    sr = sr + nd * l[3];
    sg = sg + nd * l[4];
    sb = sb + nd * l[5];
  }
  const bool shaded_hit = RASTER ? found && z < s_cam[kCamFarZ] : found;
  const bool cam_ok = s_cam[kCamLight0 + 6 * a.n_lights] > 0.f;
  const bool hit = shaded_hit && cam_ok;
  const size_t o = ((size_t)view * a.height + py) * a.width + px;
  if (TEX == kTexMip) {
    // The hand-off to csrc/shade_mip.cu (:3237).
    const size_t plane = (size_t)gridDim.x * a.height * a.width;
    a.depth[o] = hit ? (RASTER ? z : best_t) : 0.f;
    a.segmask[o] = hit && !RASTER ? best_idx / a.seg_div : -1;
    a.code[o] = (int)a0 | (found ? kFoundBit : 0) | (shaded_hit ? kShadedBit : 0);
    a.handoff[o] = a1;
    a.handoff[plane + o] = a2;
    a.handoff[2 * plane + o] = t_hit * a.two_over_h * tan_y * dens;
    a.handoff[3 * plane + o] = sr;
    a.handoff[4 * plane + o] = sg;
    a.handoff[5 * plane + o] = sb;
    return;
  }
  const uint32_t packed = quantize(br, sr, shaded_hit) | (quantize(bg, sg, shaded_hit) << 8) |
                          (quantize(bb, sb, shaded_hit) << 16) | kAlpha;
  if (RASTER) {
    a.depth[o] = hit ? z : 0.f;
    a.segmask[o] = -1;
  } else {
    a.depth[o] = hit ? best_t : 0.f;
    a.segmask[o] = hit ? best_idx / a.seg_div : -1;
  }
  a.rgb[o] = cam_ok ? packed : kAlpha;
}

// A tile team's named-barrier OR over its N threads: bar.red.or.pred on
// barrier `id` (the parent's __syncthreads_or over its 16x16 block).
template <int N>
__device__ __forceinline__ bool team_or(int id, bool p) {
  int r;
  asm volatile(
      "{\n\t.reg .pred pi, po;\n\t"
      "setp.ne.s32 pi, %1, 0;\n\t"
      "bar.red.or.pred po, %2, %3, pi;\n\t"
      "selp.s32 %0, 1, 0, po;\n\t}\n"
      : "=r"(r)
      : "r"((int)p), "r"(id), "n"(N)
      : "memory");
  return r != 0;
}

// bar.sync on the named barrier `id` over N threads.
template <int N>
__device__ __forceinline__ void team_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// K7 folded: a hit pixel's material, uv and footprint, and its normal,
// resolved from its record and attribute rows with index_tile's and
// render_body's expressions on the ray of pixel (px, py) traced again
// (pixel_ray: the same bits), for the keys and the sample pass.
struct MipHit {
  int mat;
  float u, v, fp, nx, ny, nz, dx, dy, dz;
};

// The ray of pixel (px, py) from the camera row (raytrace_pallas.py:1180-1188),
// render_body's expressions: index_tile's and shadow_tile's rays, and the
// K7 passes' that trace a pixel's ray again rather than keep it (the same
// bits).
__device__ __forceinline__ void pixel_ray(const RenderArgs& a, const float* s_cam, int px,
                                          int py, float& dx, float& dy, float& dz) {
  const float ra = (((float)px + 0.5f) * a.two_over_w - 1.0f) * s_cam[12];
  const float rb = (1.0f - ((float)py + 0.5f) * a.two_over_h) * s_cam[13];
  const float x = ra * s_cam[3] + s_cam[6] + rb * s_cam[9];
  const float y = ra * s_cam[4] + s_cam[7] + rb * s_cam[10];
  const float z = ra * s_cam[5] + s_cam[8] + rb * s_cam[11];
  const float inv_len = 1.0f / sqrtf(x * x + y * y + z * z);
  dx = x * inv_len;
  dy = y * inv_len;
  dz = z * inv_len;
}

// Lambert + ambient's sums over the lights (:3015-3035) for the normal
// (nx, ny, nz), flipped toward the viewer first (:2800-2804); an occluded
// light (bit li of occ_mask) adds nothing (:3030-3032).
__device__ __forceinline__ void lambert(const RenderArgs& a, const float* s_cam, float nx,
                                        float ny, float nz, float dx, float dy, float dz,
                                        uint32_t occ_mask, float& sr, float& sg, float& sb) {
  const float ndotd = nx * dx + ny * dy + nz * dz;
  const float flip = ndotd > 0.f ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;
  const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kTiny));
  sr = 0.f;
  sg = 0.f;
  sb = 0.f;
  for (int li = 0; li < a.n_lights; ++li) {
    const float* l = s_cam + kCamLight0 + 6 * li;
    float nd = fmaxf(-(nx * l[0] + ny * l[1] + nz * l[2]) * n_inv, 0.f);
    if ((occ_mask >> li) & 1u) nd = 0.f;
    sr = sr + nd * l[3];
    sg = sg + nd * l[4];
    sb = sb + nd * l[5];
  }
}

__device__ __forceinline__ void mip_hit(const RenderArgs& a, const float4* s_rec,
                                        const float* attr, const float* s_cam, int px, int py,
                                        int j, float best_t, MipHit& h) {
  const int S = a.S;
  pixel_ray(a, s_cam, px, py, h.dx, h.dy, h.dz);
  const float4 r0 = s_rec[3 * j], r1 = s_rec[3 * j + 1], r2 = s_rec[3 * j + 2];
  const float det = h.dx * r0.x + h.dy * r0.y + h.dz * r0.z;
  const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
  const float uc = clip01((h.dx * r1.x + h.dy * r1.y + h.dz * r1.z) * inv);
  const float vc = clip01((h.dx * r2.x + h.dy * r2.y + h.dz * r2.z) * inv);
  h.nx = attr[6 * S + j] + uc * attr[9 * S + j] + vc * attr[12 * S + j];
  h.ny = attr[7 * S + j] + uc * attr[10 * S + j] + vc * attr[13 * S + j];
  h.nz = attr[8 * S + j] + uc * attr[11 * S + j] + vc * attr[14 * S + j];
  h.mat = (int)attr[15 * S + j];
  h.u = attr[0 * S + j] + uc * attr[2 * S + j] + vc * attr[4 * S + j];
  h.v = attr[1 * S + j] + uc * attr[3 * S + j] + vc * attr[5 * S + j];
  // The footprint t * (2 / height) * tan_y * density (:3237).
  h.fp = best_t * a.two_over_h * s_cam[13] * attr[19 * S + j];
}

// One 16x16 tile of K1's index visit, walked by one tile team of
// 256 / PIX threads (named barrier `bar`), a thread the pixels of rows
// r, r + 16 / PIX, ... (PIX of them) of its column, so that each record's
// three shared loads serve PIX tests. Each cluster in index order: the
// block's validity, then the slab test (K1's own predicate, no slack, on
// the view's gate terms lo - o and hi - o: the subtractions K1 makes per
// thread) as an OR over the tile's 256 pixels (the team's barrier: the
// parent's 16x16 tile), then the tile's sweep of the valid prefix from the
// records, the first minimum in index order (strict <: the lowest index
// keeps an exact tie). The resolve reads the winner's record and its
// attribute rows (`attr`, device memory), each expression as render_body
// computes it. TEX = mip (K7 folded): the tile writes depth and segmask
// and holds each pixel's winner (best_t, best_idx) in shared memory
// (VisitCtl::mip_hold) for the view's keys and sample passes (mip_keys,
// mip_pass); no rgb. TEX = nine (K1's 9-output mode, its entry in
// csrc/render_none.cu): the resolve's t, idx, material, z, uv and flipped
// normal, written unmasked. CULL false (K1-none, no cluster table): no
// gates, every slot of the world swept in index order. RASTER (K2, K2+K6:
// the raster conventions, render_body's :827-830, :1248-1250, :1404-1431):
// each pixel's t-space near bound near / max(cos, 1e-6) in the sweep's test
// (the gates keep the scalar near: they only over-visit), and the resolve's
// camera-plane z = t * cos, the z-space far clip on the shading's hit, depth
// z or 0, segmask -1.
template <int TEX, int PIX, bool CULL = true, bool RASTER = false>
__device__ __forceinline__ void index_tile(const RenderArgs& a, const float4* s_rec,
                                           const float* attr, const float* s_cl,
                                           const float* s_gate, const float* s_cam, int view,
                                           int tile, int bar) {
  constexpr int kTeam = kThreads / PIX;
  constexpr int kRowStep = kTileY / PIX;
  const int S = a.S, CC = a.CC, cs = a.cluster_size;
  const int tt = (threadIdx.y * kTileX + threadIdx.x) % kTeam;
  const int px = (tile % a.tiles_x) * kTileX + tt % kTileX;
  const int py0 = (tile / a.tiles_x) * kTileY + tt / kTileX;

  const float near = s_cam[14], far = s_cam[15];

  // Ray generation of each of the thread's pixels. Pixels past the image
  // edge trace their ray too: they take part in their tile's gates and
  // write nothing.
  float dx[PIX], dy[PIX], dz[PIX], ivx[PIX], ivy[PIX], ivz[PIX], best_t[PIX];
  int best_idx[PIX];
  // Raster: each pixel's lower bound on t (a fragment with z < znear is
  // clipped before the depth test); the scalar near otherwise.
  [[maybe_unused]] float t_lo[PIX];
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    pixel_ray(a, s_cam, px, py0 + kRowStep * q, dx[q], dy[q], dz[q]);
    if constexpr (RASTER)
      t_lo[q] = near / fmaxf(dx[q] * s_cam[6] + dy[q] * s_cam[7] + dz[q] * s_cam[8], kCosFloor);
    ivx[q] = 1.0f / safe_dir(dx[q]);
    ivy[q] = 1.0f / safe_dir(dy[q]);
    ivz[q] = 1.0f / safe_dir(dz[q]);
    best_t[q] = far;
    best_idx[q] = -1;
  }

  if constexpr (CULL) {
    for (int c = 0; c < CC; ++c) {
      MRT_PHASE(1);
      if (!(s_cl[6 * CC + c] > 0.f)) continue;  // the block's: no vote
      const float lx = s_gate[0 * CC + c], ly = s_gate[1 * CC + c], lz = s_gate[2 * CC + c];
      const float hx = s_gate[3 * CC + c], hy = s_gate[4 * CC + c], hz = s_gate[5 * CC + c];
      bool possible = false;
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        // The slab test (:1671-1697) with the scalar near.
        const float t1x = lx * ivx[q];
        const float t2x = hx * ivx[q];
        const float t1y = ly * ivy[q];
        const float t2y = hy * ivy[q];
        const float t1z = lz * ivz[q];
        const float t2z = hz * ivz[q];
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        possible = possible || ((tmax >= tmin) && (tmax > near) && (tmin < best_t[q]));
      }
      if (!team_or<kTeam>(bar, possible)) continue;
      MRT_PHASE(2);
      const int base = c * cs;
      const int cnt = (int)s_cl[7 * CC + c];
      for (int i = base; i < base + cnt; ++i) {
        // Möller–Trumbore on the pack-time rows (:1296-1316).
        const float4 r0 = s_rec[3 * i], r1 = s_rec[3 * i + 1], r2 = s_rec[3 * i + 2];
#pragma unroll
        for (int q = 0; q < PIX; ++q) {
          const float det = dx[q] * r0.x + dy[q] * r0.y + dz[q] * r0.z;
          const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
          const float u = (dx[q] * r1.x + dy[q] * r1.y + dz[q] * r1.z) * inv;
          const float v = (dx[q] * r2.x + dy[q] * r2.y + dz[q] * r2.z) * inv;
          const float t = r0.w * inv;
          const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                          (t > (RASTER ? t_lo[q] : near)) && (t < best_t[q]);
          best_t[q] = ok ? t : best_t[q];
          best_idx[q] = ok ? i : best_idx[q];
        }
      }
    }
  } else {
    // K1-none (the JAX non-culled launch, :4911): every slot in index
    // order. A dead slot (record 1's w 0: D = 0 where near >= 0, so that
    // det = 0, inv = 0 and t = 0 fails t > near for every ray) is skipped:
    // the same first minimum. The test is a copy of the culled sweep's:
    // ptxas's register allocation of K1's entry moves with its source's
    // shape.
    MRT_PHASE(2);
    for (int i = 0; i < S; ++i) {
      const float4 r1 = s_rec[3 * i + 1];
      if (r1.w == 0.f) continue;
      const float4 r0 = s_rec[3 * i], r2 = s_rec[3 * i + 2];
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        const float det = dx[q] * r0.x + dy[q] * r0.y + dz[q] * r0.z;
        const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
        const float u = (dx[q] * r1.x + dy[q] * r1.y + dz[q] * r1.z) * inv;
        const float v = (dx[q] * r2.x + dy[q] * r2.y + dz[q] * r2.z) * inv;
        const float t = r0.w * inv;
        const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > near) &&
                        (t < best_t[q]);
        best_t[q] = ok ? t : best_t[q];
        best_idx[q] = ok ? i : best_idx[q];
      }
    }
  }
  MRT_PHASE(3);

  const bool cam_ok = s_cam[kCamLight0 + 6 * a.n_lights] > 0.f;
  if constexpr (TEX == kTexMip) {
    // K7 folded: depth and segmask as the hand-off mode writes them, and
    // each pixel's winner held for the view's passes.
    extern __shared__ __align__(16) float smem[];
    float* s_hold = smem + reinterpret_cast<const VisitCtl*>(smem)->mip_hold;
    const int P = a.height * a.width;
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      const int py = py0 + kRowStep * q;
      if (px >= a.width || py >= a.height) continue;
      const int j = best_idx[q];
      const bool hit = j >= 0 && cam_ok;
      const size_t o = ((size_t)view * a.height + py) * a.width + px;
      a.depth[o] = hit ? best_t[q] : 0.f;
      a.segmask[o] = hit ? j / a.seg_div : -1;
      s_hold[py * a.width + px] = best_t[q];
      reinterpret_cast<int*>(s_hold)[P + py * a.width + px] = j;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int py = py0 + kRowStep * q;
    if (px >= a.width || py >= a.height) continue;
    // Winner resolve (:2725-2793): the clipped barycentrics from its record,
    // the attributes by its index.
    float nx = 0.f, ny = 0.f, nz = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
    const int j = best_idx[q];
    const bool found = j >= 0;
    if (found) {
      const float4 r0 = s_rec[3 * j], r1 = s_rec[3 * j + 1], r2 = s_rec[3 * j + 2];
      const float det = dx[q] * r0.x + dy[q] * r0.y + dz[q] * r0.z;
      const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
      const float uc = clip01((dx[q] * r1.x + dy[q] * r1.y + dz[q] * r1.z) * inv);
      const float vc = clip01((dx[q] * r2.x + dy[q] * r2.y + dz[q] * r2.z) * inv);
      nx = attr[6 * S + j] + uc * attr[9 * S + j] + vc * attr[12 * S + j];
      ny = attr[7 * S + j] + uc * attr[10 * S + j] + vc * attr[13 * S + j];
      nz = attr[8 * S + j] + uc * attr[11 * S + j] + vc * attr[14 * S + j];
      if (TEX == kTexNone) {
        a0 = attr[16 * S + j];
        a1 = attr[17 * S + j];
        a2 = attr[18 * S + j];
      } else {
        a0 = attr[15 * S + j];
        a1 = attr[0 * S + j] + uc * attr[2 * S + j] + vc * attr[4 * S + j];
        a2 = attr[1 * S + j] + uc * attr[3 * S + j] + vc * attr[5 * S + j];
      }
    }
    if constexpr (TEX == kTexNine) {
      // The 9-output mode, render_body's (:2832-2834, :3664-3670): t (0 on
      // a miss), idx, the material, z = t * cos and uv and the normal
      // flipped toward the viewer, unmasked; a warp's two 16-pixel rows of
      // each plane, 64-byte runs, as the parent writes them.
      const float ndotd = nx * dx[q] + ny * dy[q] + nz * dz[q];
      const float flip = ndotd > 0.f ? -1.0f : 1.0f;
      const float t_hit = found ? best_t[q] : 0.f;
      const float z = t_hit * (dx[q] * s_cam[6] + dy[q] * s_cam[7] + dz[q] * s_cam[8]);
      const size_t o = ((size_t)view * a.height + py) * a.width + px;
      const size_t plane = (size_t)gridDim.x * a.height * a.width;
      a.depth[o] = t_hit;
      a.segmask[o] = j;
      a.code[o] = (int)a0;
      a.handoff[o] = z;
      a.handoff[plane + o] = a1;
      a.handoff[2 * plane + o] = a2;
      a.handoff[3 * plane + o] = nx * flip;
      a.handoff[4 * plane + o] = ny * flip;
      a.handoff[5 * plane + o] = nz * flip;
      continue;
    }
    // Base colour, lambert over the lights (the normal flipped toward the
    // viewer) and the fused export, as render_body's (:3015-3050,
    // :3186-3202).
    float br = a0, bg = a1, bb = a2;
    if (TEX == kTexNearest || TEX == kTexBilinear)
      textured_base<TEX>(a.mats, a.pool, a.n_mats, (int)a0, a1, a2, br, bg, bb);
    float sr, sg, sb;
    lambert(a, s_cam, nx, ny, nz, dx[q], dy[q], dz[q], 0u, sr, sg, sb);
    if constexpr (RASTER) {
      // The raster export: z = t * cos (:2806-2807), the shading's hit
      // clipped at the camera's z-space far plane.
      const float t_hit = found ? best_t[q] : 0.f;
      const float z = t_hit * (dx[q] * s_cam[6] + dy[q] * s_cam[7] + dz[q] * s_cam[8]);
      const bool shaded_hit = found && z < s_cam[kCamFarZ];
      const uint32_t packed = quantize(br, sr, shaded_hit) | (quantize(bg, sg, shaded_hit) << 8) |
                              (quantize(bb, sb, shaded_hit) << 16) | kAlpha;
      const size_t o = ((size_t)view * a.height + py) * a.width + px;
      a.depth[o] = shaded_hit && cam_ok ? z : 0.f;
      a.segmask[o] = -1;
      a.rgb[o] = cam_ok ? packed : kAlpha;
      continue;
    }
    const bool hit = found && cam_ok;
    const uint32_t packed = quantize(br, sr, found) | (quantize(bg, sg, found) << 8) |
                            (quantize(bb, sb, found) << 16) | kAlpha;
    const size_t o = ((size_t)view * a.height + py) * a.width + px;
    a.depth[o] = hit ? best_t[q] : 0.f;
    a.segmask[o] = hit ? j / a.seg_div : -1;
    a.rgb[o] = cam_ok ? packed : kAlpha;
  }
}

// K7 folded, the view's keys pass: the block's threads take the view's
// pixels in turn; each hit, resolved again from its held winner (mip_hit),
// lowers its TPU tile's two window keys (s_keys: pref, anyf a tile,
// shared-memory integer minima, so the order of the threads does not
// matter; :3330-3336).
template <int FILTER>
__device__ __forceinline__ void mip_keys(const RenderArgs& a, const MipArgs& mp,
                                         const float4* s_rec, const float* attr,
                                         const float* s_cam, int* s_keys, const float* s_hold,
                                         int tid, int n_thr) {
  const int P = a.height * a.width;
  for (int p = tid; p < P; p += n_thr) {
    MRT_PHASE(7);
    const int j = reinterpret_cast<const int*>(s_hold)[P + p];
    if (j < 0) continue;  // a miss takes no part
    const int px = p % a.width, py = p / a.width;
    MipHit h;
    mip_hit(a, s_rec, attr, s_cam, px, py, j, s_hold[p], h);
    int pref = kMipBig, anyf = kMipBig;
    window_keys<FILTER != kMipNearest>(a.mats, a.n_mats, mp, h.mat, h.u, h.v, h.fp, pref,
                                       anyf);
    int* key = s_keys + 2 * tpu_tile(mp, px, py, a.width);
    if (pref < kMipBig) atomicMin(key, pref);
    if (anyf < kMipBig) atomicMin(key + 1, anyf);
  }
}

// K7 folded, the view's sample pass: after every team has walked every
// tile of the view and the keys pass (so every TPU tile's keys are final), the block's
// threads take the view's pixels in turn: the clamp, the sample and the
// packed rgb from the tile's window base (mip_base, as csrc/shade_mip.cu's
// second pass), the hit's uv, footprint and lambert sums resolved again
// from its held winner, record and attribute rows (mip_hit).
template <int FILTER>
__device__ __forceinline__ void mip_pass(const RenderArgs& a, const MipArgs& mp,
                                         const float4* s_rec, const float* attr,
                                         const float* s_cam, const int* s_keys,
                                         const float* s_hold, int view, int tid, int n_thr) {
  const int S = a.S, P = a.height * a.width;
  const bool cam_ok = s_cam[kCamLight0 + 6 * a.n_lights] > 0.f;
  uint32_t* rgb = a.rgb + (size_t)view * P;
  for (int p = tid; p < P; p += n_thr) {
    MRT_PHASE(7);
    const int px = p % a.width, py = p / a.width;
    const int j = reinterpret_cast<const int*>(s_hold)[P + p];
    // A pixel that shades nothing packs to opaque black.
    if (!cam_ok || j < 0) {
      rgb[p] = kAlpha;
      continue;
    }
    MipHit h;
    mip_hit(a, s_rec, attr, s_cam, px, py, j, s_hold[p], h);
    float sr, sg, sb;
    lambert(a, s_cam, h.nx, h.ny, h.nz, h.dx, h.dy, h.dz, 0u, sr, sg, sb);
    const int* key = s_keys + 2 * tpu_tile(mp, px, py, a.width);
    float br, bg, bb;
    mip_base<FILTER>(a.mats, a.pool, a.n_mats, mp, h.mat, true, h.u, h.v, h.fp,
                     window_base(key[0], key[1]), br, bg, bb);
    rgb[p] = quantize(br, sr) | (quantize(bg, sg) << 8) | (quantize(bb, sb) << 16) | kAlpha;
  }
}

// K8's tile on the index visit's tile teams (GEO = raw_shadows, raytraced,
// untextured or nearest or bilinear): one 16x16 tile walked by a team of
// 256 / PIX threads (named barrier `bar`), PIX pixels a thread as
// index_tile takes them. The records (four float4 a triangle: e1 and t_num,
// e2 and v0.x, tv and v0.y, q and v0.z, with this view's tv = o - v0,
// q = tv x e1 and t_num = e2 . q, formed once a view) serve the primary
// pvec test; s_sh holds, per (light, triangle), pvec = sd x e2 and
// inv = 1/det (0 where |det| <= eps), formed once a view with pvec_test's
// expressions, so the shadow test makes only the hit point's terms. The
// order of the work keeps the registers small: the primary sweep (K1's
// gates on the view's gate terms), the hit points, then per light the
// any-hit sweep (the shadow ray's slab test from the hit point, tmax > 0,
// pixels occluded, missed or past the image out of the team's OR; the
// tests against t > 1e-3 * (1 + t)), holding only the hit point, eps and
// the occlusion bits; then each pixel's ray again, the winner's (u, v) from
// its record (pvec_test's expressions on the values the parent's sweep
// tested: the same bits as the carried pair), its attributes, the lambert
// and the fused export, as render_body computes them. SHADOWS false
// (K1-raw, GEO = raw: the same records, no s_sh): the primary sweep and the
// resolve alone, each pixel's ray kept from the sweep.
template <int TEX, int PIX, bool SHADOWS = true>
__device__ __forceinline__ void shadow_tile(const RenderArgs& a, const float4* s_rec,
                                            const float4* s_sh, const float* attr,
                                            const float* s_cl, const float* s_gate,
                                            const float* s_cam, int view, int tile, int bar) {
  constexpr int kTeam = kThreads / PIX;
  constexpr int kRowStep = kTileY / PIX;
  const int S = a.S, CC = a.CC, cs = a.cluster_size;
  const int tt = (threadIdx.y * kTileX + threadIdx.x) % kTeam;
  const int px = (tile % a.tiles_x) * kTileX + tt % kTileX;
  const int py0 = (tile / a.tiles_x) * kTileY + tt / kTileX;
  const float ox = s_cam[0], oy = s_cam[1], oz = s_cam[2];
  const float near = s_cam[14], far = s_cam[15];

  float best_t[PIX], hx[PIX], hy[PIX], hz[PIX], eps_sh[PIX];
  int best_idx[PIX];
  [[maybe_unused]] float rx[PIX], ry[PIX], rz[PIX];  // K1-raw: the rays, for the resolve
  {
    float dx[PIX], dy[PIX], dz[PIX], ivx[PIX], ivy[PIX], ivz[PIX];
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      pixel_ray(a, s_cam, px, py0 + kRowStep * q, dx[q], dy[q], dz[q]);
      ivx[q] = 1.0f / safe_dir(dx[q]);
      ivy[q] = 1.0f / safe_dir(dy[q]);
      ivz[q] = 1.0f / safe_dir(dz[q]);
      best_t[q] = far;
      best_idx[q] = -1;
    }
    for (int c = 0; c < CC; ++c) {
      MRT_PHASE(1);
      if (!(s_cl[6 * CC + c] > 0.f)) continue;  // the block's: no vote
      const float lx = s_gate[0 * CC + c], ly = s_gate[1 * CC + c], lz = s_gate[2 * CC + c];
      const float ux = s_gate[3 * CC + c], uy = s_gate[4 * CC + c], uz = s_gate[5 * CC + c];
      bool possible = false;
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        // The slab test (:1671-1697) with the scalar near.
        const float t1x = lx * ivx[q];
        const float t2x = ux * ivx[q];
        const float t1y = ly * ivy[q];
        const float t2y = uy * ivy[q];
        const float t1z = lz * ivz[q];
        const float t2z = uz * ivz[q];
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        possible = possible || ((tmax >= tmin) && (tmax > near) && (tmin < best_t[q]));
      }
      if (!team_or<kTeam>(bar, possible)) continue;
      MRT_PHASE(2);
      const int base = c * cs;
      const int cnt = (int)s_cl[7 * CC + c];
      for (int i = base; i < base + cnt; ++i) {
        // The pvec test on the view's tv, q, t_num (:1373-1380).
        const float4 r0 = s_rec[4 * i], r1 = s_rec[4 * i + 1];
        const float4 r2 = s_rec[4 * i + 2], r3 = s_rec[4 * i + 3];
#pragma unroll
        for (int q = 0; q < PIX; ++q) {
          const float pvx = dy[q] * r1.z - dz[q] * r1.y;
          const float pvy = dz[q] * r1.x - dx[q] * r1.z;
          const float pvz = dx[q] * r1.y - dy[q] * r1.x;
          const float det = r0.x * pvx + r0.y * pvy + r0.z * pvz;
          const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
          const float u = (r2.x * pvx + r2.y * pvy + r2.z * pvz) * inv;
          const float v = (dx[q] * r3.x + dy[q] * r3.y + dz[q] * r3.z) * inv;
          const float t = r0.w * inv;
          const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                          (t > near) && (t < best_t[q]);
          best_t[q] = ok ? t : best_t[q];
          best_idx[q] = ok ? i : best_idx[q];
        }
      }
    }
    MRT_PHASE(3);
    if constexpr (SHADOWS) {
      // The hit points (t = 0 on a miss, :2847-2860).
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        const float t_hit = best_idx[q] >= 0 ? best_t[q] : 0.f;
        hx[q] = ox + t_hit * dx[q];
        hy[q] = oy + t_hit * dy[q];
        hz[q] = oz + t_hit * dz[q];
        eps_sh[q] = kShadowEps * (1.0f + t_hit);
      }
    } else {
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        rx[q] = dx[q];
        ry[q] = dy[q];
        rz[q] = dz[q];
      }
    }
  }

  // K8: one any-hit sweep per directional light, bit li of occ_mask set
  // when light li is occluded.
  uint32_t occ_mask[PIX];
#pragma unroll
  for (int q = 0; q < PIX; ++q) occ_mask[q] = 0;
  for (int li = 0; li < (SHADOWS ? a.n_lights : 0); ++li) {
    const float* l = s_cam + kCamLight0 + 6 * li;
    const float sdx = -l[0], sdy = -l[1], sdz = -l[2];
    const float ivsx = 1.0f / safe_dir(sdx);
    const float ivsy = 1.0f / safe_dir(sdy);
    const float ivsz = 1.0f / safe_dir(sdz);
    const float4* sh = s_sh + (size_t)li * S;
    // A miss's and an outside pixel's occlusion is dead: it stays out.
    bool occ[PIX];
#pragma unroll
    for (int q = 0; q < PIX; ++q)
      occ[q] = best_idx[q] < 0 || px >= a.width || py0 + kRowStep * q >= a.height;
    for (int c = 0; c < CC; ++c) {
      MRT_PHASE(5);
      if (!(s_cl[6 * CC + c] > 0.f)) continue;
      const float lx = s_cl[0 * CC + c], ly = s_cl[1 * CC + c], lz = s_cl[2 * CC + c];
      const float ux = s_cl[3 * CC + c], uy = s_cl[4 * CC + c], uz = s_cl[5 * CC + c];
      bool possible = false;
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        // The shadow ray's slab test (:2930-2948).
        const float t1x = (lx - hx[q]) * ivsx;
        const float t2x = (ux - hx[q]) * ivsx;
        const float t1y = (ly - hy[q]) * ivsy;
        const float t2y = (uy - hy[q]) * ivsy;
        const float t1z = (lz - hz[q]) * ivsz;
        const float t2z = (uz - hz[q]) * ivsz;
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        possible = possible || ((tmax >= tmin) && (tmax > 0.f) && !occ[q]);
      }
      if (!team_or<kTeam>(bar, possible)) continue;
      MRT_PHASE(6);
      const int base = c * cs;
      const int cnt = (int)s_cl[7 * CC + c];
      for (int i = base; i < base + cnt; ++i) {
        // The any-hit test along the light (:2885-2903) on the hoisted
        // pvec and inv: tv = p - v0, q = tv x e1, then u, v, t.
        const float4 r0 = s_rec[4 * i], r1 = s_rec[4 * i + 1];
        const float4 r2 = s_rec[4 * i + 2], r3 = s_rec[4 * i + 3];
        const float4 pv = sh[i];
#pragma unroll
        for (int q = 0; q < PIX; ++q) {
          const float h0 = hx[q] - r1.w;
          const float h1 = hy[q] - r2.w;
          const float h2 = hz[q] - r3.w;
          const float h3 = h1 * r0.z - h2 * r0.y;
          const float h4 = h2 * r0.x - h0 * r0.z;
          const float h5 = h0 * r0.y - h1 * r0.x;
          const float h6 = r1.x * h3 + r1.y * h4 + r1.z * h5;
          const float u = (h0 * pv.x + h1 * pv.y + h2 * pv.z) * pv.w;
          const float v = (sdx * h3 + sdy * h4 + sdz * h5) * pv.w;
          const float t = h6 * pv.w;
          occ[q] = occ[q] ||
                   ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > eps_sh[q]));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < PIX; ++q) occ_mask[q] |= occ[q] ? 1u << li : 0u;
  }
  MRT_PHASE(3);

  const bool cam_ok = s_cam[kCamLight0 + 6 * a.n_lights] > 0.f;
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int py = py0 + kRowStep * q;
    if (px >= a.width || py >= a.height) continue;
    float dx, dy, dz;
    if constexpr (SHADOWS) {
      pixel_ray(a, s_cam, px, py, dx, dy, dz);
    } else {
      dx = rx[q];
      dy = ry[q];
      dz = rz[q];
    }
    // Winner resolve (:2725-2793): (u, v) from its record, the attributes
    // by its index.
    float nx = 0.f, ny = 0.f, nz = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
    const int j = best_idx[q];
    const bool found = j >= 0;
    if (found) {
      const float4 r0 = s_rec[4 * j], r1 = s_rec[4 * j + 1];
      const float4 r2 = s_rec[4 * j + 2], r3 = s_rec[4 * j + 3];
      const float pvx = dy * r1.z - dz * r1.y;
      const float pvy = dz * r1.x - dx * r1.z;
      const float pvz = dx * r1.y - dy * r1.x;
      const float det = r0.x * pvx + r0.y * pvy + r0.z * pvz;
      const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
      const float uc = clip01((r2.x * pvx + r2.y * pvy + r2.z * pvz) * inv);
      const float vc = clip01((dx * r3.x + dy * r3.y + dz * r3.z) * inv);
      nx = attr[6 * S + j] + uc * attr[9 * S + j] + vc * attr[12 * S + j];
      ny = attr[7 * S + j] + uc * attr[10 * S + j] + vc * attr[13 * S + j];
      nz = attr[8 * S + j] + uc * attr[11 * S + j] + vc * attr[14 * S + j];
      if (TEX == kTexNone) {
        a0 = attr[16 * S + j];
        a1 = attr[17 * S + j];
        a2 = attr[18 * S + j];
      } else {
        a0 = attr[15 * S + j];
        a1 = attr[0 * S + j] + uc * attr[2 * S + j] + vc * attr[4 * S + j];
        a2 = attr[1 * S + j] + uc * attr[3 * S + j] + vc * attr[5 * S + j];
      }
    }
    float br = a0, bg = a1, bb = a2;
    if (TEX == kTexNearest || TEX == kTexBilinear)
      textured_base<TEX>(a.mats, a.pool, a.n_mats, (int)a0, a1, a2, br, bg, bb);
    float sr, sg, sb;
    lambert(a, s_cam, nx, ny, nz, dx, dy, dz, occ_mask[q], sr, sg, sb);
    const bool hit = found && cam_ok;
    const uint32_t packed = quantize(br, sr, found) | (quantize(bg, sg, found) << 8) |
                            (quantize(bb, sb, found) << 16) | kAlpha;
    const size_t o = ((size_t)view * a.height + py) * a.width + px;
    a.depth[o] = hit ? best_t[q] : 0.f;
    a.segmask[o] = hit ? j / a.seg_div : -1;
    a.rgb[o] = cam_ok ? packed : kAlpha;
  }
}

// A vertex translated to the ray origin, (x, y, z), sheared by one pixel's
// frame (Shear::shear's expressions): KZ 0, 1 or 2 with that axis fixed
// (the frame's kz known to the whole warp: the same values selected), -1
// with the selects on the pixel's own kz (0: x, 1: y, 2: z).
template <int KZ>
__device__ __forceinline__ void wt_shear(int kz, float sx, float sy, float sz, float x, float y,
                                         float z, float& px, float& py, float& pz) {
  float X, Y, Z;
  if constexpr (KZ == 0) {
    Z = x, X = y, Y = z;
  } else if constexpr (KZ == 1) {
    Z = y, X = z, Y = x;
  } else if constexpr (KZ == 2) {
    Z = z, X = x, Y = y;
  } else {
    Z = kz == 0 ? x : (kz == 1 ? y : z);
    X = kz == 0 ? y : (kz == 1 ? z : x);
    Y = kz == 0 ? z : (kz == 1 ? x : y);
  }
  px = X - sx * Z;
  py = Y - sy * Z;
  pz = sz * Z;
}

// wt_tile's sweep of slots [lo, hi) from K10's records for the thread's PIX
// pixels (kz packed two bits a pixel): the validity (record 0's w; an
// invalid slot is skipped by the whole warp), woop_test's decision, t > near
// and the first minimum in index order (strict <).
template <int KZ, int PIX>
__device__ __forceinline__ void wt_sweep(const float4* s_rec, int lo, int hi, int kz,
                                         const float (&sx)[PIX], const float (&sy)[PIX],
                                         const float (&sz)[PIX], float near,
                                         float (&best_t)[PIX], int (&best_idx)[PIX]) {
  for (int i = lo; i < hi; ++i) {
    const float4 r0 = s_rec[3 * i];
    if (!(r0.w > 0.f)) continue;
    const float4 r1 = s_rec[3 * i + 1], r2 = s_rec[3 * i + 2];
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      const int k = (kz >> (2 * q)) & 3;
      float ax, ay, az, bx, by, bz, cx, cy, cz;
      wt_shear<KZ>(k, sx[q], sy[q], sz[q], r0.x, r0.y, r0.z, ax, ay, az);
      wt_shear<KZ>(k, sx[q], sy[q], sz[q], r1.x, r1.y, r1.z, bx, by, bz);
      wt_shear<KZ>(k, sx[q], sy[q], sz[q], r2.x, r2.y, r2.z, cx, cy, cz);
      const float u = cx * by - cy * bx;
      const float v = ax * cy - ay * cx;
      const float w = bx * ay - by * ax;
      const float det = u + v + w;
      const bool accept = det != 0.f && ((u >= 0.f && v >= 0.f && w >= 0.f) ||
                                         (u <= 0.f && v <= 0.f && w <= 0.f));
      if (accept) {
        const float t = (u * az + v * bz + w * cz) * (1.0f / det);
        if (t > near && t < best_t[q]) {
          best_t[q] = t;
          best_idx[q] = i;
        }
      }
    }
  }
}

// K10's tile on the index visit's tile teams (GEO = raw_wt, raytraced,
// untextured or nearest or bilinear; CULL false: K1-none on the same rows,
// csrc/render_none.cu): one 16x16 tile walked by a team of 256 / PIX
// threads (named barrier `bar`), PIX pixels a thread as index_tile takes
// them. The records (three float4 a triangle: a = v0 - o with the
// validity, b = a + e1, c = a + e2, formed once a view with render_body's
// expressions) serve woop_test's decision; each pixel's shear frame
// (Shear) is formed once a tile. Culled: each cluster in index order, the
// block's validity, then K1's slab test on the view's gate terms as an OR
// over the tile's pixels (the team's barrier), then its valid prefix; not
// culled: every slot of the world. Where all 32 threads of a warp share
// one kz (every pixel of each), the warp sweeps wt_sweep's variant with the
// axis fixed. The resolve traces each pixel's ray again (pixel_ray: the
// same bits), computes the winner's Möller–Trumbore (u, v) from its raw
// rows in device memory (tv, q, t_num, then pvec_test) and its attributes,
// the shading and the fused export, each as render_body computes them.
template <int TEX, int PIX, bool CULL>
__device__ __forceinline__ void wt_tile(const RenderArgs& a, const float4* s_rec,
                                        const float* g_rows, const float* s_cl,
                                        const float* s_gate, const float* s_cam, int view,
                                        int tile, int bar) {
  constexpr int kTeam = kThreads / PIX;
  constexpr int kRowStep = kTileY / PIX;
  const int S = a.S, CC = a.CC, cs = a.cluster_size;
  const int tt = (threadIdx.y * kTileX + threadIdx.x) % kTeam;
  const int px = (tile % a.tiles_x) * kTileX + tt % kTileX;
  const int py0 = (tile / a.tiles_x) * kTileY + tt / kTileX;
  const float near = s_cam[14], far = s_cam[15];

  // Each pixel's ray (past the image edge too: its pixels take part in the
  // gates and write nothing), the slab test's reciprocals and its shear
  // frame.
  float ivx[PIX], ivy[PIX], ivz[PIX], sx[PIX], sy[PIX], sz[PIX], best_t[PIX];
  int best_idx[PIX];
  int kz = 0;
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    float dx, dy, dz;
    pixel_ray(a, s_cam, px, py0 + kRowStep * q, dx, dy, dz);
    ivx[q] = 1.0f / safe_dir(dx);
    ivy[q] = 1.0f / safe_dir(dy);
    ivz[q] = 1.0f / safe_dir(dz);
    const Shear f(dx, dy, dz);
    kz |= (f.kz_x ? 0 : (f.kz_y ? 1 : 2)) << (2 * q);
    sx[q] = f.sx;
    sy[q] = f.sy;
    sz[q] = f.sz;
    best_t[q] = far;
    best_idx[q] = -1;
  }
  // The warp's kz: 0, 1 or 2 where every pixel of its threads has it, else
  // -1 (the selects).
  int kw = kz & 3;
#pragma unroll
  for (int q = 1; q < PIX; ++q) kw = ((kz >> (2 * q)) & 3) == kw ? kw : -1;
  int same;
  __match_all_sync(0xffffffffu, kw, &same);
  kw = same ? kw : -1;
  auto sweep = [&](int lo, int hi) {
    if (kw == 0)
      wt_sweep<0, PIX>(s_rec, lo, hi, kz, sx, sy, sz, near, best_t, best_idx);
    else if (kw == 1)
      wt_sweep<1, PIX>(s_rec, lo, hi, kz, sx, sy, sz, near, best_t, best_idx);
    else if (kw == 2)
      wt_sweep<2, PIX>(s_rec, lo, hi, kz, sx, sy, sz, near, best_t, best_idx);
    else
      wt_sweep<-1, PIX>(s_rec, lo, hi, kz, sx, sy, sz, near, best_t, best_idx);
  };

  if constexpr (CULL) {
    for (int c = 0; c < CC; ++c) {
      MRT_PHASE(1);
      if (!(s_cl[6 * CC + c] > 0.f)) continue;  // the block's: no vote
      const float lx = s_gate[0 * CC + c], ly = s_gate[1 * CC + c], lz = s_gate[2 * CC + c];
      const float hx = s_gate[3 * CC + c], hy = s_gate[4 * CC + c], hz = s_gate[5 * CC + c];
      bool possible = false;
#pragma unroll
      for (int q = 0; q < PIX; ++q) {
        // The slab test (:1671-1697) with the scalar near.
        const float t1x = lx * ivx[q];
        const float t2x = hx * ivx[q];
        const float t1y = ly * ivy[q];
        const float t2y = hy * ivy[q];
        const float t1z = lz * ivz[q];
        const float t2z = hz * ivz[q];
        const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
        const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
        possible = possible || ((tmax >= tmin) && (tmax > near) && (tmin < best_t[q]));
      }
      if (!team_or<kTeam>(bar, possible)) continue;
      MRT_PHASE(2);
      const int base = c * cs;
      sweep(base, base + (int)s_cl[7 * CC + c]);
    }
  } else {
    // K1-none: every slot in index order; padding slots fail through the
    // validity.
    MRT_PHASE(2);
    sweep(0, S);
  }
  MRT_PHASE(3);

  const bool cam_ok = s_cam[kCamLight0 + 6 * a.n_lights] > 0.f;
  const float ox = s_cam[0], oy = s_cam[1], oz = s_cam[2];
  const float* attr = g_rows + (size_t)kAttr0 * S;
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int py = py0 + kRowStep * q;
    if (px >= a.width || py >= a.height) continue;
    float dx, dy, dz;
    pixel_ray(a, s_cam, px, py, dx, dy, dz);
    // Winner resolve (:2725-2793): its Möller–Trumbore (u, v) (:1372-1380)
    // from its raw rows, clipped; the attributes by its index.
    float nx = 0.f, ny = 0.f, nz = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
    const int j = best_idx[q];
    const bool found = j >= 0;
    if (found) {
      const float e1x = g_rows[3 * S + j], e1y = g_rows[4 * S + j], e1z = g_rows[5 * S + j];
      float h[7];
      h[0] = ox - g_rows[j];
      h[1] = oy - g_rows[S + j];
      h[2] = oz - g_rows[2 * S + j];
      h[3] = h[1] * e1z - h[2] * e1y;
      h[4] = h[2] * e1x - h[0] * e1z;
      h[5] = h[0] * e1y - h[1] * e1x;
      h[6] = g_rows[6 * S + j] * h[3] + g_rows[7 * S + j] * h[4] + g_rows[8 * S + j] * h[5];
      float u, v, t;
      pvec_test(dx, dy, dz, e1x, e1y, e1z, g_rows[6 * S + j], g_rows[7 * S + j],
                g_rows[8 * S + j], h, 1, u, v, t);
      const float uc = clip01(u);
      const float vc = clip01(v);
      nx = attr[6 * S + j] + uc * attr[9 * S + j] + vc * attr[12 * S + j];
      ny = attr[7 * S + j] + uc * attr[10 * S + j] + vc * attr[13 * S + j];
      nz = attr[8 * S + j] + uc * attr[11 * S + j] + vc * attr[14 * S + j];
      if (TEX == kTexNone) {
        a0 = attr[16 * S + j];
        a1 = attr[17 * S + j];
        a2 = attr[18 * S + j];
      } else {
        a0 = attr[15 * S + j];
        a1 = attr[0 * S + j] + uc * attr[2 * S + j] + vc * attr[4 * S + j];
        a2 = attr[1 * S + j] + uc * attr[3 * S + j] + vc * attr[5 * S + j];
      }
    }
    // Base colour, lambert over the lights (the normal flipped toward the
    // viewer) and the fused export, as render_body's (:3015-3050,
    // :3186-3202).
    float br = a0, bg = a1, bb = a2;
    if (TEX == kTexNearest || TEX == kTexBilinear)
      textured_base<TEX>(a.mats, a.pool, a.n_mats, (int)a0, a1, a2, br, bg, bb);
    float sr, sg, sb;
    lambert(a, s_cam, nx, ny, nz, dx, dy, dz, 0u, sr, sg, sb);
    const bool hit = found && cam_ok;
    const uint32_t packed = quantize(br, sr, found) | (quantize(bg, sg, found) << 8) |
                            (quantize(bb, sb, found) << 16) | kAlpha;
    const size_t o = ((size_t)view * a.height + py) * a.width + px;
    a.depth[o] = hit ? best_t[q] : 0.f;
    a.segmask[o] = hit ? j / a.seg_div : -1;
    a.rgb[o] = cam_ok ? packed : kAlpha;
  }
}

// A resident visit's block: view blockIdx.x, visit_groups<GEO>() groups of
// 16x16 threads (blockDim (16, 16 G)). The fill, once a view: prep rows
// 0-9 (raw: v0, e1, e2, rows 0-8) by one bulk copy, while the threads copy
// the cluster table, the camera row and (ordered) the order and form the
// gate terms and the raw sweep's tv, q, t_num or K10's a, b, c and
// validity; then each group
// takes tiles from the counter until the view's are gone.
// PIX > 0: K1's index visit (index_tile) on prep rows, its
// groups (1 or 2: blockDim.y / 16) each PIX tile teams of 256 / PIX threads
// (PIX pixels a thread) taking the view's tiles one a team at a time from
// the block's counter. Its fill: the records built by the threads from
// the prep rows, the cluster table, the gate terms and the camera row (no
// bulk copy). TEX = mip (K7 folded, `mp` its tiling, FILTER its filter):
// the TPU tiles' window keys too, and after the last tile a block barrier
// and the view's sample pass (mip_pass); TEX = nine, K1's 9-output mode.
// GEO = raw_shadows (K8, shadow_tile): records of the raw rows with the
// view's tv, q, t_num, and each (light, triangle)'s hoisted pvec and inv;
// GEO = raw (K1-raw), the same records and shadow_tile without its shadow
// sweep. GEO = raw_wt (K10,
// wt_tile): records of the view's a, b, c and the validity. CULL false
// (K1-none on prep or K10 rows, csrc/render_none.cu): no cluster table and
// no gate terms (CC is 0); every tile sweeps every slot.
template <int GEO, bool RASTER, int TEX, bool BINNED, bool SEEDED, int PIX = 0,
          int FILTER = kMipNearest, bool CULL = true>
__device__ __forceinline__ void visit_body(const RenderArgs& a, const int* order,
                                           const BinArgs& bn, const float* seed,
                                           const MipArgs& mp = MipArgs{}) {
  constexpr bool RAW = GEO != kGeoPrep;
  constexpr bool WT = GEO >= kGeoRawWt;
  constexpr bool INDEX = PIX > 0;
  constexpr bool MIP = INDEX && TEX == kTexMip;
  // K8 and K1-raw: the raw sweep's records (shadow_tile, with and without
  // its shadow sweep).
  constexpr bool RAW_TEAMS = INDEX && (GEO == kGeoRawShadows || GEO == kGeoRaw);
  constexpr bool WT_TEAMS = INDEX && GEO == kGeoRawWt;
  static_assert(!INDEX || (!BINNED && !SEEDED &&
                           (GEO == kGeoPrep ||
                            ((GEO == kGeoRaw || GEO == kGeoRawShadows || GEO == kGeoRawWt) &&
                             (TEX == kTexNone || TEX == kTexNearest || TEX == kTexBilinear)))),
                "the index visit: K1 and K6 on prep rows (K7 folded and the 9-output mode "
                "too), K1-raw, K8 and K10");
  static_assert(!INDEX || !RASTER ||
                    (GEO == kGeoPrep && CULL &&
                     (TEX == kTexNone || TEX == kTexNearest || TEX == kTexBilinear)),
                "the index visit in the raster conventions: K2 and K2+K6, prep rows only");
  static_assert(CULL || (INDEX && TEX != kTexMip && (GEO == kGeoPrep || GEO == kGeoRawWt)),
                "K1-none on the teams: prep and K10 rows, untextured, nearest or bilinear");
  constexpr int kBlock = kThreads * visit_groups<GEO>();
  const int S = a.S, CC = a.CC;
  const int n_thr = INDEX ? (int)(blockDim.x * blockDim.y) : kBlock;
  extern __shared__ __align__(16) float smem[];
  MRT_PHASE_BEGIN;
  VisitCtl& ctl = *reinterpret_cast<VisitCtl*>(smem);
  // [smem_geo_rows, S]; the index visit's records.
  float* s_geo = smem + kVisitCtlBytes / sizeof(float);
  float* s_cl = s_geo + (INDEX ? index_record_floats<GEO>(a.n_lights) : smem_geo_rows<GEO>()) *
                           S;                          // [8, CC]
  float* s_gate = s_cl + kClRows * CC;                     // [kGateRows, CC]
  float* s_cam = s_gate + kGateRows * CC;                  // [NCOL]
  int* s_order = reinterpret_cast<int*>(s_cam + a.n_cols);  // [CC] (ordered)
  // K7 folded: the TPU tiles' keys [n_tiles, 2], then the held pixels.
  [[maybe_unused]] int* s_keys = s_order;
  [[maybe_unused]] float* s_hold = reinterpret_cast<float*>(s_keys + 2 * mp.n_tiles);

  const int view = blockIdx.x;
  const int world = view / a.num_cams;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float* g_rows = a.rows + (size_t)world * kPackRows * S;
  const float* g_cl = a.clusters + (size_t)world * kClRows * CC;
  const float* g_cam = a.cams + (size_t)view * a.n_cols;
  if (tid == 0) {
    ctl.next_tile = 0;
    if constexpr (!WT && !INDEX)
      bulk_fill(s_geo, g_rows, (RAW ? kRawRows : kPrepRows) * S * sizeof(float), &ctl.fill_bar);
    if constexpr (MIP) {
      ctl.mip_attr = g_rows + (size_t)kAttr0 * S;
      ctl.mip_hold = (int)(s_hold - smem);
    }
  }
  for (int i = tid; i < kClRows * CC; i += n_thr) s_cl[i] = g_cl[i];
  for (int i = tid; i < a.n_cols; i += n_thr) s_cam[i] = g_cam[i];
  {
    // The gate terms: lo - o, hi - o and (approach_dist2, :1740-1780)
    // d2 * kExitSlack of each cluster for this view's camera origin.
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    for (int c = tid; c < CC; c += n_thr) {
      const float lx = g_cl[0 * CC + c] - ox, ly = g_cl[1 * CC + c] - oy,
                  lz = g_cl[2 * CC + c] - oz;
      const float hx = g_cl[3 * CC + c] - ox, hy = g_cl[4 * CC + c] - oy,
                  hz = g_cl[5 * CC + c] - oz;
      s_gate[0 * CC + c] = lx;
      s_gate[1 * CC + c] = ly;
      s_gate[2 * CC + c] = lz;
      s_gate[3 * CC + c] = hx;
      s_gate[4 * CC + c] = hy;
      s_gate[5 * CC + c] = hz;
      const float ax = fmaxf(fmaxf(lx, ox - g_cl[3 * CC + c]), 0.0f);
      const float ay = fmaxf(fmaxf(ly, oy - g_cl[4 * CC + c]), 0.0f);
      const float az = fmaxf(fmaxf(lz, oz - g_cl[5 * CC + c]), 0.0f);
      s_gate[6 * CC + c] = (ax * ax + ay * ay + az * az) * kExitSlack;
    }
  }
  if constexpr (!BINNED && !INDEX) {
    const int* g_order = order + (size_t)view * CC;
    for (int i = tid; i < CC; i += kBlock) s_order[i] = g_order[i];
  }
  if constexpr (MIP) {
    for (int i = tid; i < 2 * mp.n_tiles; i += n_thr) s_keys[i] = kMipBig;
  }
  if constexpr (RAW_TEAMS) {
    // K8's and K1-raw's records (the raw sweep's per-(view, triangle)
    // terms, :1342-1348: tv = o - v0, q = tv x e1, t_num = e2 . q, with e1,
    // e2 and v0) and, K8, per light, the shadow test's pvec = sd x e2 and
    // inv (:2885-2903, pvec_test's expressions), sd = -dir.
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    float4* s_rec = reinterpret_cast<float4*>(s_geo);
    float4* s_sh = s_rec + 4 * S;
    for (int i = tid; i < S; i += n_thr) {
      const float e1x = g_rows[3 * S + i], e1y = g_rows[4 * S + i], e1z = g_rows[5 * S + i];
      const float e2x = g_rows[6 * S + i], e2y = g_rows[7 * S + i], e2z = g_rows[8 * S + i];
      const float v0x = g_rows[i], v0y = g_rows[S + i], v0z = g_rows[2 * S + i];
      const float tvx = ox - v0x;
      const float tvy = oy - v0y;
      const float tvz = oz - v0z;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      s_rec[4 * i] = make_float4(e1x, e1y, e1z, e2x * qx + e2y * qy + e2z * qz);
      s_rec[4 * i + 1] = make_float4(e2x, e2y, e2z, v0x);
      s_rec[4 * i + 2] = make_float4(tvx, tvy, tvz, v0y);
      s_rec[4 * i + 3] = make_float4(qx, qy, qz, v0z);
      for (int li = 0; li < (GEO == kGeoRawShadows ? a.n_lights : 0); ++li) {
        const float* l = g_cam + kCamLight0 + 6 * li;
        const float sdx = -l[0], sdy = -l[1], sdz = -l[2];
        const float pvx = sdy * e2z - sdz * e2y;
        const float pvy = sdz * e2x - sdx * e2z;
        const float pvz = sdx * e2y - sdy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        s_sh[(size_t)li * S + i] =
            make_float4(pvx, pvy, pvz, fabsf(det) > kEpsDet ? 1.0f / det : 0.0f);
      }
    }
  } else if constexpr (WT_TEAMS) {
    // K10's records (:1393-1402): triangle i's a = v0 - o with the
    // validity, b = a + e1 and c = a + e2, with this view's camera origin.
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    float4* s_rec = reinterpret_cast<float4*>(s_geo);
    for (int i = tid; i < S; i += n_thr) {
      const float ax = g_rows[i] - ox;
      const float ay = g_rows[S + i] - oy;
      const float az = g_rows[2 * S + i] - oz;
      s_rec[3 * i] = make_float4(ax, ay, az, g_rows[9 * S + i]);
      s_rec[3 * i + 1] = make_float4(ax + g_rows[3 * S + i], ay + g_rows[4 * S + i],
                                     az + g_rows[5 * S + i], 0.f);
      s_rec[3 * i + 2] = make_float4(ax + g_rows[6 * S + i], ay + g_rows[7 * S + i],
                                     az + g_rows[8 * S + i], 0.f);
    }
  } else if constexpr (WT) {
    // K10's per-(view, triangle) terms (:1393-1402): a = v0 - o,
    // b = a + e1, c = a + e2 with this view's camera origin, and the
    // validity.
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    for (int i = tid; i < S; i += kBlock) {
      const float ax = g_rows[i] - ox;
      const float ay = g_rows[S + i] - oy;
      const float az = g_rows[2 * S + i] - oz;
      s_geo[i] = ax;
      s_geo[S + i] = ay;
      s_geo[2 * S + i] = az;
      s_geo[3 * S + i] = ax + g_rows[3 * S + i];
      s_geo[4 * S + i] = ay + g_rows[4 * S + i];
      s_geo[5 * S + i] = az + g_rows[5 * S + i];
      s_geo[6 * S + i] = ax + g_rows[6 * S + i];
      s_geo[7 * S + i] = ay + g_rows[7 * S + i];
      s_geo[8 * S + i] = az + g_rows[8 * S + i];
      s_geo[9 * S + i] = g_rows[9 * S + i];
    }
  } else if constexpr (RAW) {
    // The raw sweep's per-(view, triangle) terms (:1342-1348): tv = o - v0,
    // q = tv x e1, t_num = e2 . q, in rows 9-15 beside the copied v0, e1,
    // e2.
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    float* s_h = s_geo + kRawRows * S;
    for (int i = tid; i < S; i += kBlock) {
      const float e1x = g_rows[3 * S + i], e1y = g_rows[4 * S + i], e1z = g_rows[5 * S + i];
      const float e2x = g_rows[6 * S + i], e2y = g_rows[7 * S + i], e2z = g_rows[8 * S + i];
      const float tvx = ox - g_rows[i];
      const float tvy = oy - g_rows[S + i];
      const float tvz = oz - g_rows[2 * S + i];
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      s_h[i] = tvx;
      s_h[S + i] = tvy;
      s_h[2 * S + i] = tvz;
      s_h[3 * S + i] = qx;
      s_h[4 * S + i] = qy;
      s_h[5 * S + i] = qz;
      s_h[6 * S + i] = e2x * qx + e2y * qy + e2z * qz;
    }
  } else if constexpr (INDEX) {
    // The records: triangle i's prep rows as (D, t_num), (A, 0), (Q, 0);
    // K1-none's (A, live): live 0 where D = 0 and the view's near >= 0, a
    // slot no ray's test accepts (index_tile skips it).
    float4* s_rec = reinterpret_cast<float4*>(s_geo);
    [[maybe_unused]] const bool near_pos = g_cam[14] >= 0.f;
    for (int i = tid; i < S; i += n_thr) {
      const float Dx = g_rows[i], Dy = g_rows[S + i], Dz = g_rows[2 * S + i];
      float live = 0.f;
      if constexpr (!CULL) live = (Dx != 0.f || Dy != 0.f || Dz != 0.f || !near_pos) ? 1.f : 0.f;
      s_rec[3 * i] = make_float4(Dx, Dy, Dz, g_rows[9 * S + i]);
      s_rec[3 * i + 1] = make_float4(g_rows[3 * S + i], g_rows[4 * S + i], g_rows[5 * S + i], live);
      s_rec[3 * i + 2] = make_float4(g_rows[6 * S + i], g_rows[7 * S + i], g_rows[8 * S + i], 0.f);
    }
  }
  __syncthreads();
  if constexpr (!WT && !INDEX) bulk_wait(&ctl.fill_bar);
  MRT_AFTER_FILL;

  const int n_tiles = a.tiles_x * ((a.height + kTileY - 1) / kTileY);
  if constexpr (INDEX) {
    // Each tile team (named barrier 1 + team) takes its next tile from the
    // block's counter.
    constexpr int kTeam = kThreads / PIX;
    const int team = tid / kTeam;
    const float* attr = g_rows + (size_t)kAttr0 * S;
    for (int it = 0;; ++it) {
      MRT_PHASE(4);
      int* slot = &ctl.team_tile[team][it & 1];
      if (tid % kTeam == 0) *slot = atomicAdd(&ctl.next_tile, 1);
      team_sync<kTeam>(1 + team);
      const int tile = *slot;
      if (tile >= n_tiles) break;
      MRT_PHASE(3);
      const float4* s_rec = reinterpret_cast<const float4*>(s_geo);
      if constexpr (RAW_TEAMS)
        shadow_tile<TEX, PIX, GEO == kGeoRawShadows>(a, s_rec, s_rec + 4 * S, attr, s_cl, s_gate,
                                                     s_cam, view, tile, 1 + team);
      else if constexpr (WT_TEAMS)
        wt_tile<TEX, PIX, CULL>(a, s_rec, g_rows, s_cl, s_gate, s_cam, view, tile, 1 + team);
      else
        index_tile<TEX, PIX, CULL, RASTER>(a, s_rec, attr, s_cl, s_gate, s_cam, view, tile,
                                           1 + team);
    }
    if constexpr (MIP) {
      // Every team has walked every tile of the view: every pixel's winner
      // is held. Then the keys, and once they are final the sample.
      __syncthreads();
      const float4* s_rec = reinterpret_cast<const float4*>(s_geo);
      const float* m_attr = ctl.mip_attr;
      float* m_hold = smem + ctl.mip_hold;
      int* m_keys = reinterpret_cast<int*>(m_hold) - 2 * mp.n_tiles;
      mip_keys<FILTER>(a, mp, s_rec, m_attr, s_cam, m_keys, m_hold, tid, n_thr);
      __syncthreads();
      mip_pass<FILTER>(a, mp, s_rec, m_attr, s_cam, m_keys, m_hold, view, tid, n_thr);
    }
  } else {
    const int g = threadIdx.y / kTileY;
    for (int it = 0;; ++it) {
      MRT_PHASE(4);
      int* slot = &ctl.tile[g][it & 1];
      if ((tid & (kThreads - 1)) == 0) *slot = atomicAdd(&ctl.next_tile, 1);
      group_sync(1 + g);
      const int tile = *slot;
      if (tile >= n_tiles) break;
      MRT_PHASE(3);
      visit_tile<GEO, RASTER, TEX, BINNED, SEEDED>(a, bn, seed, s_geo, s_cl, s_gate, s_cam,
                                                   s_order, g_rows, view, tile, 1 + g,
                                                   ctl.vote[g]);
    }
  }
}

// Shared memory of a resident visit's block: the head, the geometry rows,
// the cluster table, the gate terms, the camera row and (ordered) the
// order.
template <int GEO>
size_t visit_smem(const RenderArgs& a, bool ordered) {
  return kVisitCtlBytes +
         sizeof(float) * ((size_t)smem_geo_rows<GEO>() * a.S +
                          (size_t)(kClRows + kGateRows) * a.CC + a.n_cols) +
         (ordered ? sizeof(int) * (size_t)a.CC : 0);
}

// Shared memory of the index visit's block: the head, the records (K8:
// and the hoisted shadow terms), the cluster table, the gate terms and the
// camera row; K7 folded, the TPU tiles' keys and the held pixels
// (kMipHoldWords a pixel) too.
template <int GEO>
size_t index_smem(const RenderArgs& a, const MipArgs* mp = nullptr) {
  return kVisitCtlBytes +
         sizeof(float) * ((size_t)index_record_floats<GEO>(a.n_lights) * a.S +
                          (size_t)(kClRows + kGateRows) * a.CC + a.n_cols) +
         (mp == nullptr ? 0
                        : sizeof(int) * (2 * (size_t)mp->n_tiles +
                                         (size_t)kMipHoldWords * a.height * a.width));
}

// One launch of an index visit's entry (K1 and K6, K8, K7 folded, K2) at
// `groups` groups a block, a block a view, `smem` bytes of dynamic shared
// memory; cudaGetLastError() after it. With `query`, no launch: what the
// card makes of the entry goes there instead (threads a block, registers a
// thread, local memory a thread in bytes, blocks a multiprocessor).
template <class... Params, class... Args>
int index_entry(void (*kernel)(Params...), size_t smem, int num_views, int groups, int* query,
                cudaStream_t stream, const Args&... args) {
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  if (query == nullptr) {
    kernel<<<num_views, dim3(kTileX, kTileY * groups), smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                             kThreads * groups, smem);
  if (err != 0) return err;
  query[0] = kThreads * groups;
  query[1] = attr.numRegs;
  query[2] = (int)attr.localSizeBytes;
  query[3] = blocks;
  return 0;
}

// A resident visit route's entry argument: the visit's inputs, K9's seed
// (null: the cold entries) and, for an occupancy query instead of a launch,
// where its four numbers go (visit_launch).
template <class X>
struct VisitArgs {
  X x;
  const float* seed;
  int* query;
};

// One launch of a resident visit's entry: a block of visit_groups<GEO>()
// tile groups a view, `smem` bytes of dynamic shared memory;
// cudaGetLastError() after it. With `query`, no launch: what the card makes
// of the entry at `smem` bytes goes there instead (threads a block,
// registers a thread, local memory a thread in bytes, blocks a
// multiprocessor).
template <int GEO, class... Params, class... Args>
int visit_launch(void (*kernel)(Params...), int* query, int num_views, size_t smem,
                 cudaStream_t stream, const Args&... args) {
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  if (query == nullptr) {
    kernel<<<num_views, dim3(kTileX, kTileY * visit_groups<GEO>()), smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                             attr.maxThreadsPerBlock, smem);
  if (err != 0) return err;
  query[0] = attr.maxThreadsPerBlock;
  query[1] = attr.numRegs;
  query[2] = (int)attr.localSizeBytes;
  query[3] = blocks;
  return 0;
}

// ---- The streamed walks' pieces: K3 + K5's ordered walk (csrc/render_streamed.cu)
// and the binned walk on tile groups (bin_body, below) ---------------------- //
// The position words, 10 a position p of the view's order (the binned
// walk: of the tile's bin): a 16-byte record
// (PosHead) of its early-exit threshold, its pixel-row span and the
// cluster id | its valid-prefix count << kCountShift, one load for the
// gates every position takes; then the slab test's six differences
// lo - o, hi - o ([CC, 6]: three 8-byte loads).
struct __align__(16) PosHead {
  float exit;
  int span_lo, span_hi, cluster;
};
constexpr int kStreamWords = 10;
constexpr int kCountShift = 16;
constexpr int kClusterMask = (1 << kCountShift) - 1;

// Tile groups of 256 threads in a block: at most 4 (1,024 threads, 32 warps
// an SM at most 64 registers a thread); the launch takes fewer where a
// block would not fit (raytrace_cuda.streamed_plan, binned_plan).
constexpr int kStreamGroups = 4;

// The head of a block's shared memory: the tile counter, each group's two
// tile slots and two vote rows (a word a warp: the warp's largest best_t^2
// with its slab vote in bit 31), used by turns so that one barrier a step
// separates a slot's writes from its reads, and each group's two stage
// buffers' mbarriers.
struct StreamCtl {
  int next_tile;
  int tile[4][2];
  unsigned long long stage_bar[4][2];
  uint4 vote[4][2][2];
};
constexpr int kStreamCtlBytes = 384;
static_assert(sizeof(StreamCtl) <= kStreamCtlBytes, "the walk's shared head");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Rows 0..n_rows-1 of cluster c (cs triangles from c * cs, row stride S in
// device memory) into buf [n_rows, cs], one bulk copy a row, completing on
// the mbarrier `bar` with the bytes expected. One thread issues; the
// proxy fence orders the group's earlier shared-memory accesses to the
// buffer (ordered to this thread by a group barrier) before the copies.
__device__ __forceinline__ void stage_rows(float* buf, const float* g_rows, int S, int cs,
                                           int c, int n_rows, unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  const unsigned d = smem_addr(buf);
  const unsigned bytes = (unsigned)cs * 4u;
  const float* src = g_rows + (size_t)c * cs;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(bytes * (unsigned)n_rows)
               : "memory");
  for (int r = 0; r < n_rows; ++r) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(d + (unsigned)r * bytes),
        "l"(src + (size_t)r * S), "r"(bytes), "r"(b)
        : "memory");
  }
}

// Waits until the mbarrier's phase of parity `parity` has completed.
__device__ __forceinline__ void stage_wait(unsigned long long* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

// The staged walk over positions 0..n-1 with two stage buffers (0, 1):
// gate(p) returns kStop, kSkip or kVisit for the group (uniform: every
// thread reaches its barrier); stage(p, b) issues a position's copies into
// buffer b; visit(p, b) waits for them and sweeps; wait(b) waits for a
// dropped candidate's. As walk_clusters: the next candidate is chosen, and
// its copies issued, before the current one is swept; after the sweep it is
// gated again and, if it fails, dropped, so the positions visited are those
// of the plain walk. The gate after a sweep is a group barrier, so every
// thread is done with the swept buffer before the next copy into it.
template <class Gate, class Stage, class Wait, class Visit>
__device__ __forceinline__ void stream_walk(int n, Gate gate, Stage stage, Wait wait,
                                            Visit visit) {
  auto next = [&](int p) {
    for (; p < n; ++p) {
      const int g = gate(p);
      if (g == kVisit) return p;
      if (g == kStop) return -1;
    }
    return -1;
  };
  int cur = 0;
  int pos = next(0);
  if (pos >= 0) stage(pos, cur);
  while (pos >= 0) {
    int nxt = next(pos + 1);
    if (nxt >= 0) stage(nxt, cur ^ 1);
    visit(pos, cur);
    if (nxt >= 0) {
      const int g = gate(nxt);
      if (g != kVisit) {
        wait(cur ^ 1);  // its copies land before the buffer is issued again
        nxt = g == kStop ? -1 : next(nxt + 1);
        if (nxt >= 0) stage(nxt, cur ^ 1);
      }
    }
    pos = nxt;
    cur ^= 1;
  }
}

// One launch of an entry on num_views * x.parts blocks of x.groups tile
// groups (0: one 16x16 block), `smem` bytes of dynamic shared memory;
// cudaGetLastError() after it. With x.query, no launch: threads a block,
// registers a thread, local memory a thread in bytes and blocks a
// multiprocessor go there instead.
template <class X, class... Params, class... Args>
int stream_launch(void (*kernel)(Params...), const X& x, int num_views, size_t smem,
                  cudaStream_t stream, const Args&... args) {
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 block(kTileX, kTileY * (x.groups == 0 ? 1 : x.groups));
  if (x.query == nullptr) {
    kernel<<<num_views * x.parts, block, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                             block.x * block.y, smem);
  if (err != 0) return err;
  x.query[0] = (int)(block.x * block.y);
  x.query[1] = attr.numRegs;
  x.query[2] = (int)attr.localSizeBytes;
  x.query[3] = blocks;
  return 0;
}


// ---- The binned walk on tile groups (K4, K11's binned visit) ------------ //
// csrc/render_binned.cu's entries: K4 and K11 on the streamed binned visit
// on prep rows, cold and seeded, in every mode (raw and K10 rows and the
// shadow sweeps keep render_body's 16x16 blocks, csrc/render_binned_blocks.cu,
// render_seeded.cu and render_dmxu.cu: the tile groups were up to 9% slower
// there on an H100). The walk is render_body's binned
// walk (the same positions, gates, slack, tie rule and seed start), on tile
// groups as the streamed ordered walk's (stream_walk, stage_rows above):
// a block is G groups of 256 threads, a group walks one 16x16 tile at a
// time, and a position's gate reads its terms from the group's records in
// shared memory, kBinChunk positions of its tile's bin at a time.
constexpr int kBinChunk = 256;

// Rows a staged cluster holds on the binned walk's tile groups: the prep
// rows, and for K4 the original index (row 10).
template <bool DMXU>
__host__ __device__ constexpr int bin_stage_rows() {
  return DMXU ? kPrepRows : kPrepRows + 1;
}

// One 16x16 tile, walked by one group (named barrier `bar`, its vote rows
// `vote`, its stage buffers `bufs` [2, rows, cs] and their mbarriers
// `bars`, its records `s_head` and `s_box` [kBinChunk]; `phases` and
// `round` carried from tile to tile as in stream_tile): K1's ray, the staged
// walk of the bin of the tile's bin tile, the resolve, the shading and the
// export, each expression as render_body computes it.
//
// The records: a chunk's position p holds, as stream_body's do, cluster
// c = bin[p]'s early-exit threshold (+inf when invalid), its 8-row-band row
// span, c | its valid count << kCountShift and its AABB less the camera
// origin; the group writes a chunk (one position a thread, then a barrier)
// when the walk's gate first reaches it. The gate is stream_tile's: the
// exit from the group's largest best_t^2 (valid until a sweep, so a
// position whose row gate fails needs no barrier while it holds), else one
// vote of the group. A staged cluster's id and count are kept in registers
// (cw0, cw1: one a buffer), since a later chunk may overwrite its record
// before its sweep. The sweeps: K4, each 8-row band of the tile (warps
// 0-3, 4-7) its sorted lanes [lo, hi) where the span touches the band, ties
// to the lower original index (row 10); K11, every slot, the cluster's
// first minimum merged with the tie rule, with `rowskip` each warp's two
// rows gated on the span. Both read D and t_num as float4 over four lanes
// k..k+3 and make the four tests in lane order (K4: a scalar head and tail
// where [lo, hi) is not aligned); each test keeps prep_test's expressions
// (testing t first, so as to skip u and v, made them slower on the card).
template <bool RASTER, int TEX, bool SEEDED, bool DMXU>
__device__ __forceinline__ void bin_tile(const RenderArgs& a, const BinArgs& bn,
                                         const float* seed, PosHead* s_head, float* s_box,
                                         const float* s_cam, const float* g_rows,
                                         const float* g_cl, float* bufs,
                                         unsigned long long* bars, int view, int num_views,
                                         int tile, int bar, uint4 (*vote)[2],
                                         unsigned& phases, unsigned& round, int rowskip) {
  constexpr bool RANGED = !DMXU;
  constexpr int kRows = bin_stage_rows<DMXU>();
  const int S = a.S, CC = a.CC, cs = a.cluster_size;
  const int ly = threadIdx.y % kTileY;
  const int bx = tile % a.tiles_x, by = tile / a.tiles_x;
  const int px = bx * kTileX + threadIdx.x;
  const int py = by * kTileY + ly;
  const int* g_bin = bn.bins + ((size_t)view * bn.n_bins + (by >> bn.bin_shift) * bn.bins_x +
                                (bx >> bn.bin_shift)) * (1 + CC);
  const int* g_span = bn.spans + (size_t)view * 2 * CC;

  const float ox = s_cam[0], oy = s_cam[1], oz = s_cam[2];
  const float rxx = s_cam[3], rxy = s_cam[4], rxz = s_cam[5];
  const float fx = s_cam[6], fy = s_cam[7], fz = s_cam[8];
  const float ux = s_cam[9], uy = s_cam[10], uz = s_cam[11];
  const float tan_x = s_cam[12], tan_y = s_cam[13];
  const float near = s_cam[14], far = s_cam[15];

  // Ray generation (raytrace_pallas.py:1180-1188). Threads past the image
  // edge trace their ray too: they take part in the tile's gates and write
  // nothing.
  const float ra = (((float)px + 0.5f) * a.two_over_w - 1.0f) * tan_x;
  const float rb = (1.0f - ((float)py + 0.5f) * a.two_over_h) * tan_y;
  float dx = ra * rxx + fx + rb * ux;
  float dy = ra * rxy + fy + rb * uy;
  float dz = ra * rxz + fz + rb * uz;
  const float inv_len = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_len;
  dy = dy * inv_len;
  dz = dz * inv_len;
  const float cosf_ = dx * fx + dy * fy + dz * fz;
  const float t_lo = RASTER ? near / fmaxf(cosf_, kCosFloor) : near;
  const float ivx = 1.0f / safe_dir(dx);
  const float ivy = 1.0f / safe_dir(dy);
  const float ivz = 1.0f / safe_dir(dz);

  float best_t = far;
  if constexpr (SEEDED) {
    // K9: min(seed, far); 0 past the image edge.
    const bool in_image = px < a.width && py < a.height;
    const float s = in_image ? seed[((size_t)view * a.height + py) * a.width + px] : 0.f;
    best_t = s > far ? far : s;
  }
  int best_idx = -1;
  [[maybe_unused]] int best_lane = -1;  // K4: the winner's sorted lane
  const int lane_tid = ly * kTileX + threadIdx.x;  // 0-255 in the group
  const int warp = lane_tid >> 5;
  const bool lane0 = (lane_tid & 31) == 0;
  const bool leader = lane_tid == 0;
  const int row0 = by * kTileY;
  // K4: the thread's 8-row band; a band below the image sweeps nothing and
  // starts at 0, so it never holds the walk open.
  [[maybe_unused]] const int band_row0 = row0 + (ly / kBandRows) * kBandRows;
  [[maybe_unused]] const bool band_in = band_row0 / kBandRows < bn.n_bands;
  if constexpr (RANGED) {
    if (!band_in) best_t = 0.f;
  }

  auto buf_of = [&](int b) { return bufs + b * kRows * cs; };
  auto wait = [&](int b) {
    stage_wait(bars + b, (phases >> b) & 1u);
    phases ^= 1u << b;
  };

  // Chunk k of the bin's records, positions k * kBinChunk + lane_tid: the
  // barrier before it lets every thread finish reading the chunk before.
  const int n = g_bin[0];
  int loaded = -1;
  auto fill = [&](int k) {
    MRT_PHASE(0);
    if (loaded >= 0) group_sync(bar);
    const int p = k * kBinChunk + lane_tid;
    if (p < n) {
      const int c = g_bin[1 + p];
      const float lx = g_cl[0 * CC + c] - ox, lyy = g_cl[1 * CC + c] - oy,
                  lz = g_cl[2 * CC + c] - oz;
      const float hx = g_cl[3 * CC + c] - ox, hy = g_cl[4 * CC + c] - oy,
                  hz = g_cl[5 * CC + c] - oz;
      float2* box = reinterpret_cast<float2*>(s_box) + 3 * lane_tid;
      box[0] = make_float2(lx, lyy);
      box[1] = make_float2(lz, hx);
      box[2] = make_float2(hy, hz);
      const float ax = fmaxf(fmaxf(lx, ox - g_cl[3 * CC + c]), 0.0f);
      const float ay = fmaxf(fmaxf(lyy, oy - g_cl[4 * CC + c]), 0.0f);
      const float az = fmaxf(fmaxf(lz, oz - g_cl[5 * CC + c]), 0.0f);
      PosHead h;
      h.exit = g_cl[6 * CC + c] > 0.f ? (ax * ax + ay * ay + az * az) * kExitSlack : INFINITY;
      h.span_lo = g_span[c];
      h.span_hi = g_span[CC + c];
      h.cluster = c | ((int)g_cl[7 * CC + c] << kCountShift);
      s_head[lane_tid] = h;
    }
    group_sync(bar);
    loaded = k;
    MRT_PHASE(1);
  };

  // The gate at position p, stream_tile's: the exit, the row gate, the slab
  // test, on the chunk's record of p.
  float reach = 0.f;
  bool fresh = false;  // `reach` is the group's for the current best_t
  auto gate = [&](int p) {
    MRT_PHASE(1);
    if (p / kBinChunk != loaded) fill(p / kBinChunk);
    const int q = p % kBinChunk;
    const PosHead h = s_head[q];
    const bool rows_in = !(h.span_lo > row0 + kTileY - 1 || h.span_hi < row0);
    if (!rows_in && fresh) return reach > h.exit ? kSkip : kStop;
    bool possible = false;
    if (rows_in) {
      const float2 b0 = reinterpret_cast<const float2*>(s_box)[3 * q];
      const float2 b1 = reinterpret_cast<const float2*>(s_box)[3 * q + 1];
      const float2 b2 = reinterpret_cast<const float2*>(s_box)[3 * q + 2];
      const float t1x = b0.x * ivx;  // (lo.x - o.x) / d.x
      const float t2x = b1.y * ivx;  // (hi.x - o.x) / d.x
      const float t1y = b0.y * ivy;
      const float t2y = b2.x * ivy;
      const float t1z = b1.x * ivz;
      const float t2z = b2.y * ivz;
      const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
      const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
      possible = (tmax >= tmin) && (tmax > near) && (tmin * kSlabSlack < best_t);
    }
    const float sq = best_t * best_t;
    const unsigned w = __reduce_max_sync(0xffffffffu, sq > 0.f ? __float_as_uint(sq) : 0u) |
                       (__reduce_or_sync(0xffffffffu, possible ? 1u : 0u) << 31);
    uint4* row = vote[round & 1u];
    ++round;
    if (lane0) reinterpret_cast<unsigned*>(row)[warp] = w;
    group_sync(bar);
    const uint4 v0 = row[0], v1 = row[1];
    const unsigned any = (v0.x | v0.y | v0.z | v0.w | v1.x | v1.y | v1.z | v1.w) >> 31;
    const unsigned mx = max(max(max(v0.x & 0x7fffffffu, v0.y & 0x7fffffffu),
                                max(v0.z & 0x7fffffffu, v0.w & 0x7fffffffu)),
                            max(max(v1.x & 0x7fffffffu, v1.y & 0x7fffffffu),
                                max(v1.z & 0x7fffffffu, v1.w & 0x7fffffffu)));
    reach = __uint_as_float(mx);
    fresh = true;
    if (!(reach > h.exit)) return kStop;
    return any ? kVisit : kSkip;
  };
  int cw0 = 0, cw1 = 0;  // each buffer's staged cluster id | count
  auto stage = [&](int p, int b) {
    const int cw = s_head[p % kBinChunk].cluster;
    if (b) {
      cw1 = cw;
    } else {
      cw0 = cw;
    }
    if (leader) stage_rows(buf_of(b), g_rows, S, cs, cw & kClusterMask, kRows, bars + b);
  };
  auto visit = [&](int p, int b) {
    float* buf = buf_of(b);
    const int c = (b ? cw1 : cw0) & kClusterMask;
    // The sweep may lower best_t: the gate that follows votes, and its
    // barrier frees this buffer for its next copy.
    fresh = false;
    MRT_PHASE(2);
    wait(b);
    MRT_PHASE(3);
    if constexpr (DMXU) {
      // Row skip (:1915-1990): the cluster's rows miss the warp's two.
      const int wrow0 = row0 + 2 * (ly / 2);
      if (rowskip && (g_span[c] > wrow0 + 1 || g_span[CC + c] < wrow0)) return;
      // t < cmin from cmin = far: the accepted t < far of the first
      // minimum, as the JAX iota-min takes it; D and t_num read as float4
      // over four slots, the four tests in slot order.
      float cmin = far;
      int lidx = -1;
      auto test = [&](float d0, float d1, float d2, float tn, int k) {
        const float det = dx * d0 + dy * d1 + dz * d2;
        const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
        const float u = (dx * buf[3 * cs + k] + dy * buf[4 * cs + k] + dz * buf[5 * cs + k]) * inv;
        const float v = (dx * buf[6 * cs + k] + dy * buf[7 * cs + k] + dz * buf[8 * cs + k]) * inv;
        const float t = tn * inv;
        if ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > t_lo) && (t < cmin)) {
          cmin = t;
          lidx = k;
        }
      };
      for (int k = 0; k < cs; k += 4) {
        const float4 d0 = *reinterpret_cast<const float4*>(buf + k);
        const float4 d1 = *reinterpret_cast<const float4*>(buf + cs + k);
        const float4 d2 = *reinterpret_cast<const float4*>(buf + 2 * cs + k);
        const float4 tn = *reinterpret_cast<const float4*>(buf + 9 * cs + k);
        test(d0.x, d1.x, d2.x, tn.x, k);
        test(d0.y, d1.y, d2.y, tn.y, k + 1);
        test(d0.z, d1.z, d2.z, tn.z, k + 2);
        test(d0.w, d1.w, d2.w, tn.w, k + 3);
      }
      const int gi = c * cs + lidx;
      if (lidx >= 0 && ((cmin < best_t) || (cmin == best_t && gi < best_idx))) {
        best_t = cmin;
        best_idx = gi;
      }
    } else {
      // The band's sorted lanes [lo, hi) where the span touches it; row 10
      // the lane's original index, the tie rule's.
      if (!band_in || g_span[c] > band_row0 + kBandRows - 1 || g_span[CC + c] < band_row0)
        return;
      const int2 r = bn.ranges[((size_t)(view / a.num_cams) * CC + c) * bn.n_bands +
                               band_row0 / kBandRows];
      // prep_test's expressions and the tie rule on lane k, its D and t_num
      // given.
      auto test = [&](float d0, float d1, float d2, float tn, int k) {
        const float det = dx * d0 + dy * d1 + dz * d2;
        const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
        const float u = (dx * buf[3 * cs + k] + dy * buf[4 * cs + k] + dz * buf[5 * cs + k]) * inv;
        const float v = (dx * buf[6 * cs + k] + dy * buf[7 * cs + k] + dz * buf[8 * cs + k]) * inv;
        const float t = tn * inv;
        const int gi = (int)buf[kPrepRows * cs + k];
        if ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > t_lo) &&
            ((t < best_t) || (t == best_t && gi < best_idx))) {
          best_t = t;
          best_idx = gi;
          best_lane = c * cs + k;
        }
      };
      // A scalar head to a lane that is a multiple of 4, then D and t_num
      // read as float4 over four lanes, then a scalar tail.
      int k = r.x;
      for (; k < r.y && (k & 3) != 0; ++k)
        test(buf[k], buf[cs + k], buf[2 * cs + k], buf[9 * cs + k], k);
      for (; k + 4 <= r.y; k += 4) {
        const float4 d0 = *reinterpret_cast<const float4*>(buf + k);
        const float4 d1 = *reinterpret_cast<const float4*>(buf + cs + k);
        const float4 d2 = *reinterpret_cast<const float4*>(buf + 2 * cs + k);
        const float4 tn = *reinterpret_cast<const float4*>(buf + 9 * cs + k);
        test(d0.x, d1.x, d2.x, tn.x, k);
        test(d0.y, d1.y, d2.y, tn.y, k + 1);
        test(d0.z, d1.z, d2.z, tn.z, k + 2);
        test(d0.w, d1.w, d2.w, tn.w, k + 3);
      }
      for (; k < r.y; ++k) test(buf[k], buf[cs + k], buf[2 * cs + k], buf[9 * cs + k], k);
    }
  };
  stream_walk(n, gate, stage, wait, visit);
  MRT_PHASE(4);

  const bool inside = px < a.width && py < a.height;
  if (!inside) return;

  // Winner resolve (:2725-2793), as render_body's: the rows in device
  // memory (K4: the winner's prep rows at its sorted lane).
  const float* g0 = g_rows;  // D
  const float* g1 = g_rows + S;
  const float* g2 = g_rows + 2 * S;
  const float* g3 = g_rows + 3 * S;  // A
  const float* g4 = g_rows + 4 * S;
  const float* g5 = g_rows + 5 * S;
  const float* g6 = g_rows + 6 * S;  // Q
  const float* g7 = g_rows + 7 * S;
  const float* g8 = g_rows + 8 * S;
  float nx = 0.f, ny = 0.f, nz = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  float dens = 0.f;
  const bool found = best_idx >= 0;
  if (found) {
    const int j = best_idx;
    const int jr = RANGED ? best_lane : j;
    const float det = dx * g0[jr] + dy * g1[jr] + dz * g2[jr];
    const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
    const float uc = clip01((dx * g3[jr] + dy * g4[jr] + dz * g5[jr]) * inv);
    const float vc = clip01((dx * g6[jr] + dy * g7[jr] + dz * g8[jr]) * inv);
    const float* g_attr = g_rows + (size_t)kAttr0 * S;
    nx = g_attr[6 * S + j] + uc * g_attr[9 * S + j] + vc * g_attr[12 * S + j];
    ny = g_attr[7 * S + j] + uc * g_attr[10 * S + j] + vc * g_attr[13 * S + j];
    nz = g_attr[8 * S + j] + uc * g_attr[11 * S + j] + vc * g_attr[14 * S + j];
    if (TEX == kTexNone) {
      a0 = g_attr[16 * S + j];
      a1 = g_attr[17 * S + j];
      a2 = g_attr[18 * S + j];
    } else {
      a0 = g_attr[15 * S + j];
      a1 = g_attr[0 * S + j] + uc * g_attr[2 * S + j] + vc * g_attr[4 * S + j];
      a2 = g_attr[1 * S + j] + uc * g_attr[3 * S + j] + vc * g_attr[5 * S + j];
    }
    if (TEX == kTexMip) dens = g_attr[19 * S + j];
  }

  // Two-sided: flip the normal toward the viewer (:2800-2804).
  const float ndotd = nx * dx + ny * dy + nz * dz;
  const float flip = ndotd > 0.f ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;
  const float t_hit = found ? best_t : 0.f;
  const float z = t_hit * cosf_;
  const size_t o = ((size_t)view * a.height + py) * a.width + px;
  const size_t plane = (size_t)num_views * a.height * a.width;

  if constexpr (TEX == kTexNine) {
    // The 9-output mode (:2832-2834, :3664-3670), unmasked.
    a.depth[o] = t_hit;
    a.segmask[o] = best_idx;
    a.code[o] = (int)a0;
    a.handoff[o] = z;
    a.handoff[plane + o] = a1;
    a.handoff[2 * plane + o] = a2;
    a.handoff[3 * plane + o] = nx;
    a.handoff[4 * plane + o] = ny;
    a.handoff[5 * plane + o] = nz;
    return;
  }

  // Base colour, lambert over the lights and the fused export, as
  // render_body's (:3015-3050, :3186-3202).
  float br = a0, bg = a1, bb = a2;
  if (TEX == kTexNearest || TEX == kTexBilinear)
    textured_base<TEX>(a.mats, a.pool, a.n_mats, (int)a0, a1, a2, br, bg, bb);
  const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kTiny));
  float sr = 0.f, sg = 0.f, sb = 0.f;
  for (int li = 0; li < a.n_lights; ++li) {
    const float* l = s_cam + kCamLight0 + 6 * li;
    const float nd = fmaxf(-(nx * l[0] + ny * l[1] + nz * l[2]) * n_inv, 0.f);
    sr = sr + nd * l[3];
    sg = sg + nd * l[4];
    sb = sb + nd * l[5];
  }
  const bool shaded_hit = RASTER ? found && z < s_cam[kCamFarZ] : found;
  const bool cam_ok = s_cam[kCamLight0 + 6 * a.n_lights] > 0.f;
  const bool hit = shaded_hit && cam_ok;
  if (TEX == kTexMip) {
    // The hand-off to csrc/shade_mip.cu (:3237).
    a.depth[o] = hit ? (RASTER ? z : best_t) : 0.f;
    a.segmask[o] = hit && !RASTER ? best_idx / a.seg_div : -1;
    a.code[o] = (int)a0 | (found ? kFoundBit : 0) | (shaded_hit ? kShadedBit : 0);
    a.handoff[o] = a1;
    a.handoff[plane + o] = a2;
    a.handoff[2 * plane + o] = t_hit * a.two_over_h * tan_y * dens;
    a.handoff[3 * plane + o] = sr;
    a.handoff[4 * plane + o] = sg;
    a.handoff[5 * plane + o] = sb;
    return;
  }
  const uint32_t packed = quantize(br, sr, shaded_hit) | (quantize(bg, sg, shaded_hit) << 8) |
                          (quantize(bb, sb, shaded_hit) << 16) | kAlpha;
  if (RASTER) {
    a.depth[o] = hit ? z : 0.f;
    a.segmask[o] = -1;
  } else {
    a.depth[o] = hit ? best_t : 0.f;
    a.segmask[o] = hit ? best_idx / a.seg_div : -1;
  }
  a.rgb[o] = cam_ok ? packed : kAlpha;
}

// A binned block: view blockIdx.x / parts, its share `part` of the view's
// bin tiles (part, part + parts, ...: each block's spread over the image and
// its costly rows), blockDim.y / 16 tile groups that take the share's tiles,
// bin tile by bin tile (so the tiles of one bin tile go to one block's
// groups, and their chunk fills read the bin's lines together), from a
// counter. The fill, once a block: the camera row (threads) and each
// group's two mbarriers (thread 0).
template <bool RASTER, int TEX, bool SEEDED, bool DMXU>
__device__ __forceinline__ void bin_body(const RenderArgs& a, const BinArgs& bn, int parts,
                                         const float* seed, int rowskip) {
  constexpr int kRows = bin_stage_rows<DMXU>();
  const int cs = a.cluster_size;
  const int groups = blockDim.y / kTileY;
  const int n_block = kThreads * groups;
  extern __shared__ __align__(16) float smem[];
  MRT_PHASE_BEGIN;
  StreamCtl& ctl = *reinterpret_cast<StreamCtl*>(smem);
  float* s_stage = smem + kStreamCtlBytes / sizeof(float);  // [groups, 2, rows, cs]
  PosHead* s_head =
      reinterpret_cast<PosHead*>(s_stage + (size_t)groups * 2 * kRows * cs);  // [groups, chunk]
  float* s_box = reinterpret_cast<float*>(s_head + groups * kBinChunk);  // [groups, chunk, 6]
  float* s_cam = s_box + (size_t)groups * 6 * kBinChunk;                 // [NCOL]

  const int view = blockIdx.x / parts;
  const int part = blockIdx.x - view * parts;
  const int world = view / a.num_cams;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float* g_rows = a.rows + (size_t)world * kPackRows * a.S;
  const float* g_cl = a.clusters + (size_t)world * kClRows * a.CC;
  const float* g_cam = a.cams + (size_t)view * a.n_cols;
  const int tiles_y = (a.height + kTileY - 1) / kTileY;
  const int n_tiles = a.tiles_x * tiles_y;
  if (tid == 0) {
    ctl.next_tile = 0;
    for (int k = 0; k < 2 * groups; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&ctl.stage_bar[k >> 1][k & 1]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < a.n_cols; i += n_block) s_cam[i] = g_cam[i];
  __syncthreads();
  MRT_AFTER_FILL;

  const int g = threadIdx.y / kTileY;
  float* bufs = s_stage + (size_t)g * 2 * kRows * cs;
  const int sub = 1 << bn.bin_shift;  // tiles across a bin tile
  unsigned phases = 0, round = 0;
  for (int it = 0;; ++it) {
    MRT_PHASE(5);
    int* slot = &ctl.tile[g][it & 1];
    if ((tid & (kThreads - 1)) == 0) {
      // The share's k-th tile: tile k % sub^2 of its (k / sub^2)-th bin
      // tile, those past the image's edge skipped; n_tiles when it is done.
      int t;
      for (;;) {
        const int k = atomicAdd(&ctl.next_tile, 1);
        const int bt = part + (k >> (2 * bn.bin_shift)) * parts;
        if (bt >= bn.n_bins) {
          t = n_tiles;
          break;
        }
        const int s = k & (sub * sub - 1);
        const int tx = (bt % bn.bins_x) * sub + (s & (sub - 1));
        const int ty = (bt / bn.bins_x) * sub + (s >> bn.bin_shift);
        if (tx < a.tiles_x && ty < tiles_y) {
          t = ty * a.tiles_x + tx;
          break;
        }
      }
      *slot = t;
    }
    group_sync(1 + g);
    const int tile = *slot;
    if (tile >= n_tiles) break;
    MRT_PHASE(4);
    bin_tile<RASTER, TEX, SEEDED, DMXU>(
        a, bn, seed, s_head + g * kBinChunk, s_box + (size_t)g * 6 * kBinChunk, s_cam, g_rows,
        g_cl, bufs, ctl.stage_bar[g], view, gridDim.x / parts, tile, 1 + g, ctl.vote[g],
        phases, round, rowskip);
  }
}

// Shared memory of a binned block of `groups` tile groups: the head, the
// groups' stage buffers, their records and the camera row.
template <bool DMXU>
size_t bin_smem(const RenderArgs& a, int groups) {
  return kStreamCtlBytes +
         sizeof(float) * ((size_t)groups * 2 * bin_stage_rows<DMXU>() * a.cluster_size +
                          (size_t)groups * kStreamWords * kBinChunk + a.n_cols);
}

// Whether a route has entries in the 9-output mode: it opts in with
// `static constexpr bool kNine = true`, so that the mode is instantiated
// only in the sources whose routes declare it (a case for every route would
// instantiate it in every translation unit that includes this file).
template <class Route, class = void>
struct HasNine : std::false_type {};
template <class Route>
struct HasNine<Route, std::void_t<decltype(Route::kNine)>>
    : std::bool_constant<Route::kNine> {};

// The variant dispatch of the C entries, this file's and those of the
// sources that include it: Route::run<GEO, RASTER, TEX>(a, x, num_views,
// stream) launches one instantiation with the route's own entry argument x
// (StreamArgs, BinArgs, or either with K9's seed: Seeded). The 9-output
// mode runs without the in-kernel shadow rays (the epilogue traces them).
template <class Route, int GEO, bool RASTER, class Extra>
int launch_tex(const RenderArgs& a, const Extra& x, int num_views, int tex_filter,
               cudaStream_t stream) {
  switch (tex_filter) {
    case kTexNone:
      return Route::template run<GEO, RASTER, kTexNone>(a, x, num_views, stream);
    case kTexNearest:
      return Route::template run<GEO, RASTER, kTexNearest>(a, x, num_views, stream);
    case kTexBilinear:
      return Route::template run<GEO, RASTER, kTexBilinear>(a, x, num_views, stream);
    case kTexMip:
      return Route::template run<GEO, RASTER, kTexMip>(a, x, num_views, stream);
    case kTexNine:
      if constexpr (HasNine<Route>::value && GEO != kGeoRawShadows &&
                    GEO != kGeoRawWtShadows)
        return Route::template run<GEO, RASTER, kTexNine>(a, x, num_views, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <class Route, int GEO, class Extra>
int launch_raster(const RenderArgs& a, const Extra& x, int num_views, int raster,
                  int tex_filter, cudaStream_t stream) {
  return raster ? launch_tex<Route, GEO, true>(a, x, num_views, tex_filter, stream)
                : launch_tex<Route, GEO, false>(a, x, num_views, tex_filter, stream);
}

template <class Route, class Extra>
int launch_variant(const RenderArgs& a, const Extra& x, int num_views, int geo,
                   int raster, int tex_filter, cudaStream_t stream) {
  if ((geo == kGeoRawShadows || geo == kGeoRawWtShadows) && a.n_lights > 32)
    return (int)cudaErrorInvalidValue;
  switch (geo) {
    case kGeoPrep:
      return launch_raster<Route, kGeoPrep>(a, x, num_views, raster, tex_filter, stream);
    case kGeoRaw:
      return launch_raster<Route, kGeoRaw>(a, x, num_views, raster, tex_filter, stream);
    case kGeoRawShadows:
      return launch_raster<Route, kGeoRawShadows>(a, x, num_views, raster, tex_filter,
                                                  stream);
    case kGeoRawWt:
      return launch_raster<Route, kGeoRawWt>(a, x, num_views, raster, tex_filter, stream);
    case kGeoRawWtShadows:
      return launch_raster<Route, kGeoRawWtShadows>(a, x, num_views, raster, tex_filter,
                                                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The C entries' argument block; the mip hand-off's two outputs take the
// texture inputs' slots.
RenderArgs render_args(const float* rows, const float* clusters, const float* cams,
                       const float* mats, const int* pool, int n_mats, float* depth,
                       int* segmask, uint32_t* rgb, int* code, float* handoff,
                       int num_cams, int S, int CC, int cluster_size, int n_cols,
                       int n_lights, int height, int width, int seg_div,
                       float two_over_w, float two_over_h, int tex_filter) {
  RenderArgs a{rows, clusters, cams, {mats}, {pool}, depth, segmask, rgb,
               n_mats, num_cams, S, CC, cluster_size, n_cols, n_lights,
               height, width, (width + kTileX - 1) / kTileX, seg_div,
               two_over_w, two_over_h};
  if (tex_filter == kTexMip || tex_filter == kTexNine) {
    a.handoff = handoff;
    a.code = code;
  }
  return a;
}

// csrc/render_binned.cu, csrc/render_resident_ordered.cu,
// csrc/render_resident_binned.cu, csrc/render_seeded.cu, csrc/render_none.cu,
// csrc/render_dmxu.cu and csrc/render_streamed.cu include this file for the
// above and bring their own entry point, route and C interface.
#ifndef MRT_RENDER_BODY_ONLY
// The resident route in index order (K1); its 9-output entries are
// csrc/render_none.cu's.
struct ResidentRoute {
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const StreamArgs&, int num_views,
                 cudaStream_t stream) {
    return launch_grid(render_resident_kernel<GEO, RASTER, TEX>, a, num_views,
                       resident_smem<GEO>(a), stream, a);
  }
};

// K1's index visit on tile teams (prep rows, raytraced; untextured,
// nearest or bilinear), kIndexPixels pixels a thread: 1 or 2 groups a block
// (the launch's), a block a view. At most 64 registers a thread, so that
// 2048 threads of 1 or 2 groups' blocks fit a multiprocessor.
template <int TEX>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 4 / kIndexMaxGroups)
render_index_kernel(const RenderArgs a) {
  visit_body<kGeoPrep, false, TEX, false, false, kIndexPixels>(a, nullptr, BinArgs{}, nullptr);
}

// K2 and K2+K6 on the index visit's tile teams: K1's entry in the raster
// conventions (prep rows; untextured, nearest or bilinear), kRasterPixels
// pixels a thread, 1 or 2 groups a block, a block a view;
// at most 64 registers a thread.
template <int TEX>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 4 / kIndexMaxGroups)
render_index_raster_kernel(const RenderArgs a) {
  visit_body<kGeoPrep, true, TEX, false, false, kRasterPixels>(a, nullptr, BinArgs{}, nullptr);
}

// K8 on the index visit's tile teams (raw rows with shadows, raytraced;
// untextured, nearest or bilinear), kShadowPixels pixels a thread, 1 or 2
// groups a block, a block a view; up to 128 registers a thread.
template <int TEX>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 1)
render_index_shadows_kernel(const RenderArgs a) {
  visit_body<kGeoRawShadows, false, TEX, false, false, kShadowPixels>(a, nullptr, BinArgs{},
                                                                       nullptr);
}

// K1-raw on the index visit's tile teams (raw rows without shadows,
// raytraced; untextured, nearest or bilinear): K8's records and tile
// without the shadow sweep, kRawPixels pixels a thread, 1 or 2 groups a
// block, a block a view; at most 64 registers a thread.
template <int TEX>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 4 / kIndexMaxGroups)
render_index_raw_kernel(const RenderArgs a) {
  visit_body<kGeoRaw, false, TEX, false, false, kRawPixels>(a, nullptr, BinArgs{}, nullptr);
}

// K10 on the index visit's tile teams (raw rows, the watertight decision,
// raytraced; untextured, nearest or bilinear), kWtPixels pixels a thread, 1
// or 2 groups a block, a block a view; at most 64 registers a thread.
template <int TEX>
__global__ void __launch_bounds__(kThreads * kIndexMaxGroups, 4 / kIndexMaxGroups)
render_index_wt_kernel(const RenderArgs a) {
  visit_body<kGeoRawWt, false, TEX, false, false, kWtPixels>(a, nullptr, BinArgs{}, nullptr);
}

template <int GEO, int TEX>
int index_launch(const RenderArgs& a, int num_views, int groups, bool raster, int* query,
                 cudaStream_t stream) {
  if constexpr (GEO == kGeoPrep) {
    if (raster)
      return index_entry(render_index_raster_kernel<TEX>, index_smem<GEO>(a), num_views,
                         groups, query, stream, a);
  }
  if constexpr (GEO == kGeoRawShadows)
    return index_entry(render_index_shadows_kernel<TEX>, index_smem<GEO>(a), num_views, groups,
                       query, stream, a);
  else if constexpr (GEO == kGeoRaw)
    return index_entry(render_index_raw_kernel<TEX>, index_smem<GEO>(a), num_views, groups,
                       query, stream, a);
  else if constexpr (GEO == kGeoRawWt)
    return index_entry(render_index_wt_kernel<TEX>, index_smem<GEO>(a), num_views, groups,
                       query, stream, a);
  else
    return index_entry(render_index_kernel<TEX>, index_smem<GEO>(a), num_views, groups, query,
                       stream, a);
}

template <int GEO>
int index_tex(const RenderArgs& a, int num_views, int tex_filter, int groups, bool raster,
              int* query, cudaStream_t stream) {
  switch (tex_filter) {
    case kTexNone:
      return index_launch<GEO, kTexNone>(a, num_views, groups, raster, query, stream);
    case kTexNearest:
      return index_launch<GEO, kTexNearest>(a, num_views, groups, raster, query, stream);
    case kTexBilinear:
      return index_launch<GEO, kTexBilinear>(a, num_views, groups, raster, query, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The index visit's entry (geo, raster, tex_filter) at `groups` groups a
// block: raster on prep rows only.
int index_variant(const RenderArgs& a, int num_views, int geo, int raster, int tex_filter,
                  int groups, int* query, cudaStream_t stream) {
  if (groups < 1 || groups > kIndexMaxGroups || (raster && geo != kGeoPrep))
    return (int)cudaErrorInvalidValue;
  if (geo == kGeoPrep)
    return index_tex<kGeoPrep>(a, num_views, tex_filter, groups, raster, query, stream);
  if (geo == kGeoRaw)
    return index_tex<kGeoRaw>(a, num_views, tex_filter, groups, false, query, stream);
  if (geo == kGeoRawShadows && a.n_lights <= 32)
    return index_tex<kGeoRawShadows>(a, num_views, tex_filter, groups, false, query, stream);
  if (geo == kGeoRawWt)
    return index_tex<kGeoRawWt>(a, num_views, tex_filter, groups, false, query, stream);
  return (int)cudaErrorInvalidValue;
}
#endif  // MRT_RENDER_BODY_ONLY

}  // namespace

#ifndef MRT_RENDER_BODY_ONLY
extern "C" {

// Launches the variant (geo, raster, tex_filter) on `stream`, on the
// caller's current device: geo is 0 (prep rows), 1 (raw rows), 2 (raw rows
// with shadows, at most 32 lights), 3 (raw rows, the watertight decision)
// or 4 (3 with shadows); tex_filter is 0 (untextured), 1
// (nearest), 2 (bilinear) or 3 (the mip hand-off, written to code and
// handoff instead of rgb); mats/pool may be null unless it is 1 or 2, and
// rgb when it is 3, code/handoff unless it is 3. Every cluster in index
// order (K1); the streamed ordered walk is csrc/render_streamed.cu's.
// groups 0: the parent design, one 16x16 block a tile (every variant);
// 1 or 2: the index visit's groups of tile teams, a block a view (geo 0,
// 1, 2 or 3, raster 0, tex_filter 0, 1 or 2; geo 0 raster 1 too), 4 pixels
// a thread (geo 1: kRawPixels; geo 2: 2; geo 3: kWtPixels; raster:
// kRasterPixels). Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown variant or plan.
int mrt_render_resident(const float* rows, const float* clusters,
                        const float* cams, const float* mats, const int* pool,
                        int n_mats, float* depth, int* segmask, uint32_t* rgb,
                        int* code, float* handoff, int num_views, int num_cams, int S, int CC,
                        int cluster_size, int n_cols, int n_lights, int height,
                        int width, int seg_div, float two_over_w,
                        float two_over_h, int raster, int tex_filter, int geo,
                        int groups, void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (groups == 0)
    return launch_variant<ResidentRoute>(a, StreamArgs{nullptr, nullptr}, num_views, geo,
                                         raster, tex_filter, (cudaStream_t)stream);
  return index_variant(a, num_views, geo, raster, tex_filter, groups, nullptr,
                       (cudaStream_t)stream);
}

// The index visit's entry (geo, raster, tex_filter, groups) at these
// sizes: threads a block, registers, local memory bytes a thread and blocks
// a multiprocessor, in out[0..3]. Returns 0, or the CUDA error of the query.
int mrt_render_resident_occupancy(int geo, int raster, int tex_filter, int groups, int S,
                                  int CC, int n_cols, int n_lights, int* out) {
  RenderArgs a{};
  a.S = S;
  a.CC = CC;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  return index_variant(a, 0, geo, raster, tex_filter, groups, out, nullptr);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // MRT_RENDER_BODY_ONLY
