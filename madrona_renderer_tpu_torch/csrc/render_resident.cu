// K1 / K1-raw / K8 / K10 / K2 / K6, and the first launch of K7: resident,
// cluster-culled, shaded ray-cast with the fused export, on prep or raw
// geometry rows, with the Möller–Trumbore or the watertight decision, with
// or without shadow rays, in its raytrace and raster conventions,
// untextured, textured, or handing mip-mapped texturing on; and K3 + K5,
// the same kernel on the streamed route for meshes past the resident
// budget (render_streamed_kernel, below).
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
//     it, each route in its own source (here the streamed ordered walk's;
//     K1's and K1-none's in csrc/render_none.cu).
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
// hand-off mode 36 B, about 600 MB).
// chip_smoke.py works out the exact counts for its inputs. The texel pool
// (at most 128 x 128 texels, 64 KB) stays in L1/L2: a texel read is one
// cached 4-byte load (bilinear: four).
//
// The design is the simple one: one thread per pixel, one 16x16 block per
// (view, tile), the world's geometry rows (raw: with this view's hoisted
// tv, q, t_num), cluster rows and camera row in shared memory (broadcast
// reads in the sweeps), the winner's attributes, the material row and the
// texels read from global memory once per pixel. No wgmma or TMA: the work
// is scalar per pixel. The three switches and the route (STREAM) are
// template parameters, so each of the 86 variants compiles to its own kernel
// with no runtime branch on them. K10's block keeps 10 rows per triangle in
// shared memory (a, b, c and the validity: 120 KB at the budget's 3,072
// triangles, where K1-raw's 16 rows take 192 KB); its resolve and its
// shadow sweep read the raw rows from global memory (L1/L2). The resident
// visits (K3 and K4 on resident rows, below) fill a block's rows once a
// view and walk several tiles in it. Left for a later change: K1's blocks
// likewise; the shadow sweep's per-light pvec, det and 1/det, which are
// per-triangle scalars, hoisted per block.
//
// The streamed route (STREAM, render_streamed_kernel): meshes whose rows do
// not fit the resident budget (32 * S * 4 bytes > 384 KB, the JAX package's
// dma_tris, :4265-4266). Replaces the same factory's ordered (K3, :1755-1785)
// deferred / dma_tris / prep-stream / band_gates sweep (K5, :1787-2680). Per
// 16x16 block (one view, one tile) the world's cluster table, the view's
// visit order (ascending camera-to-AABB distance, raytrace_cuda.
// camera_cluster_order) and its clusters' pixel-row spans (raytrace_cuda.
// camera_cluster_rowspans at 16-row bands) sit in shared memory, and the block
// walks the order: it stops at the first cluster that is invalid or that no
// pixel can reach (best_t^2 <= 0.998 * approach distance^2, :1740-1780),
// skips a cluster whose span misses the block's rows or whose slab test no
// ray passes, and sweeps the rest from a double buffer that cp.async fills
// with the next candidate's geometry rows (10 prep rows, 9 raw rows plus
// the block's tv, q, t_num per staged triangle, or, watertight, the 10 raw
// rows turned in place into the block's a, b, c and the validity) while the
// current one is swept. Exact-t ties go to the lower triangle index
// (t < best_t || t == best_t && i < best_i), and the slab test passes
// tmin * 0.999 < best_t, so a cluster holding a triangle that ties the best
// hit is visited whatever the order: the frames are the index-order sweep's
// (render_resident_plain), bit for bit. The winner's (u, v) and attributes
// are resolved once, after the walk, from global memory; the shadow sweep
// (raw_shadows) walks every cluster in index order with its slab test and
// stages each visited cluster's raw rows the same way. The grid is the
// resident route's, (views, tiles), a tile's views next to each other in
// launch order: on bigmesh_512w that ran 6% faster than a grid that keeps
// a view's tiles together for L2 reuse of its clusters
// (port_tools/stream_grid_ab.py).
//
// The binned visit (K4, BINNED, built by csrc/render_binned.cu, which
// includes this file for the body and has its own entry point, so this
// file's entries keep their code): the same walk over the bin of the bin
// tile the block lies in (raytrace_cuda.band_cluster_bins), its cluster ids
// front to back, instead of the view's whole order. The walk's pointers to
// the order, the spans (at 8-row bands) and the cluster table point into
// device memory (every thread of a gate reads the same word), so the
// block's shared memory is the two stage buffers and the camera row. On
// prep rows the staged rows are row-sorted (row 10: the original index gi);
// each of the block's two 8-row bands (threads row-major: warps 0-3 and
// 4-7, so its gates are warp-uniform) sweeps, where the cluster's span
// touches the band, only the sorted lanes [lo, hi) of its image band
// (raytrace_cuda.cluster_row_sort), ties to the lower gi
// (t < best_t || t == best_t && gi < best_gi); the resolve reads the
// winner's prep rows at its sorted lane and its attributes at gi. A band
// below the image sweeps nothing and starts at best_t = 0, so it never
// holds the walk open.
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
// csrc/render_dmxu.cu, which includes this file and brings its own entry
// point): the walk and its staging as above, but a visited cluster's every
// slot is swept, padding included (a padding slot fails through det = 0),
// on prep rows or on the cluster's D, A, Q and t_num formed in the staged
// buffer for the block's camera from its raw rows; each thread takes the
// cluster's first minimum (ties to the lower slot) and merges it into its
// running best with the lower-index tie rule; with rowskip each warp (two
// pixel rows of the block) skips a cluster whose row span misses its rows.
//
// K9 (the factory's seeded switch, :1064-1069, :1205-1209; SEEDED, a
// template switch of the raytrace variants of every route, each an entry of
// its own beside the cold one, whose code stays as it was: a runtime
// pointer in every entry moved 29 of the older entries' times past 1.5% on
// an H100 (port_tools/tree_ab.py);
// this file's routes' and K4's seeded entries build in csrc/render_seeded.cu,
// the resident visits' in their own sources):
// with a seed ([W*C, H, Wd] f32) each pixel's best_t starts at
// min(seed, far) instead of far; a thread past the image edge starts at 0
// (the TPU's padding lanes, _pack_seed_tiles :3968-3972), so it accepts
// nothing and never holds a walk's exit back. A hit at exactly the seed is
// a miss: the strict test t < best_t rejects it, and the tie rule's
// t == best_t && i < best_idx cannot take it before a triangle has been
// accepted (best_idx = -1).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

__device__ __forceinline__ uint32_t quantize(float base, float s, bool hit) {
  float c = clip01(base * (kAmbient + kDiffuse * s));
  c = hit ? c : 0.f;
  return (uint32_t)(int)(c * 255.f + 0.5f);
}

// u8 → f32 texel value: an IEEE divide, bitwise np.float32(k) / 255 (the
// bake's tex_data = u8 / 255).
__device__ __forceinline__ float dequant(int k) {
  return __fdiv_rn((float)k, 255.0f);
}

// Repeat wrap of an index in [-1, n] (:3140-3144).
__device__ __forceinline__ int wrap(int i, int n) {
  i = i < 0 ? i + n : i;
  return i >= n ? i - n : i;
}

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

// The render kernel's body. STREAM false: the resident route (the world's
// geometry rows in shared memory, clusters in index order); true: the
// streamed route (see the header), with BINNED its binned visit (K4: the
// walk below reads the bin, the cluster table and the spans in device
// memory where the ordered walk reads its shared copies). RWALK stays false:
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

template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_streamed_kernel(const RenderArgs a, const StreamArgs s) {
  render_body<GEO, RASTER, TEX, true>(a, s);
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
// The span hooks of port_tools/resident_phase_probe.py (empty here).
#ifndef MRT_PHASE
#define MRT_PHASE_BEGIN
#define MRT_PHASE(k)
#define MRT_AFTER_FILL
#endif

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
  unsigned long long vote[4][2];
};
constexpr int kVisitCtlBytes = 128;
static_assert(sizeof(VisitCtl) <= kVisitCtlBytes, "the visit's shared head");
// A bulk copy's largest piece (the mbarrier counts every piece's bytes).
constexpr unsigned kBulkPiece = 32768;

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

// A resident visit's block: view blockIdx.x, visit_groups<GEO>() groups of
// 16x16 threads (blockDim (16, 16 G)). The fill, once a view: prep rows
// 0-9 (raw: v0, e1, e2, rows 0-8) by one bulk copy, while the threads copy
// the cluster table, the camera row and (ordered) the order and form the
// gate terms and the raw sweep's tv, q, t_num or K10's a, b, c and
// validity; then each group
// takes tiles from the counter until the view's are gone.
template <int GEO, bool RASTER, int TEX, bool BINNED, bool SEEDED>
__device__ __forceinline__ void visit_body(const RenderArgs& a, const int* order,
                                           const BinArgs& bn, const float* seed) {
  constexpr bool RAW = GEO != kGeoPrep;
  constexpr bool WT = GEO >= kGeoRawWt;
  constexpr int kBlock = kThreads * visit_groups<GEO>();
  const int S = a.S, CC = a.CC;
  extern __shared__ __align__(16) float smem[];
  MRT_PHASE_BEGIN;
  VisitCtl& ctl = *reinterpret_cast<VisitCtl*>(smem);
  float* s_geo = smem + kVisitCtlBytes / sizeof(float);  // [smem_geo_rows, S]
  float* s_cl = s_geo + smem_geo_rows<GEO>() * S;          // [8, CC]
  float* s_gate = s_cl + kClRows * CC;                     // [kGateRows, CC]
  float* s_cam = s_gate + kGateRows * CC;                  // [NCOL]
  int* s_order = reinterpret_cast<int*>(s_cam + a.n_cols);  // [CC] (ordered)

  const int view = blockIdx.x;
  const int world = view / a.num_cams;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float* g_rows = a.rows + (size_t)world * kPackRows * S;
  const float* g_cl = a.clusters + (size_t)world * kClRows * CC;
  const float* g_cam = a.cams + (size_t)view * a.n_cols;
  if (tid == 0) {
    ctl.next_tile = 0;
    if constexpr (!WT)
      bulk_fill(s_geo, g_rows, (RAW ? kRawRows : kPrepRows) * S * sizeof(float), &ctl.fill_bar);
  }
  for (int i = tid; i < kClRows * CC; i += kBlock) s_cl[i] = g_cl[i];
  for (int i = tid; i < a.n_cols; i += kBlock) s_cam[i] = g_cam[i];
  {
    // The gate terms: lo - o, hi - o and (approach_dist2, :1740-1780)
    // d2 * kExitSlack of each cluster for this view's camera origin.
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    for (int c = tid; c < CC; c += kBlock) {
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
  if constexpr (!BINNED) {
    const int* g_order = order + (size_t)view * CC;
    for (int i = tid; i < CC; i += kBlock) s_order[i] = g_order[i];
  }
  if constexpr (WT) {
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
  }
  __syncthreads();
  if constexpr (!WT) bulk_wait(&ctl.fill_bar);
  MRT_AFTER_FILL;

  const int g = threadIdx.y / kTileY;
  const int n_tiles = a.tiles_x * ((a.height + kTileY - 1) / kTileY);
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
// csrc/render_resident_binned.cu, csrc/render_seeded.cu, csrc/render_none.cu
// and csrc/render_dmxu.cu include this file for the above and bring their
// own entry point, route and C interface.
#ifndef MRT_RENDER_BODY_ONLY
// The resident route, or with s.order the streamed route's ordered visit;
// the 9-output mode on the streamed visit only (K1's 9-output entries are
// csrc/render_none.cu's).
struct ResidentRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const StreamArgs& s, int num_views,
                 cudaStream_t stream) {
    if constexpr (TEX != kTexNine) {
      if (s.order == nullptr)
        return launch_grid(render_resident_kernel<GEO, RASTER, TEX>, a, num_views,
                           resident_smem<GEO>(a), stream, a);
    } else if (s.order == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    return launch_grid(render_streamed_kernel<GEO, RASTER, TEX>, a, num_views,
                       streamed_smem<GEO>(a), stream, a, s);
  }
};
#endif  // MRT_RENDER_BODY_ONLY

}  // namespace

#ifndef MRT_RENDER_BODY_ONLY
extern "C" {

// Launches the variant (geo, raster, tex_filter) on `stream`, on the
// caller's current device: geo is 0 (prep rows), 1 (raw rows), 2 (raw rows
// with shadows, at most 32 lights), 3 (raw rows, the watertight decision)
// or 4 (3 with shadows); tex_filter is 0 (untextured), 1
// (nearest), 2 (bilinear), 3 (the mip hand-off, written to code and
// handoff instead of rgb) or 4 (the 9-output mode, geo 0, 1 or 3, streamed
// only: t in depth, idx in segmask, the material in code, and z, uv x,
// uv y, nx, ny, nz in the six planes of handoff); mats/pool may be null
// unless it is 1 or 2, and rgb when it is 3 or 4, code/handoff unless it is
// 3 or 4. With order and spans (both or neither) the streamed route runs:
// rows, cluster_size and S must keep every cluster's rows 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown variant.
int mrt_render_resident(const float* rows, const float* clusters,
                        const float* cams, const float* mats, const int* pool,
                        int n_mats, float* depth, int* segmask, uint32_t* rgb,
                        int* code, float* handoff, const int* order,
                        const int* spans, int num_views, int num_cams, int S, int CC,
                        int cluster_size, int n_cols, int n_lights, int height,
                        int width, int seg_div, float two_over_w,
                        float two_over_h, int raster, int tex_filter, int geo,
                        void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if ((order == nullptr) != (spans == nullptr)) return (int)cudaErrorInvalidValue;
  if (order != nullptr &&
      (cluster_size % 4 != 0 || S % 4 != 0 || ((uintptr_t)rows & 15) != 0))
    return (int)cudaErrorMisalignedAddress;
  return launch_variant<ResidentRoute>(a, StreamArgs{order, spans}, num_views, geo,
                                       raster, tex_filter, (cudaStream_t)stream);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // MRT_RENDER_BODY_ONLY
