// K1 / K2 / K6: resident, cluster-culled, shaded ray-cast with the fused
// export, in its raytrace and raster conventions, untextured or textured.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its resident culled shaded variant (prep rows, defer_attrs, uv_defer,
// fused_export), launched at raytrace_pallas.py:4872, together with two of
// that factory's switches:
//   RASTER (K2, raster_clip=True): per-pixel t_lo = near / max(cosf, 1e-6)
//     (:1190-1196), depth = z = t * cosf (:2807), the z-far clip against
//     camera column 16 (:2819-2821, :3037-3039), segmask -1 everywhere
//     (_frames_from_core with_segmask=False, :4962-4975);
//   TEX (K6, textured=True): the winner resolve gathers the material and
//     uv = uv0 + uc*duv1 + vc*duv2 (:2784-2787) instead of the premultiplied
//     colour, and the shading samples the packed texel pool with nearest or
//     bilinear filtering (:3051-3202).
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
//   3. the Möller–Trumbore sweep over the pack-time D/A/Q/t_num rows of the
//      cluster's valid prefix, first-min on t (strict <, ascending index:
//      the lowest index wins exact ties, as argmin does);
//   4. the winner's (u, v) recomputed from the same rows, its normal (and,
//      textured, its material and uv) interpolated from the attribute rows,
//      the normal flipped toward the viewer;
//   5. two-sided lambert + ambient 0.2 summed over the lights, times the
//      base colour (the premultiplied colour row, or the material colour
//      times the texel), RGBA8 packed;
//   6. the export masks: depth = t (raster: z) or 0, segmask = idx / T
//      (raster: -1) or -1, invalid camera → opaque black.
//
// Layout (all f32 unless noted):
//   rows     [W, 40, S]   split pack: rows 0-9 prep D(3) A(3) Q(3) t_num,
//                         rows 16-35 attributes (uv0, duv1, duv2, n0, dn1,
//                         dn2, mat, premultiplied colour rgb, density)
//   clusters [W, 8, CC]   lo.xyz, hi.xyz, valid, valid-prefix count
//   cams     [W*C, NCOL]  see raytrace_cuda._pack_cams
//   mats     [6, M]       textured only: colour rgb, texel offset, width,
//                         height of each material's texture (exact in f32)
//   pool     i32 [texels] textured only: r | g << 8 | b << 16 of each texel
//   depth    [W*C, H, Wd] f32, segmask i32, rgb packed u32 — the final
//                         layout, written directly.
//
// Bound on an H100: FP32 work per pixel is about 110 operations for ray
// generation, resolve and shading (textured: some 30 more for the sample,
// bilinear about 60 more), 25 per cluster slab test and 27 per visited
// triangle, each its own instruction under --fmad=false (so against half
// the published 67 TFLOP/s); the writes are 12 B per pixel (about 200 MB
// per step at 4096 worlds x 64x64). chip_smoke.py works out the exact
// counts for its inputs. The texel pool (at most 128 x 128 texels, 64 KB)
// stays in L1/L2: a texel read is one cached 4-byte load (bilinear: four).
//
// The design is the simple one: one thread per pixel, one 16x16 block per
// (view, tile), the world's prep rows, cluster rows and camera row in
// shared memory (broadcast reads in the sweep), the winner's attributes,
// the material row and the texels read from global memory once per pixel.
// No wgmma or TMA: the work is scalar per pixel. The two switches are
// template parameters, so each variant compiles to its own kernel with no
// runtime branch on them. Left for a later change: several views per block
// and persistent blocks, to amortise the per-block setup.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;
constexpr int kPackRows = 40;   // rows per world in the split pack
constexpr int kPrepRows = 10;   // D(3) A(3) Q(3) t_num
constexpr int kAttr0 = 16;      // first attribute row
constexpr int kClRows = 8;
constexpr int kCamLight0 = 17;  // first light column of a camera row
constexpr int kCamFarZ = 16;    // z-space far clip (raster)

// Texture filters (the TEX template parameter).
constexpr int kTexNone = 0;
constexpr int kTexNearest = 1;
constexpr int kTexBilinear = 2;

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
constexpr uint32_t kAlpha = 0xFF000000u;

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

template <bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_resident_kernel(const float* __restrict__ rows,
                       const float* __restrict__ clusters,
                       const float* __restrict__ cams,
                       const float* __restrict__ mats,
                       const int* __restrict__ pool, int n_mats,
                       float* __restrict__ depth, int* __restrict__ segmask,
                       uint32_t* __restrict__ rgb, int num_cams, int S, int CC,
                       int cluster_size, int n_cols, int n_lights, int height,
                       int width, int tiles_x, int seg_div, float two_over_w,
                       float two_over_h) {
  extern __shared__ float smem[];
  float* s_prep = smem;                     // [10, S]
  float* s_cl = s_prep + kPrepRows * S;     // [8, CC]
  float* s_cam = s_cl + kClRows * CC;       // [NCOL]

  const int view = blockIdx.x;
  const int world = view / num_cams;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float* g_rows = rows + (size_t)world * kPackRows * S;
  const float* g_cl = clusters + (size_t)world * kClRows * CC;
  for (int i = tid; i < kPrepRows * S; i += kThreads) s_prep[i] = g_rows[i];
  for (int i = tid; i < kClRows * CC; i += kThreads) s_cl[i] = g_cl[i];
  for (int i = tid; i < n_cols; i += kThreads)
    s_cam[i] = cams[(size_t)view * n_cols + i];
  __syncthreads();

  const int tile = blockIdx.y;
  const int px = (tile % tiles_x) * kTileX + threadIdx.x;
  const int py = (tile / tiles_x) * kTileY + threadIdx.y;

  const float ox = s_cam[0], oy = s_cam[1], oz = s_cam[2];
  const float rxx = s_cam[3], rxy = s_cam[4], rxz = s_cam[5];
  const float fx = s_cam[6], fy = s_cam[7], fz = s_cam[8];
  const float ux = s_cam[9], uy = s_cam[10], uz = s_cam[11];
  const float tan_x = s_cam[12], tan_y = s_cam[13];
  const float near = s_cam[14], far = s_cam[15];

  // Ray generation (raytrace_pallas.py:1180-1188). Threads past the image
  // edge trace their ray too: they take part in the block-wide cull and
  // write nothing.
  const float a = (((float)px + 0.5f) * two_over_w - 1.0f) * tan_x;
  const float b = (1.0f - ((float)py + 0.5f) * two_over_h) * tan_y;
  float dx = a * rxx + fx + b * ux;
  float dy = a * rxy + fy + b * uy;
  float dz = a * rxz + fz + b * uz;
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

  // best_t starts at far: every accepted hit has t < far (:1199-1211).
  float best_t = far;
  int best_idx = -1;
  const float* s_D0 = s_prep;
  const float* s_D1 = s_prep + S;
  const float* s_D2 = s_prep + 2 * S;
  const float* s_A0 = s_prep + 3 * S;
  const float* s_A1 = s_prep + 4 * S;
  const float* s_A2 = s_prep + 5 * S;
  const float* s_Q0 = s_prep + 6 * S;
  const float* s_Q1 = s_prep + 7 * S;
  const float* s_Q2 = s_prep + 8 * S;
  const float* s_TN = s_prep + 9 * S;

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
    const int base = c * cluster_size;
    const int cnt = (int)s_cl[7 * CC + c];
    for (int i = base; i < base + cnt; ++i) {
      // Möller–Trumbore on the pack-time rows (:1296-1316).
      const float det = dx * s_D0[i] + dy * s_D1[i] + dz * s_D2[i];
      const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
      const float u = (dx * s_A0[i] + dy * s_A1[i] + dz * s_A2[i]) * inv;
      const float v = (dx * s_Q0[i] + dy * s_Q1[i] + dz * s_Q2[i]) * inv;
      const float t = s_TN[i] * inv;
      const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                      (t > t_lo) && (t < best_t);
      if (ok) {
        best_t = t;
        best_idx = i;
      }
    }
  }

  if (px >= width || py >= height) return;

  // Winner resolve (:2725-2793): (u, v) recomputed from the prep rows,
  // attributes read once from global memory. Untextured: the premultiplied
  // colour (rows 16-18); textured: material (row 15) and uv (rows 0-5).
  float nx = 0.f, ny = 0.f, nz = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const bool found = best_idx >= 0;
  if (found) {
    const int j = best_idx;
    const float det = dx * s_D0[j] + dy * s_D1[j] + dz * s_D2[j];
    const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
    const float uc = clip01((dx * s_A0[j] + dy * s_A1[j] + dz * s_A2[j]) * inv);
    const float vc = clip01((dx * s_Q0[j] + dy * s_Q1[j] + dz * s_Q2[j]) * inv);
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

  // Base colour. A miss samples material 0 at uv (0, 0): in range, and
  // masked below.
  float br = a0, bg = a1, bb = a2;
  if (TEX != kTexNone) textured_base<TEX>(mats, pool, n_mats, (int)a0, a1, a2, br, bg, bb);

  // Lambert over the lights (:3015-3035).
  const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kTiny));
  float sr = 0.f, sg = 0.f, sb = 0.f;
  for (int li = 0; li < n_lights; ++li) {
    const float* l = s_cam + kCamLight0 + 6 * li;
    const float nd = fmaxf(-(nx * l[0] + ny * l[1] + nz * l[2]) * n_inv, 0.f);
    sr = sr + nd * l[3];
    sg = sg + nd * l[4];
    sb = sb + nd * l[5];
  }

  // Fused export (:2809-2846, :3041-3050, :3186-3202).
  const bool shaded_hit = RASTER ? found && z < s_cam[kCamFarZ] : found;
  const bool cam_ok = s_cam[kCamLight0 + 6 * n_lights] > 0.f;
  const bool hit = shaded_hit && cam_ok;
  const uint32_t packed = quantize(br, sr, shaded_hit) |
                          (quantize(bg, sg, shaded_hit) << 8) |
                          (quantize(bb, sb, shaded_hit) << 16) | kAlpha;
  const size_t o = ((size_t)view * height + py) * width + px;
  if (RASTER) {
    depth[o] = hit ? z : 0.f;
    segmask[o] = -1;
  } else {
    depth[o] = hit ? best_t : 0.f;
    segmask[o] = hit ? best_idx / seg_div : -1;
  }
  rgb[o] = cam_ok ? packed : kAlpha;
}

template <bool RASTER, int TEX>
int launch(const float* rows, const float* clusters, const float* cams,
           const float* mats, const int* pool, int n_mats, float* depth,
           int* segmask, uint32_t* rgb, int num_views, int num_cams, int S,
           int CC, int cluster_size, int n_cols, int n_lights, int height,
           int width, int seg_div, float two_over_w, float two_over_h,
           cudaStream_t stream) {
  const int tiles_x = (width + kTileX - 1) / kTileX;
  const int tiles_y = (height + kTileY - 1) / kTileY;
  const size_t smem =
      sizeof(float) * ((size_t)kPrepRows * S + (size_t)kClRows * CC + n_cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_resident_kernel<RASTER, TEX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(num_views, tiles_x * tiles_y);
  const dim3 block(kTileX, kTileY);
  render_resident_kernel<RASTER, TEX><<<grid, block, smem, stream>>>(
      rows, clusters, cams, mats, pool, n_mats, depth, segmask, rgb, num_cams,
      S, CC, cluster_size, n_cols, n_lights, height, width, tiles_x, seg_div,
      two_over_w, two_over_h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the variant (raster, tex_filter) on `stream`, on the caller's
// current device; tex_filter is 0 (untextured), 1 (nearest) or 2
// (bilinear), and mats/pool may be null when it is 0. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown variant.
int mrt_render_resident(const float* rows, const float* clusters,
                        const float* cams, const float* mats, const int* pool,
                        int n_mats, float* depth, int* segmask, uint32_t* rgb,
                        int num_views, int num_cams, int S, int CC,
                        int cluster_size, int n_cols, int n_lights, int height,
                        int width, int seg_div, float two_over_w,
                        float two_over_h, int raster, int tex_filter,
                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define MRT_LAUNCH(R, T)                                                    \
  return launch<R, T>(rows, clusters, cams, mats, pool, n_mats, depth,     \
                      segmask, rgb, num_views, num_cams, S, CC,            \
                      cluster_size, n_cols, n_lights, height, width,       \
                      seg_div, two_over_w, two_over_h, st)
  if (!raster && tex_filter == kTexNone) MRT_LAUNCH(false, kTexNone);
  if (!raster && tex_filter == kTexNearest) MRT_LAUNCH(false, kTexNearest);
  if (!raster && tex_filter == kTexBilinear) MRT_LAUNCH(false, kTexBilinear);
  if (raster && tex_filter == kTexNone) MRT_LAUNCH(true, kTexNone);
  if (raster && tex_filter == kTexNearest) MRT_LAUNCH(true, kTexNearest);
  if (raster && tex_filter == kTexBilinear) MRT_LAUNCH(true, kTexBilinear);
#undef MRT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
