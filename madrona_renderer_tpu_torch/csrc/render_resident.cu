// K1: resident, cluster-culled, shaded ray-cast with the fused export.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its resident culled shaded variant (prep rows, defer_attrs, uv_defer,
// fused_export), launched at raytrace_pallas.py:4872. The plain PyTorch
// version is ops/raytrace_cuda.py::render_resident_plain; both compute the
// same expressions in the same order, so with --fmad=false (no mul+add
// contraction) and IEEE divide/sqrt the two agree bit for bit.
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
//   4. the winner's (u, v) recomputed from the same rows, its normal
//      interpolated from the attribute rows and flipped toward the viewer;
//   5. two-sided lambert + ambient 0.2 summed over the lights, RGBA8 packed;
//   6. the export masks: depth = t or 0, segmask = idx / T or -1, invalid
//      camera → opaque black.
//
// Layout (all f32 unless noted):
//   rows     [W, 40, S]   split pack: rows 0-9 prep D(3) A(3) Q(3) t_num,
//                         rows 16-34 attributes (uv0, duv1, duv2, n0, dn1,
//                         dn2, mat, premultiplied colour rgb, density)
//   clusters [W, 8, CC]   lo.xyz, hi.xyz, valid, valid-prefix count
//   cams     [W*C, NCOL]  see raytrace_cuda._pack_cams
//   depth    [W*C, H, Wd] f32, segmask i32, rgb packed u32 — the final
//                         layout, written directly.
//
// Bound on an H100: FP32 work per pixel is about 110 operations for ray
// generation, resolve and shading, 25 per cluster slab test and 27 per
// visited triangle, each its own instruction under --fmad=false (so against
// half the published 67 TFLOP/s); the writes are 12 B per pixel (about
// 200 MB per step at 4096 worlds x 64x64). chip_smoke.py works out the
// exact counts for its inputs. At the headline scene (2 clusters of at most
// 12 valid triangles) both bounds are well under a millisecond; the likely
// cost on top is block setup: each block copies its world's rows (under
// 2 KB there) into shared memory for 256 pixels.
//
// The design is the simple one: one thread per pixel, one 16x16 block per
// (view, tile), the world's prep rows, cluster rows and camera row in
// shared memory (broadcast reads in the sweep), the winner's attributes read
// from global memory once per pixel. No wgmma or TMA: the work is scalar
// per pixel. Left for a later change: several views per block and
// persistent blocks, to amortise the per-block setup.

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

// The JAX constants: _EPS_DET, _EPS_BARY and 1 + _EPS_BARY are Python
// floats rounded once to f32; AMBIENT and 1 - AMBIENT likewise.
constexpr float kEpsDet = 1e-10f;
constexpr float kEpsBary = 1e-6f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-6);
constexpr float kAmbient = 0.2f;
constexpr float kDiffuse = (float)(1.0 - 0.2);
constexpr float kTiny = 1e-20f;
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

__global__ void __launch_bounds__(kThreads)
render_resident_kernel(const float* __restrict__ rows,
                       const float* __restrict__ clusters,
                       const float* __restrict__ cams,
                       float* __restrict__ depth, int* __restrict__ segmask,
                       uint32_t* __restrict__ rgb, int num_cams, int S, int CC, int cluster_size,
                       int n_cols, int n_lights, int height, int width,
                       int tiles_x, int seg_div, float two_over_w,
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
    // Slab test of the cluster's world-space AABB (:1671-1697).
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
                      (t > near) && (t < best_t);
      if (ok) {
        best_t = t;
        best_idx = i;
      }
    }
  }

  if (px >= width || py >= height) return;

  // Winner resolve (:2725-2793): (u, v) recomputed from the prep rows,
  // attributes read once from global memory.
  float nx = 0.f, ny = 0.f, nz = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
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
    cr = g_attr[16 * S + j];
    cg = g_attr[17 * S + j];
    cb = g_attr[18 * S + j];
  }

  // Two-sided: flip the normal toward the viewer (:2800-2804).
  const float ndotd = nx * dx + ny * dy + nz * dz;
  const float flip = ndotd > 0.f ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;

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

  // Fused export (:2809-2846, :3041-3050).
  const bool cam_ok = s_cam[kCamLight0 + 6 * n_lights] > 0.f;
  const bool hit = found && cam_ok;
  const uint32_t packed = quantize(cr, sr, found) |
                          (quantize(cg, sg, found) << 8) |
                          (quantize(cb, sb, found) << 16) | kAlpha;
  const size_t o = ((size_t)view * height + py) * width + px;
  depth[o] = hit ? best_t : 0.f;
  segmask[o] = hit ? best_idx / seg_div : -1;
  rgb[o] = cam_ok ? packed : kAlpha;
}

}  // namespace

extern "C" {

// Launches K1 on `stream`, on the caller's current device; returns
// cudaGetLastError() after the launch (0 on success).
int mrt_render_resident(const float* rows, const float* clusters,
                        const float* cams, float* depth, int* segmask,
                        uint32_t* rgb, int num_views, int num_cams, int S,
                        int CC, int cluster_size, int n_cols, int n_lights,
                        int height, int width, int seg_div, float two_over_w,
                        float two_over_h, void* stream) {
  const int tiles_x = (width + kTileX - 1) / kTileX;
  const int tiles_y = (height + kTileY - 1) / kTileY;
  const size_t smem =
      sizeof(float) * ((size_t)kPrepRows * S + (size_t)kClRows * CC + n_cols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(render_resident_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(num_views, tiles_x * tiles_y);
  const dim3 block(kTileX, kTileY);
  render_resident_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      rows, clusters, cams, depth, segmask, rgb, num_cams, S, CC,
      cluster_size, n_cols, n_lights, height, width, tiles_x, seg_div,
      two_over_w, two_over_h);
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
