// K12, the batched kernel (accel="mxu"): per view a prepass of each
// triangle's pinhole factorisation, then per pixel the numerators, one
// reciprocal and the hit tests over every triangle, the first minimum, and
// the winner's resolve; shaded (untextured scenes) or the 9-output mode.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_batched_kernel
// (:3679), launched at :4671 under accel="mxu". With tv = o - v0 (o the
// view's camera origin) the prepass rows of a triangle are (:3757-3784)
//   D = e2 x e1, A = e2 x tv, B = tv x e1, t_num = e2 . B,
// each component the JAX expression; per pixel (ray d) det = d . D,
// u = (d . A) * inv, v = (d . B) * inv, t = t_num * inv, inv = 1 / det
// where |det| > 1e-10 and 0 otherwise (:3850-3853), each dot three products
// summed x, y, z in that order (the TPU kernel forms them as one MXU matmul
// of the [10, K] prepass block against a block-diagonal direction matrix,
// whose t_num band multiplies by a row of ones: exactly t_num). A triangle
// is a hit when u >= -eps, v >= -eps, u + v <= 1 + eps, t > t_lo (raster:
// near / max(cos, 1e-6), :3802-3803) and t < far; the winner is the first
// minimum in triangle order (the TPU kernel's iota-min within a chunk and
// strict < across chunks: the same rule). The resolve (:3882-3903, a one-hot
// matmul there, a gather of the winner's rows here: the same values for
// finite data) recomputes the winner's (u, v) from its prepass rows, clips
// them to [0, 1] and interpolates the normal (flipped toward the viewer),
// and either shades (lambert over the lights plus ambient 0.2 times the
// colour rows, black off a hit, raster: z >= the z-far clip is no hit;
// :3920-3954) or writes the 9-output mode's material, uv and normal
// (:3955-3963). A miss writes t 0, z 0, idx -1 and zeros (mat 0, uv 0, the
// normal 0 with the flip +1). Nothing is masked by the camera's validity:
// the epilogue does that (raytrace_cuda.frames_from_core, the JAX
// _frames_from_core :4962-5018).
// The plain PyTorch version is ops/raytrace_cuda.py::render_batched_plain;
// with --fmad=false and IEEE divide and square root the two agree bit for
// bit. K12's frames differ from K1's by rounding (the factorisation rounds
// otherwise than the pack-time prep rows or the pvec test).
//
// Layout (all f32 unless noted):
//   rows   [W, 40, S]    K13's raw layout: rows 0-8 v0, e1, e2 (edges times
//                        the validity), rows 16-35 the attributes (uv0,
//                        duv1, duv2, n0, dn1, dn2, material, colour rgb,
//                        density): the values of the JAX 32-row layout's
//                        rows 0-8 and 10-29
//   cams   [W*C, NCOL]   raytrace_cuda._pack_cams
//   t, idx (i32)         [W*C, H, Wd]
//   planes [1 or 6, W*C, H, Wd]  z (shaded); z, uv x, uv y, nx, ny, nz (nine)
//   ints   i32 [W*C, H, Wd]      packed rgb (shaded) or the material (nine)
//
// Bound on an H100: per triangle and block the prepass (9 for tv and the
// cross products of D, A, B: 18 products and 9 subtractions, and t_num's 5:
// 32 operations), per pixel and triangle the three numerators (15), the
// reciprocal and its guard (3), u, v, t (3) and the five tests (6): 27
// operations; per pixel the ray (30), the resolve (the winner's prepass 32
// and numerators 21, the clips 4, the normal 12, the flip 9) and the shading
// (29 + 14 per light) or the uv (8). Each is its own instruction under
// --fmad=false. chip_smoke.py counts them for its inputs.
//
// Two designs, each a launch plan (raytrace_cuda.batched_plan: pixels a
// thread). The parent design (pixels 0, render_batched_kernel): one thread
// per pixel of a 16x16 block of one view; the block computes the prepass
// rows of a chunk of kChunk triangles into shared memory (one triangle a
// thread), every thread sweeps the chunk in index order (10 scalar shared
// loads a test), and the next chunk follows; the resolve recomputes the
// winner's prepass from device memory. The design for the card (pixels 4,
// render_batched_rec_kernel, below): the prepass as records of three float4
// a triangle, four pixels a thread of a 32 x 8 block sharing each record's
// loads, the acceptance as one predicate, the winner's (u, v) from
// its record. Both give the plain version's bits; chip_smoke.py holds every
// entry at each plan against the plain version. The bound counts the work,
// whatever design makes it. No tensor cores: FP32 has no tensor-core path,
// and TF32 (or a 3xTF32 split) rounds the numerators otherwise than the
// plain version; that redesign is a lever for later.

#include <cuda_runtime.h>
#include <stdint.h>

// The span hooks of port_tools/batched_phase_probe.py (empty here).
#ifndef MRT_PHASE
#define MRT_PHASE_BEGIN
#define MRT_PHASE(k)
#endif

namespace {

constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;
constexpr int kChunk = 256;   // triangles a block's prepass holds
constexpr int kPreRows = 10;  // D(3) A(3) B(3) t_num
constexpr int kPackRows = 40;
constexpr int kAttr0 = 16;
constexpr int kCamLight0 = 17;
constexpr int kCamFarZ = 16;

constexpr float kEpsDet = 1e-10f;
constexpr float kEpsBary = 1e-6f;
constexpr float kOnePlusEps = (float)(1.0 + 1e-6);
constexpr float kAmbient = 0.2f;
constexpr float kDiffuse = (float)(1.0 - 0.2);
constexpr float kTiny = 1e-20f;
constexpr float kCosFloor = 1e-6f;
constexpr uint32_t kAlpha = 0xFF000000u;

struct BatchedArgs {
  const float* rows;  // [W, 40, S]
  const float* cams;  // [W*C, NCOL]
  float* t;           // [W*C, H, Wd]
  int* idx;
  float* planes;      // [1 | 6, W*C, H, Wd]
  int* ints;          // rgb or the material
  int num_cams, S, n_cols, n_lights, height, width, tiles_x;
  float two_over_w, two_over_h;
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

__device__ __forceinline__ uint32_t quantize(float base, float s, bool hit) {
  float c = clip01(base * (kAmbient + kDiffuse * s));
  c = hit ? c : 0.f;
  return (uint32_t)(int)(c * 255.f + 0.5f);
}

// Triangle i's prepass rows (:3772-3784) into p[k * st], k = 0..9.
__device__ __forceinline__ void prepass(const float* g, int S, int i, float ox, float oy,
                                        float oz, float* p, int st) {
  const float v0x = g[i], v0y = g[S + i], v0z = g[2 * S + i];
  const float e1x = g[3 * S + i], e1y = g[4 * S + i], e1z = g[5 * S + i];
  const float e2x = g[6 * S + i], e2y = g[7 * S + i], e2z = g[8 * S + i];
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  p[0] = e2y * e1z - e2z * e1y;
  p[st] = e2z * e1x - e2x * e1z;
  p[2 * st] = e2x * e1y - e2y * e1x;
  p[3 * st] = e2y * tvz - e2z * tvy;
  p[4 * st] = e2z * tvx - e2x * tvz;
  p[5 * st] = e2x * tvy - e2y * tvx;
  const float bx = tvy * e1z - tvz * e1y;
  const float by = tvz * e1x - tvx * e1z;
  const float bz = tvx * e1y - tvy * e1x;
  p[6 * st] = bx;
  p[7 * st] = by;
  p[8 * st] = bz;
  p[9 * st] = e2x * bx + e2y * by + e2z * bz;
}

// The numerators and the divide (:3838-3853) on prepass rows p[k * st].
__device__ __forceinline__ void numerators(const float* p, int st, float dx, float dy,
                                           float dz, float& u, float& v, float& t) {
  const float det = (p[0] * dx + p[st] * dy) + p[2 * st] * dz;
  const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
  u = ((p[3 * st] * dx + p[4 * st] * dy) + p[5 * st] * dz) * inv;
  v = ((p[6 * st] * dx + p[7 * st] * dy) + p[8 * st] * dz) * inv;
  t = p[9 * st] * inv;
}

template <bool RASTER, bool NINE>
__global__ void __launch_bounds__(kThreads) render_batched_kernel(const BatchedArgs a) {
  __shared__ float s_pre[kPreRows * kChunk];
  const int view = blockIdx.x;
  const int world = view / a.num_cams;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int S = a.S;
  const float* g = a.rows + (size_t)world * kPackRows * S;
  const float* cam = a.cams + (size_t)view * a.n_cols;
  const int tile = blockIdx.y;
  const int px = (tile % a.tiles_x) * kTileX + threadIdx.x;
  const int py = (tile / a.tiles_x) * kTileY + threadIdx.y;

  const float ox = cam[0], oy = cam[1], oz = cam[2];
  const float rxx = cam[3], rxy = cam[4], rxz = cam[5];
  const float fx = cam[6], fy = cam[7], fz = cam[8];
  const float ux = cam[9], uy = cam[10], uz = cam[11];
  const float tan_x = cam[12], tan_y = cam[13];
  const float near = cam[14], far = cam[15];

  // Ray generation (:3787-3798).
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

  // best_t starts at far: t < best_t is the kernel's t < far for the first
  // hit and strict first-min after it.
  float best_t = far;
  int best_idx = -1;
  for (int k0 = 0; k0 < S; k0 += kChunk) {
    const int n = min(kChunk, S - k0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = tid; k < n; k += kThreads) prepass(g, S, k0 + k, ox, oy, oz, s_pre + k, kChunk);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float u, v, t;
      numerators(s_pre + k, kChunk, dx, dy, dz, u, v, t);
      if (u >= -kEpsBary && v >= -kEpsBary && u + v <= kOnePlusEps && t > t_lo &&
          t < best_t) {
        best_t = t;
        best_idx = k0 + k;
      }
    }
  }
  if (px >= a.width || py >= a.height) return;

  // The winner's resolve: its prepass rows recomputed (the same expressions
  // on the same values: the sweep's bits), (u, v) clipped, the attributes.
  const bool found = best_idx >= 0;
  float uc = 0.f, vc = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  const int j = found ? best_idx : 0;
  const float* at = g + (size_t)kAttr0 * S;
  if (found) {
    float p[kPreRows];
    prepass(g, S, j, ox, oy, oz, p, 1);
    float u, v, t;
    numerators(p, 1, dx, dy, dz, u, v, t);
    uc = clip01(u);
    vc = clip01(v);
    nx = at[6 * S + j] + uc * at[9 * S + j] + vc * at[12 * S + j];
    ny = at[7 * S + j] + uc * at[10 * S + j] + vc * at[13 * S + j];
    nz = at[8 * S + j] + uc * at[11 * S + j] + vc * at[14 * S + j];
  }
  const float flip = nx * dx + ny * dy + nz * dz > 0.f ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;
  const float t_hit = found ? best_t : 0.f;
  const float z = t_hit * cosf_;
  const size_t o = ((size_t)view * a.height + py) * a.width + px;
  const size_t plane = (size_t)gridDim.x * a.height * a.width;
  a.t[o] = t_hit;
  a.idx[o] = best_idx;
  a.planes[o] = z;
  if constexpr (NINE) {
    float uvx = 0.f, uvy = 0.f, mat = 0.f;
    if (found) {
      mat = at[15 * S + j];
      uvx = at[j] + uc * at[2 * S + j] + vc * at[4 * S + j];
      uvy = at[S + j] + uc * at[3 * S + j] + vc * at[5 * S + j];
    }
    a.ints[o] = (int)mat;
    a.planes[plane + o] = uvx;
    a.planes[2 * plane + o] = uvy;
    a.planes[3 * plane + o] = nx;
    a.planes[4 * plane + o] = ny;
    a.planes[5 * plane + o] = nz;
  } else {
    const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kTiny));
    float sr = 0.f, sg = 0.f, sb = 0.f;
    for (int li = 0; li < a.n_lights; ++li) {
      const float* l = cam + kCamLight0 + 6 * li;
      const float nd = fmaxf(-(nx * l[0] + ny * l[1] + nz * l[2]) * n_inv, 0.f);
      sr = sr + nd * l[3];
      sg = sg + nd * l[4];
      sb = sb + nd * l[5];
    }
    const bool hit = RASTER ? found && z < cam[kCamFarZ] : found;
    const float br = found ? at[16 * S + j] : 0.f;
    const float bg = found ? at[17 * S + j] : 0.f;
    const float bb = found ? at[18 * S + j] : 0.f;
    a.ints[o] = (int)(quantize(br, sr, hit) | (quantize(bg, sg, hit) << 8) |
                      (quantize(bb, sb, hit) << 16) | kAlpha);
  }
}

// ---- The design for the card: records, several pixels a thread --------- //
// A block of 32 x 8 threads covers 32 x 8P pixels of one view (thread (x, y)
// the pixels (x, y + 8q), q < P: a warp's writes are 128-byte rows), so one
// prepass serves 256P pixels. Triangle i's prepass is a record of three
// float4 (D with t_num, A, B: the same values as the parent's rows), so a
// test reads 3 broadcast 16-byte shared loads, shared by the thread's P rays,
// where the parent reads 10 scalar ones a ray. The acceptance is one
// predicate (fminf(u, v) >= -eps && u + v <= 1 + eps && t > t_lo &&
// t < best_t: the parent's chain, bit for bit, NaNs included: a NaN u or v
// fails u + v <= 1 + eps) and the first minimum two selects. The resolve
// takes the winner's record from shared memory when it lies in the last
// chunk (every triangle when S <= kChunk), else recomputes its prepass from
// device memory as the parent does: the same expressions on the same values.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
// Pixels a thread: of 1, 2 and 4, 4 ran fastest on every K12 path's inputs
// (port_tools/dense_plan_ab.py).
constexpr int kPixels = 4;

// Triangle i's prepass (prepass's expressions) as a record r[0..2].
__device__ __forceinline__ void prepass_record(const float* g, int S, int i, float ox,
                                               float oy, float oz, float4* r) {
  const float v0x = g[i], v0y = g[S + i], v0z = g[2 * S + i];
  const float e1x = g[3 * S + i], e1y = g[4 * S + i], e1z = g[5 * S + i];
  const float e2x = g[6 * S + i], e2y = g[7 * S + i], e2z = g[8 * S + i];
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  const float bx = tvy * e1z - tvz * e1y;
  const float by = tvz * e1x - tvx * e1z;
  const float bz = tvx * e1y - tvy * e1x;
  r[0] = make_float4(e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z, e2x * e1y - e2y * e1x,
                     e2x * bx + e2y * by + e2z * bz);
  r[1] = make_float4(e2y * tvz - e2z * tvy, e2z * tvx - e2x * tvz, e2x * tvy - e2y * tvx, 0.f);
  r[2] = make_float4(bx, by, bz, 0.f);
}

// numerators' expressions on a record.
__device__ __forceinline__ void record_numerators(const float4& r0, const float4& r1,
                                                  const float4& r2, float dx, float dy,
                                                  float dz, float& u, float& v, float& t) {
  const float det = (r0.x * dx + r0.y * dy) + r0.z * dz;
  const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
  u = ((r1.x * dx + r1.y * dy) + r1.z * dz) * inv;
  v = ((r2.x * dx + r2.y * dy) + r2.z * dz) * inv;
  t = r0.w * inv;
}

// One pixel's resolve, shading or 9-output export and writes, as the
// parent kernel's (its winner's (u, v) given).
template <bool RASTER, bool NINE>
__device__ __forceinline__ void finish_pixel(const BatchedArgs& a, const float* g,
                                             const float* cam, int view, int px, int py,
                                             float dx, float dy, float dz, float cosf_,
                                             float best_t, int best_idx, float u, float v) {
  const int S = a.S;
  const bool found = best_idx >= 0;
  float uc = 0.f, vc = 0.f, nx = 0.f, ny = 0.f, nz = 0.f;
  const int j = found ? best_idx : 0;
  const float* at = g + (size_t)kAttr0 * S;
  if (found) {
    uc = clip01(u);
    vc = clip01(v);
    nx = at[6 * S + j] + uc * at[9 * S + j] + vc * at[12 * S + j];
    ny = at[7 * S + j] + uc * at[10 * S + j] + vc * at[13 * S + j];
    nz = at[8 * S + j] + uc * at[11 * S + j] + vc * at[14 * S + j];
  }
  const float flip = nx * dx + ny * dy + nz * dz > 0.f ? -1.0f : 1.0f;
  nx = nx * flip;
  ny = ny * flip;
  nz = nz * flip;
  const float t_hit = found ? best_t : 0.f;
  const float z = t_hit * cosf_;
  const size_t o = ((size_t)view * a.height + py) * a.width + px;
  const size_t plane = (size_t)gridDim.x * a.height * a.width;
  a.t[o] = t_hit;
  a.idx[o] = best_idx;
  a.planes[o] = z;
  if constexpr (NINE) {
    float uvx = 0.f, uvy = 0.f, mat = 0.f;
    if (found) {
      mat = at[15 * S + j];
      uvx = at[j] + uc * at[2 * S + j] + vc * at[4 * S + j];
      uvy = at[S + j] + uc * at[3 * S + j] + vc * at[5 * S + j];
    }
    a.ints[o] = (int)mat;
    a.planes[plane + o] = uvx;
    a.planes[2 * plane + o] = uvy;
    a.planes[3 * plane + o] = nx;
    a.planes[4 * plane + o] = ny;
    a.planes[5 * plane + o] = nz;
  } else {
    const float n_inv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kTiny));
    float sr = 0.f, sg = 0.f, sb = 0.f;
    for (int li = 0; li < a.n_lights; ++li) {
      const float* l = cam + kCamLight0 + 6 * li;
      const float nd = fmaxf(-(nx * l[0] + ny * l[1] + nz * l[2]) * n_inv, 0.f);
      sr = sr + nd * l[3];
      sg = sg + nd * l[4];
      sb = sb + nd * l[5];
    }
    const bool hit = RASTER ? found && z < cam[kCamFarZ] : found;
    const float br = found ? at[16 * S + j] : 0.f;
    const float bg = found ? at[17 * S + j] : 0.f;
    const float bb = found ? at[18 * S + j] : 0.f;
    a.ints[o] = (int)(quantize(br, sr, hit) | (quantize(bg, sg, hit) << 8) |
                      (quantize(bb, sb, hit) << 16) | kAlpha);
  }
}

template <bool RASTER, bool NINE, int P>
__global__ void __launch_bounds__(kBlockX * kBlockY)
render_batched_rec_kernel(const BatchedArgs a) {
  __shared__ float4 s_rec[3 * kChunk];
  MRT_PHASE_BEGIN;
  const int view = blockIdx.x;
  const int world = view / a.num_cams;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int S = a.S;
  const float* g = a.rows + (size_t)world * kPackRows * S;
  const float* cam = a.cams + (size_t)view * a.n_cols;
  const int blocks_x = (a.width + kBlockX - 1) / kBlockX;
  const int px = (blockIdx.y % blocks_x) * kBlockX + threadIdx.x;
  const int py0 = (blockIdx.y / blocks_x) * (kBlockY * P) + threadIdx.y;

  const float ox = cam[0], oy = cam[1], oz = cam[2];
  const float rxx = cam[3], rxy = cam[4], rxz = cam[5];
  const float fx = cam[6], fy = cam[7], fz = cam[8];
  const float ux = cam[9], uy = cam[10], uz = cam[11];
  const float tan_x = cam[12], tan_y = cam[13];
  const float near = cam[14], far = cam[15];

  // Ray generation (:3787-3798), each of the thread's P pixels.
  float dx[P], dy[P], dz[P], cosf_[P], t_lo[P], best_t[P];
  int best_idx[P];
  const float ra = (((float)px + 0.5f) * a.two_over_w - 1.0f) * tan_x;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const float rb = (1.0f - ((float)(py0 + kBlockY * q) + 0.5f) * a.two_over_h) * tan_y;
    float x = ra * rxx + fx + rb * ux;
    float y = ra * rxy + fy + rb * uy;
    float z = ra * rxz + fz + rb * uz;
    const float inv_len = 1.0f / sqrtf(x * x + y * y + z * z);
    dx[q] = x * inv_len;
    dy[q] = y * inv_len;
    dz[q] = z * inv_len;
    cosf_[q] = dx[q] * fx + dy[q] * fy + dz[q] * fz;
    t_lo[q] = RASTER ? near / fmaxf(cosf_[q], kCosFloor) : near;
    best_t[q] = far;
    best_idx[q] = -1;
  }

  int k0 = 0;
  for (; k0 < S; k0 += kChunk) {
    const int n = min(kChunk, S - k0);
    MRT_PHASE(0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = tid; k < n; k += kBlockX * kBlockY)
      prepass_record(g, S, k0 + k, ox, oy, oz, s_rec + 3 * k);
    __syncthreads();
    MRT_PHASE(1);
#pragma unroll 2
    for (int k = 0; k < n; ++k) {
      const float4 r0 = s_rec[3 * k], r1 = s_rec[3 * k + 1], r2 = s_rec[3 * k + 2];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float u, v, t;
        record_numerators(r0, r1, r2, dx[q], dy[q], dz[q], u, v, t);
        const bool ok = (fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) &&
                        (t > t_lo[q]) && (t < best_t[q]);
        best_t[q] = ok ? t : best_t[q];
        best_idx[q] = ok ? k0 + k : best_idx[q];
      }
    }
  }
  const int last0 = k0 - kChunk;  // the chunk the records hold

#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int py = py0 + kBlockY * q;
    if (px >= a.width || py >= a.height) continue;
    MRT_PHASE(2);
    // The winner's (u, v): its record, or its prepass from device memory.
    float u = 0.f, v = 0.f, t;
    const int j = best_idx[q];
    if (j >= 0 && j >= last0) {
      const float4* r = s_rec + 3 * (j - last0);
      record_numerators(r[0], r[1], r[2], dx[q], dy[q], dz[q], u, v, t);
    } else if (j >= 0) {
      float4 r[3];
      prepass_record(g, S, j, ox, oy, oz, r);
      record_numerators(r[0], r[1], r[2], dx[q], dy[q], dz[q], u, v, t);
    }
    MRT_PHASE(3);
    finish_pixel<RASTER, NINE>(a, g, cam, view, px, py, dx[q], dy[q], dz[q], cosf_[q],
                               best_t[q], j, u, v);
  }
}

template <bool RASTER, bool NINE>
int launch(const BatchedArgs& a, int num_views, int pixels, cudaStream_t stream) {
  if (pixels == 0) {  // the parent design: one pixel a thread of a 16x16 tile
    const int tiles_y = (a.height + kTileY - 1) / kTileY;
    const dim3 grid(num_views, a.tiles_x * tiles_y);
    const dim3 block(kTileX, kTileY);
    render_batched_kernel<RASTER, NINE><<<grid, block, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int rows = kBlockY * pixels;
  const dim3 grid(num_views, ((a.width + kBlockX - 1) / kBlockX) * ((a.height + rows - 1) / rows));
  const dim3 block(kBlockX, kBlockY);
  if (pixels != kPixels) return (int)cudaErrorInvalidValue;
  render_batched_rec_kernel<RASTER, NINE, kPixels><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K12 on `stream`, on the caller's current device: raster 0/1 (the
// raytrace or raster conventions), nine 0 (shaded: z in planes[0], packed
// rgb in ints) or 1 (the 9-output mode: z, uv x, uv y, nx, ny, nz in
// planes[0..5], the material in ints); pixels 4 a thread of a 32 x 8 block
// on the records, or 0: the parent design (one a thread of a 16x16 block). Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for another count of pixels.
int mrt_render_batched(const float* rows, const float* cams, float* t, int* idx,
                       float* planes, int* ints, int num_views, int num_cams, int S,
                       int n_cols, int n_lights, int height, int width, float two_over_w,
                       float two_over_h, int raster, int nine, int pixels, void* stream) {
  const BatchedArgs a{rows, cams, t, idx, planes, ints, num_cams, S, n_cols, n_lights,
                      height, width, (width + kTileX - 1) / kTileX, two_over_w,
                      two_over_h};
  const cudaStream_t s = (cudaStream_t)stream;
  if (raster)
    return nine ? launch<true, true>(a, num_views, pixels, s)
                : launch<true, false>(a, num_views, pixels, s);
  return nine ? launch<false, true>(a, num_views, pixels, s)
              : launch<false, false>(a, num_views, pixels, s);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
