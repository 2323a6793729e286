// K13: the fused input pack — instance transforms x object triangles →
// the [W, 40, S] split rows K1 reads, in the prep or the raw layout.
//
// Replaces madrona_renderer_tpu/ops/pack_pallas.py::_make_kernel (launched
// by pack_rows_pallas at pack_pallas.py:374, split=True, with the camera
// origin for the prep layout and without it for the raw layout, :275-292).
// The plain PyTorch version is ops/raytrace_cuda.py::_pack_rows_planar
// (with planar_soup_parts and quat_rotate_planar inside it); every
// expression below is one of those torch ops, term for term and in the same
// order, so with --fmad=false and IEEE divide/sqrt the two agree bit for
// bit. The TPU kernel selects the object's planes with an unrolled O-way
// select (Mosaic has no gather); here each thread reads them directly by
// object id.
//
// One thread per (world, triangle slot s = instance * T + triangle). It
// reads its instance's position, quaternion, scale and valid flag and the
// object's triangle (v0, e1, e2, normals, uvs, material, valid), and writes
// all 40 rows of its slot:
//   rows 0-9   PREP: D = ve2 x ve1, A = ve2 x tv, Q = tv x ve1,
//              t_num = ve2 . Q (ve = e * valid, tv = camera origin - v0);
//              raw: v0, ve1, ve2 in rows 0-8, row 9 the validity (the JAX
//              32-row pack's row 9, raytrace_pallas.py:281-286), which the
//              watertight sweep (K10) ANDs into its decision;
//   rows 10-15 zero;
//   rows 16-35 uv0, duv1, duv2, n0, dn1, dn2 (world space), material id,
//              material colour rgb, texel density;
//   rows 36-39 zero.
// The layout is the PREP template parameter: each layout compiles to its
// own kernel, and the prep kernel keeps its code.
//
// Bound on an H100: bytes. Each slot writes 160 B and reads well under
// that (the instance scalars are shared by T threads, the object tables by
// all worlds), against about 290 FP32 operations in the prep layout (six
// quaternion rotations, the inverse scale, the prep products, the density;
// the raw layout drops the 41 prep products for 6 validity products), so
// the 3.35 TB/s write stream is the floor: 21 MB per step at 4096 worlds x
// 32 slots. Consecutive threads take consecutive slots of one world, so
// every row store of a warp is one contiguous 128-byte run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 40;

struct PackArgs {
  const float* inst_pos;    // [W, I, 3]
  const float* inst_rot;    // [W, I, 4] (w, x, y, z)
  const float* inst_scale;  // [W, I, 3]
  const float* inst_valid;  // [W, I]
  const int* inst_obj;      // [W, I]
  const float* cam_pos;     // [W, 3] (PREP only)
  const float* v0;          // [O, T, 3] (and e1, e2, n0, dn1, dn2)
  const float* e1;
  const float* e2;
  const float* n0;
  const float* dn1;
  const float* dn2;
  const float* uv0;         // [O, T, 2] (and duv1, duv2)
  const float* duv1;
  const float* duv2;
  const int* tri_mat;       // [O, T]
  const float* tri_valid;   // [O, T]
  const float* mat_color;   // [M, 4]
  const int* mat_tex;       // [M]
  const int* tex_width;     // [K]
  const int* tex_height;    // [K]
  float* out;               // [W, 40, S]
  int W, I, T;
};

// ops/quat.py::quat_rotate_planar, term for term.
__device__ __forceinline__ void rot3(float qw, float qx, float qy, float qz,
                                     float vx, float vy, float vz, float& rx,
                                     float& ry, float& rz) {
  const float uvx = qy * vz - qz * vy;
  const float uvy = qz * vx - qx * vz;
  const float uvz = qx * vy - qy * vx;
  const float ax = uvx + qw * vx;
  const float ay = uvy + qw * vy;
  const float az = uvz + qw * vz;
  const float uuvx = qy * az - qz * ay;
  const float uuvy = qz * ax - qx * az;
  const float uuvz = qx * ay - qy * ax;
  rx = vx + 2.0f * uuvx;
  ry = vy + 2.0f * uuvy;
  rz = vz + 2.0f * uuvz;
}

// torch.sign
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// 1.0 / clamp_min(|s|, 1e-20) * sign(s + (s == 0)) (raytrace_ref.py:59-63).
__device__ __forceinline__ float inv_scale(float s) {
  return (1.0f / fmaxf(fabsf(s), 1e-20f)) * sign_of(s + (s == 0.f ? 1.f : 0.f));
}

template <bool PREP>
__global__ void __launch_bounds__(kThreads) pack_rows_kernel(PackArgs p) {
  const int S = p.I * p.T;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)p.W * S) return;
  const int w = (int)(g / S);
  const int s = (int)(g % S);
  const int i = s / p.T;
  const int t = s % p.T;
  const int wi = w * p.I + i;
  const int o = p.inst_obj[wi];
  const int ot = o * p.T + t;

  const float* pos = p.inst_pos + 3 * wi;
  const float* q = p.inst_rot + 4 * wi;
  const float* sc = p.inst_scale + 3 * wi;
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];

  // World-space geometry (planar_soup_parts): rot(scale * v) (+ pos).
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
  const float* ov0 = p.v0 + 3 * ot;
  const float* oe1 = p.e1 + 3 * ot;
  const float* oe2 = p.e2 + 3 * ot;
  rot3(qw, qx, qy, qz, sc[0] * ov0[0], sc[1] * ov0[1], sc[2] * ov0[2], v0x,
       v0y, v0z);
  v0x = v0x + pos[0];
  v0y = v0y + pos[1];
  v0z = v0z + pos[2];
  rot3(qw, qx, qy, qz, sc[0] * oe1[0], sc[1] * oe1[1], sc[2] * oe1[2], e1x,
       e1y, e1z);
  rot3(qw, qx, qy, qz, sc[0] * oe2[0], sc[1] * oe2[1], sc[2] * oe2[2], e2x,
       e2y, e2z);
  const float val = p.tri_valid[ot] * p.inst_valid[wi];

  // Normals transform with the inverse scale: rot(n * inv).
  const float ix = inv_scale(sc[0]), iy = inv_scale(sc[1]),
              iz = inv_scale(sc[2]);
  float n[9];
  const float* onrm[3] = {p.n0 + 3 * ot, p.dn1 + 3 * ot, p.dn2 + 3 * ot};
  for (int k = 0; k < 3; ++k)
    rot3(qw, qx, qy, qz, onrm[k][0] * ix, onrm[k][1] * iy, onrm[k][2] * iz,
         n[3 * k], n[3 * k + 1], n[3 * k + 2]);

  // Texel density: sqrt(a_uv * tex_w * tex_h / max(a_world, 1e-30)), the
  // world-space area from the same cross order, (x² + y²) + z².
  const float cwx = e1y * e2z - e1z * e2y;
  const float cwy = e1z * e2x - e1x * e2z;
  const float cwz = e1x * e2y - e1y * e2x;
  const float a_world = sqrtf(cwx * cwx + cwy * cwy + cwz * cwz);
  const int mat = p.tri_mat[ot];
  const int tex = p.mat_tex[mat];
  const float* uv0 = p.uv0 + 2 * ot;
  const float* du1 = p.duv1 + 2 * ot;
  const float* du2 = p.duv2 + 2 * ot;
  const float a_uv = fabsf(du1[0] * du2[1] - du1[1] * du2[0]);
  const float tex_area =
      a_uv * (float)p.tex_width[tex] * (float)p.tex_height[tex];
  const float density = sqrtf(tex_area / fmaxf(a_world, 1e-30f));

  const float ve1x = e1x * val, ve1y = e1y * val, ve1z = e1z * val;
  const float ve2x = e2x * val, ve2y = e2y * val, ve2z = e2z * val;
  float geo[10];
  if (PREP) {
    // Camera-origin Möller–Trumbore prep constants (_pack_rows_planar).
    const float* cam = p.cam_pos + 3 * w;
    const float tvx = cam[0] - v0x;
    const float tvy = cam[1] - v0y;
    const float tvz = cam[2] - v0z;
    const float qvx = tvy * ve1z - tvz * ve1y;
    const float qvy = tvz * ve1x - tvx * ve1z;
    const float qvz = tvx * ve1y - tvy * ve1x;
    geo[0] = ve2y * ve1z - ve2z * ve1y;  // D
    geo[1] = ve2z * ve1x - ve2x * ve1z;
    geo[2] = ve2x * ve1y - ve2y * ve1x;
    geo[3] = ve2y * tvz - ve2z * tvy;  // A
    geo[4] = ve2z * tvx - ve2x * tvz;
    geo[5] = ve2x * tvy - ve2y * tvx;
    geo[6] = qvx;  // Q
    geo[7] = qvy;
    geo[8] = qvz;
    geo[9] = ve2x * qvx + ve2y * qvy + ve2z * qvz;  // t_num
  } else {
    // Raw rows (:260-266): v0 as it is, the edges times valid, and valid.
    geo[0] = v0x;
    geo[1] = v0y;
    geo[2] = v0z;
    geo[3] = ve1x;
    geo[4] = ve1y;
    geo[5] = ve1z;
    geo[6] = ve2x;
    geo[7] = ve2y;
    geo[8] = ve2z;
    geo[9] = val;
  }

  const float* col = p.mat_color + 4 * mat;
  const float rows[kRows] = {
      geo[0], geo[1], geo[2], geo[3], geo[4],
      geo[5], geo[6], geo[7], geo[8], geo[9],
      0.f, 0.f, 0.f, 0.f, 0.f, 0.f,
      uv0[0], uv0[1], du1[0], du1[1], du2[0], du2[1],
      n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8],
      (float)mat, col[0], col[1], col[2], density,
      0.f, 0.f, 0.f, 0.f};
  float* dst = p.out + (size_t)w * kRows * S + s;
#pragma unroll
  for (int r = 0; r < kRows; ++r) dst[(size_t)r * S] = rows[r];
}

}  // namespace

extern "C" {

// Launches K13 on `stream`, on the caller's current device: the prep layout
// when cam_pos is given, the raw layout when it is null. Returns
// cudaGetLastError() after the launch (0 on success).
int mrt_pack_rows(const float* inst_pos, const float* inst_rot,
                  const float* inst_scale, const float* inst_valid,
                  const int* inst_obj, const float* cam_pos, const float* v0,
                  const float* e1, const float* e2, const float* n0,
                  const float* dn1, const float* dn2, const float* uv0,
                  const float* duv1, const float* duv2, const int* tri_mat,
                  const float* tri_valid, const float* mat_color,
                  const int* mat_tex, const int* tex_width,
                  const int* tex_height, float* out, int W, int I, int T,
                  void* stream) {
  const PackArgs p{inst_pos, inst_rot, inst_scale, inst_valid, inst_obj,
                   cam_pos,  v0,       e1,         e2,         n0,
                   dn1,      dn2,      uv0,        duv1,       duv2,
                   tri_mat,  tri_valid, mat_color, mat_tex,    tex_width,
                   tex_height, out,    W,          I,          T};
  const long long n = (long long)W * I * T;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (cam_pos != nullptr)
    pack_rows_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    pack_rows_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
