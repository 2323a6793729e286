// K3 + K5: the streamed ordered walk, for meshes whose rows do not fit the
// resident budget (32 * S * 4 bytes > 384 KB, the JAX package's dma_tris,
// :4265-4266); the render kernel's helpers and variant dispatch come from
// csrc/render_resident.cu (included below), this route's body, entry points,
// launch plan and C interface are this translation unit's, which builds
// beside the others. Its K9 twins (render_streamed_seeded_*) are here too.
//
// Replaces madrona_renderer_tpu/ops/raytrace_pallas.py::_render_kernel in
// its ordered (K3, :1755-1785) deferred / dma_tris / prep-stream /
// band_gates sweep (K5, :1787-2680), launched at :4872, with the factory's
// other switches as csrc/render_resident.cu's header sets them out (GEO:
// prep, raw, raw_shadows, raw_wt, raw_wt_shadows; RASTER; TEX: none,
// nearest, bilinear, the mip hand-off and the 9-output mode) and K9's seed
// (seeded, :1064-1069, :1205-1209).
//
// What it computes, per (view, pixel): K1's ray, then the walk of the view's
// front-to-back cluster order (raytrace_cuda.camera_cluster_order) over
// each 16x16 tile: the walk stops at the first cluster that is invalid or
// that no pixel of the tile can reach (best_t^2 <= 0.998 * approach
// distance^2, :1740-1780), skips a cluster whose pixel-row span
// (raytrace_cuda.camera_cluster_rowspans at 16-row bands) misses the tile's
// rows or whose slab test (tmin * 0.999 < best_t, so a tie is never culled)
// no ray of the tile passes, and sweeps the rest's valid prefix from rows
// staged into shared memory. Exact-t ties go to the lower triangle index,
// so the frames are the index-order sweep's (raytrace_cuda.
// render_resident_plain), bit for bit.
//
// The design (prep, raw and K10 rows; the shadow sweeps' entries walk
// render_body's 16x16 blocks, below). A block is G groups of 256 threads (blockDim (16,
// 16 G), at most 4: 64 registers a thread); a group walks one 16x16 tile at
// a time, taking the tiles of the block's share of one view from a shared
// counter. The grid is num_views x B blocks, each view's B blocks next to
// each other, block b taking the view's tiles b, b + B, b + 2B, ... so that
// the costly rows (the horizon's) spread over the blocks
// (raytrace_cuda.streamed_plan: B = 1 where the views fill the blocks the
// card holds at once, else as many as fill them). Once a block, the threads
// write each position p of the view's order into shared memory, 10 words
// (kStreamWords): its early-exit threshold (d^2 * 0.998; +inf for an
// invalid cluster, which stops the walk just as the validity test did),
// its row span and c = order[p] with its valid-prefix count in one 16-byte
// record, and the AABB less the camera origin (lo - o, hi - o: the slab
// test's own differences, so its products keep their bits). A gate reads
// its terms at p: no load of the order first, no subtraction. The exit
// test's OR over the tile's pixels is the group's largest best_t^2 above
// the threshold, and that maximum holds until a sweep, so a position whose
// row gate fails (most of them) is decided with no barrier while it holds;
// otherwise each warp writes its largest best_t^2 and the OR of its slab
// predicates into its word of the group's vote row (two rows, used by
// turns), then one named barrier of the group (bar.sync, id 1 + group),
// and every thread reads the decision: exit first, then the row gate
// (uniform) and the slab test. Staging: each group has two buffers of
// [stage rows, cluster size], each with an mbarrier; the group's first
// thread issues a visited cluster's rows as one cp.async.bulk copy a row
// with the bytes expected, and the group waits on the buffer's phase
// (mbarrier.try_wait.parity), which replaces the 80 threads' 16-byte
// cp.async copies, their wait and a block barrier. The next candidate is
// chosen and issued before the current sweep and gated again after it
// (walk_clusters' rule, in stream_walk); a dropped candidate's copy is
// waited for on its phase before its buffer is issued again, and the gate
// that follows each sweep is the barrier that frees the swept buffer for
// its next copy. Raw rows: the view's tv, q, t_num (K10: a, b, c in place)
// formed in the buffer after the wait, then a group barrier. A triangle
// test on prep rows forms t first and skips u and v when t misses the
// window (on raw rows that made the sweep slower). The block
// holds the positions, the camera row and the groups' buffers: 40 * CC +
// 8 * G * rows * cs bytes and a 384-byte head, which fits 227 KB wherever
// the ordered walk's rule (raytrace_cuda.streamed_rule_bytes) sends a scene
// here, taking fewer groups where four do not fit.
//
// The shadow sweeps (raw_shadows, raw_wt_shadows: K8's any-hit sweep per
// light, every cluster in index order) walk render_body's STREAM branch,
// one 16x16 block a (view, tile) (render_streamed_tile_kernel): on them the
// tile groups were 1.4-5% slower.
//
// K11 on this walk (DMXU, stream_tile's second sweep: every slot of a
// visited cluster, D and t_num read as float4 over four slots, the
// cluster's first minimum merged with the lower-index tie rule, each warp's
// two rows gated on the span under rowskip; on raw rows the view's D, A, Q,
// t_num formed in place of the staged v0, e1, e2) builds in
// csrc/render_dmxu.cu, which includes this body without this source's
// entries (MRT_STREAMED_BODY_ONLY); render_body's 16x16 blocks in their
// DMXU mode stay there as its parent design.
//
// Bound on an H100: csrc/render_resident.cu's K5 bound (chip_smoke.py's
// k5_bound, from ops/walk_replay.streamed_walk's work for its inputs): per
// pixel K1's fixed work, per position a tile reaches the approach distance
// and the exit test, per gated position the slab test, per visited triangle
// 28 (prep), 37 (raw) or 44 (K10) FP32 operations; the bytes of the
// clusters streamed, the winners' rows, the order, spans, table and
// outputs. The walk's gates, order and slack are the ones
// ops/walk_replay.streamed_walk replays, so the bound counts this work.

#define MRT_RENDER_BODY_ONLY
#include "render_resident.cu"

namespace {

// Rows of a group's stage buffer: the geo's (smem_geo_rows: K5 on raw rows
// keeps the view's tv, q, t_num beside v0, e1, e2), or K11's D, A, Q and
// t_num (on raw rows formed in place of the staged v0, e1, e2).
template <int GEO, bool DMXU>
__host__ __device__ constexpr int stream_stage_rows() {
  return DMXU ? kPrepRows : smem_geo_rows<GEO>();
}

// One 16x16 tile, walked by one group (named barrier `bar`, its vote rows
// `vote`, its stage buffers `bufs` [2, rows, cs] and their mbarriers
// `bars`; `phases` each buffer's parity and `round` the vote rows' turn,
// carried from tile to tile): K1's ray, the staged walk of the view's
// positions (`s_head`, `s_box`), the resolve, the shading and the export,
// each expression as render_body computes it.
template <int GEO, bool RASTER, int TEX, bool SEEDED, bool DMXU = false>
__device__ __forceinline__ void stream_tile(const RenderArgs& a, const float* seed,
                                            const PosHead* s_head, const float* s_box,
                                            const float* s_cam, const float* g_rows,
                                            float* bufs, unsigned long long* bars, int view,
                                            int num_views, int tile, int bar,
                                            uint4 (*vote)[2], unsigned& phases,
                                            unsigned& round, int rowskip = 0) {
  constexpr bool RAW = GEO != kGeoPrep;
  constexpr bool WT = GEO >= kGeoRawWt;
  static_assert(GEO != kGeoRawShadows && GEO != kGeoRawWtShadows,
                "the shadow sweeps walk render_body's 16x16 blocks");
  static_assert(!DMXU || GEO == kGeoPrep || GEO == kGeoRaw, "K11 sweeps prep or raw rows");
  constexpr int kRows = stream_stage_rows<GEO, DMXU>();
  constexpr int kLoadRows = WT ? kWtRows : (RAW ? kRawRows : kPrepRows);
  const int S = a.S, CC = a.CC, cs = a.cluster_size;
  const int ly = threadIdx.y % kTileY;
  const int bx = tile % a.tiles_x, by = tile / a.tiles_x;
  const int px = bx * kTileX + threadIdx.x;
  const int py = by * kTileY + ly;

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
  const int lane_tid = ly * kTileX + threadIdx.x;  // 0-255 in the group
  const int warp = lane_tid >> 5;
  const bool lane0 = (lane_tid & 31) == 0;
  const bool leader = lane_tid == 0;
  const int row0 = by * kTileY;

  auto buf_of = [&](int b) { return bufs + b * kRows * cs; };
  auto wait = [&](int b) {
    stage_wait(bars + b, (phases >> b) & 1u);
    phases ^= 1u << b;
  };

  // The walk's gate at position p, the tile's: the exit first (no pixel's
  // best_t^2 above the position's threshold: stop), then the row gate (the
  // tile's rows outside the cluster's span: skip), then the slab test (no
  // ray of the tile passes: skip). The exit is an OR over the group's
  // threads, which is the group's largest best_t^2 (`reach`, a NaN taken as
  // 0, which reaches nothing either) above the threshold: `reach` holds
  // from one vote until a sweep may lower best_t, so a position whose row
  // gate fails is decided without a barrier while it holds. Otherwise one
  // barrier of the group: each warp writes its largest best_t^2 and, in bit
  // 31, the OR of its slab predicates into its word of this turn's row.
  float reach = 0.f;
  bool fresh = false;  // `reach` is the group's for the current best_t
  auto gate = [&](int p) {
    MRT_PHASE(1);
    const PosHead h = s_head[p];
    const bool rows_in = !(h.span_lo > row0 + kTileY - 1 || h.span_hi < row0);
    if (!rows_in && fresh) return reach > h.exit ? kSkip : kStop;
    bool possible = false;
    if (rows_in) {
      const float2 b0 = reinterpret_cast<const float2*>(s_box)[3 * p];
      const float2 b1 = reinterpret_cast<const float2*>(s_box)[3 * p + 1];
      const float2 b2 = reinterpret_cast<const float2*>(s_box)[3 * p + 2];
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
  auto stage = [&](int p, int b) {
    if (leader)
      stage_rows(buf_of(b), g_rows, S, cs, s_head[p].cluster & kClusterMask, kLoadRows,
                 bars + b);
  };
  auto visit = [&](int p, int b) {
    float* buf = buf_of(b);
    const int cw = s_head[p].cluster;
    const int base = (cw & kClusterMask) * cs;
    const int cnt = cw >> kCountShift;
    // The sweep may lower best_t: the gate that follows votes, and its
    // barrier frees this buffer for its next copy.
    fresh = false;
    MRT_PHASE(2);
    wait(b);
    if constexpr (WT) {
      // K10: the staged v0, e1, e2 turned in place into this view's
      // a = v0 - o, b = a + e1, c = a + e2 (:1393-1402).
      for (int k = lane_tid; k < cnt; k += kThreads) {
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
      group_sync(bar);
    } else if constexpr (RAW) {
      // This view's tv, q, t_num of each staged triangle (:1342-1348).
      float* h = buf + kRawRows * cs;
      for (int k = lane_tid; k < cnt; k += kThreads) {
        const float e1x = buf[3 * cs + k], e1y = buf[4 * cs + k], e1z = buf[5 * cs + k];
        const float e2x = buf[6 * cs + k], e2y = buf[7 * cs + k], e2z = buf[8 * cs + k];
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
      group_sync(bar);
    }
    MRT_PHASE(3);
    for (int k = 0; k < cnt; ++k) {
      // The lower index wins an exact tie, whatever the visit order.
      const int i = base + k;
      const float* g = buf + k;
      if constexpr (WT) {
        float t;
        if (woop_test(shear, g, cs, t) && g[9 * cs] > 0.f && t > t_lo &&
            ((t < best_t) || (t == best_t && i < best_idx))) {
          best_t = t;
          best_idx = i;
        }
      } else if constexpr (RAW) {
        float u, v, t;
        pvec_test(dx, dy, dz, g[3 * cs], g[4 * cs], g[5 * cs], g[6 * cs], g[7 * cs], g[8 * cs],
                  g + kRawRows * cs, cs, u, v, t);
        if ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps) && (t > t_lo) &&
            ((t < best_t) || (t == best_t && i < best_idx))) {
          best_t = t;
          best_idx = i;
          best_u = u;
          best_v = v;
        }
      } else {
        // prep_test's expressions, t first: a test whose t misses the
        // window (t > t_lo, below best_t or tying it at a lower index) skips
        // its u and v.
        const float det = dx * g[0] + dy * g[cs] + dz * g[2 * cs];
        const float inv = fabsf(det) > kEpsDet ? 1.0f / det : 0.0f;
        const float t = g[9 * cs] * inv;
        if (!(t > t_lo) || !((t < best_t) || (t == best_t && i < best_idx))) continue;
        const float u = (dx * g[3 * cs] + dy * g[4 * cs] + dz * g[5 * cs]) * inv;
        const float v = (dx * g[6 * cs] + dy * g[7 * cs] + dz * g[8 * cs]) * inv;
        if ((fminf(u, v) >= -kEpsBary) && (u + v <= kOnePlusEps)) {
          best_t = t;
          best_idx = i;
        }
      }
    }
  };
  if constexpr (DMXU) {
    // K11's sweep of a visited cluster (DMXU).
    auto visit_m = [&](int p, int b) {
      float* buf = buf_of(b);
      const int base = (s_head[p].cluster & kClusterMask) * cs;
      fresh = false;  // as visit's: the gate that follows votes
      MRT_PHASE(2);
      wait(b);
      if constexpr (RAW) {
        // K11 on raw rows: the cluster's D = e2 x e1, A = e2 x tv,
        // Q = tv x e1 and t_num = e2 . Q for this view (tv = o - v0,
        // :1876-1903) in place of its staged v0, e1, e2, one thread a slot;
        // the group barrier after it, and the one of the gate that follows
        // the sweep, keep the next copy out of the buffer until every warp
        // is done with it.
        for (int k = lane_tid; k < cs; k += kThreads) {
          const float e1x = buf[3 * cs + k], e1y = buf[4 * cs + k], e1z = buf[5 * cs + k];
          const float e2x = buf[6 * cs + k], e2y = buf[7 * cs + k], e2z = buf[8 * cs + k];
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
        group_sync(bar);
      }
      MRT_PHASE(3);
      // Row skip (:1915-1990): the cluster's rows miss the warp's two.
      const int wrow0 = row0 + 2 * (ly / 2);
      const PosHead h = s_head[p];
      if (rowskip && (h.span_lo > wrow0 + 1 || h.span_hi < wrow0)) return;
      // Every slot, padding included; t < cmin from cmin = far: the
      // accepted t < far of the cluster's first minimum, as the JAX
      // iota-min takes it; D and t_num read as float4 over four slots, the
      // four tests in slot order.
      float cmin = far, cu = 0.f, cv = 0.f;
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
          if constexpr (RAW) {
            cu = u;
            cv = v;
          }
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
      // The first minimum merged with the lower-index tie rule.
      const int gi = base + lidx;
      if (lidx >= 0 && ((cmin < best_t) || (cmin == best_t && gi < best_idx))) {
        best_t = cmin;
        best_idx = gi;
        if constexpr (RAW) {
          best_u = cu;
          best_v = cv;
        }
      }
    };
    stream_walk(CC, gate, stage, wait, visit_m);
  } else {
    stream_walk(CC, gate, stage, wait, visit);
  }
  MRT_PHASE(4);

  const bool inside = px < a.width && py < a.height;
  if (!inside) return;

  // Winner resolve (:2725-2793), as render_body's: the rows in device
  // memory.
  const float* g0 = g_rows;  // prep: D; raw: v0
  const float* g1 = g_rows + S;
  const float* g2 = g_rows + 2 * S;
  const float* g3 = g_rows + 3 * S;  // prep: A; raw: e1
  const float* g4 = g_rows + 4 * S;
  const float* g5 = g_rows + 5 * S;
  const float* g6 = g_rows + 6 * S;  // prep: Q; raw: e2
  const float* g7 = g_rows + 7 * S;
  const float* g8 = g_rows + 8 * S;
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

// A block: view blockIdx.x / parts, its share `part` of the view's tiles
// (part, part + parts, part + 2 parts, ...: each block's tiles spread over
// the image and its costly rows), blockDim.y / 16 tile groups. The fill,
// once a block: the camera row and the positions' words (threads), each
// group's two mbarriers (thread 0); then each group takes tiles from the
// counter until the share is gone.
template <int GEO, bool RASTER, int TEX, bool SEEDED, bool DMXU = false>
__device__ __forceinline__ void stream_body(const RenderArgs& a, const StreamArgs& st,
                                            int parts, const float* seed, int rowskip = 0) {
  constexpr int kRows = stream_stage_rows<GEO, DMXU>();
  const int CC = a.CC, cs = a.cluster_size;
  const int groups = blockDim.y / kTileY;
  const int n_block = kThreads * groups;
  extern __shared__ __align__(16) float smem[];
  MRT_PHASE_BEGIN;
  StreamCtl& ctl = *reinterpret_cast<StreamCtl*>(smem);
  float* s_stage = smem + kStreamCtlBytes / sizeof(float);  // [groups, 2, rows, cs]
  PosHead* s_head = reinterpret_cast<PosHead*>(s_stage + (size_t)groups * 2 * kRows * cs);
  float* s_box = reinterpret_cast<float*>(s_head + CC);     // [CC, 6]
  float* s_cam = s_box + (size_t)6 * CC;                    // [NCOL]

  const int view = blockIdx.x / parts;
  const int part = blockIdx.x - view * parts;
  const int world = view / a.num_cams;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float* g_rows = a.rows + (size_t)world * kPackRows * a.S;
  const float* g_cl = a.clusters + (size_t)world * kClRows * CC;
  const float* g_cam = a.cams + (size_t)view * a.n_cols;
  const int n_tiles = a.tiles_x * ((a.height + kTileY - 1) / kTileY);
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
  {
    // Position p's words: cluster c = order[p]'s early-exit threshold
    // (approach_dist2, :1740-1780, times the slack; +inf when it is
    // invalid), its row span, c | count << kCountShift, and its lo - o,
    // hi - o (in the order lo.x lo.y lo.z hi.x hi.y hi.z as three pairs
    // (lo.x, lo.y), (lo.z, hi.x), (hi.y, hi.z)).
    const float ox = g_cam[0], oy = g_cam[1], oz = g_cam[2];
    const int* g_order = st.order + (size_t)view * CC;
    const int* g_span = st.spans + (size_t)view * 2 * CC;
    for (int p = tid; p < CC; p += n_block) {
      const int c = g_order[p];
      const float lx = g_cl[0 * CC + c] - ox, ly = g_cl[1 * CC + c] - oy,
                  lz = g_cl[2 * CC + c] - oz;
      const float hx = g_cl[3 * CC + c] - ox, hy = g_cl[4 * CC + c] - oy,
                  hz = g_cl[5 * CC + c] - oz;
      float2* box = reinterpret_cast<float2*>(s_box) + 3 * p;
      box[0] = make_float2(lx, ly);
      box[1] = make_float2(lz, hx);
      box[2] = make_float2(hy, hz);
      const float ax = fmaxf(fmaxf(lx, ox - g_cl[3 * CC + c]), 0.0f);
      const float ay = fmaxf(fmaxf(ly, oy - g_cl[4 * CC + c]), 0.0f);
      const float az = fmaxf(fmaxf(lz, oz - g_cl[5 * CC + c]), 0.0f);
      PosHead h;
      h.exit = g_cl[6 * CC + c] > 0.f ? (ax * ax + ay * ay + az * az) * kExitSlack : INFINITY;
      h.span_lo = g_span[c];
      h.span_hi = g_span[CC + c];
      h.cluster = c | ((int)g_cl[7 * CC + c] << kCountShift);
      s_head[p] = h;
    }
  }
  __syncthreads();
  MRT_AFTER_FILL;

  const int g = threadIdx.y / kTileY;
  float* bufs = s_stage + (size_t)g * 2 * kRows * cs;
  unsigned phases = 0, round = 0;
  for (int it = 0;; ++it) {
    MRT_PHASE(5);
    int* slot = &ctl.tile[g][it & 1];
    if ((tid & (kThreads - 1)) == 0) *slot = part + atomicAdd(&ctl.next_tile, 1) * parts;
    group_sync(1 + g);
    const int tile = *slot;
    if (tile >= n_tiles) break;
    MRT_PHASE(4);
    stream_tile<GEO, RASTER, TEX, SEEDED, DMXU>(a, seed, s_head, s_box, s_cam, g_rows, bufs,
                                                ctl.stage_bar[g], view, gridDim.x / parts,
                                                tile, 1 + g, ctl.vote[g], phases, round,
                                                rowskip);
  }
}

// This source's entries; csrc/render_dmxu.cu includes the body above
// without them (MRT_STREAMED_BODY_ONLY) for K11's tile groups.
#ifndef MRT_STREAMED_BODY_ONLY
template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads * kStreamGroups, 1)
render_streamed_kernel(const RenderArgs a, const StreamArgs s, const int parts) {
  stream_body<GEO, RASTER, TEX, false>(a, s, parts, nullptr);
}

// K9's entries of this route: the raytrace variants, seeded.
template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads * kStreamGroups, 1)
render_streamed_seeded_kernel(const RenderArgs a, const StreamArgs s, const int parts,
                              const float* __restrict__ seed) {
  stream_body<GEO, false, TEX, true>(a, s, parts, seed);
}

// The shadow sweeps' entries (raw_shadows, raw_wt_shadows) walk
// render_body's STREAM branch: one 16x16 block a (view, tile) with its own
// fill, cp.async staging and block barriers, which ran 1.4-5% faster than
// the tile groups on 64 worlds of bench.py's big mesh.
template <int GEO, bool RASTER, int TEX>
__global__ void __launch_bounds__(kThreads)
render_streamed_tile_kernel(const RenderArgs a, const StreamArgs s) {
  render_body<GEO, RASTER, TEX, true>(a, s);
}

template <int GEO, int TEX>
__global__ void __launch_bounds__(kThreads)
render_streamed_tile_seeded_kernel(const RenderArgs a, const StreamArgs s,
                                   const float* __restrict__ seed) {
  render_body<GEO, false, TEX, true, false, false, true>(a, s, BinArgs{}, seed);
}
#endif  // MRT_STREAMED_BODY_ONLY

// Shared memory of a block of `groups` tile groups: the head, the groups'
// stage buffers (K11's with DMXU), the positions' words and the camera row.
template <int GEO, bool DMXU = false>
size_t stream_smem(const RenderArgs& a, int groups) {
  return kStreamCtlBytes +
         sizeof(float) * ((size_t)groups * 2 * stream_stage_rows<GEO, DMXU>() * a.cluster_size +
                          (size_t)kStreamWords * a.CC + a.n_cols);
}

#ifndef MRT_STREAMED_BODY_ONLY

// A launch's visit inputs, K9's seed (null: the cold entries), its plan
// (tile groups a block, blocks a view; groups 0 for the shadow sweeps'
// 16x16 blocks) and, for an occupancy query instead of a launch, where its
// four numbers go.
struct StreamLaunch {
  StreamArgs s;
  const float* seed;
  int groups, parts;
  int* query;
};

// The route's launch of one variant (or its occupancy query).
struct StreamedRoute {
  static constexpr bool kNine = true;
  template <int GEO, bool RASTER, int TEX>
  static int run(const RenderArgs& a, const StreamLaunch& x, int num_views,
                 cudaStream_t stream) {
    constexpr bool SHADOWS = GEO == kGeoRawShadows || GEO == kGeoRawWtShadows;
    if constexpr (SHADOWS) {
      // render_body's 16x16 blocks on the (views, tiles) grid.
      if (x.groups != 0) return (int)cudaErrorInvalidValue;
      const size_t smem = streamed_smem<GEO>(a);
      if (x.seed == nullptr) {
        auto kernel = render_streamed_tile_kernel<GEO, RASTER, TEX>;
        return x.query == nullptr ? launch_grid(kernel, a, num_views, smem, stream, a, x.s)
                                  : stream_launch(kernel, x, num_views, smem, stream, a, x.s);
      }
      if constexpr (RASTER) {
        return (int)cudaErrorInvalidValue;  // K9 raytraces only
      } else {
        auto kernel = render_streamed_tile_seeded_kernel<GEO, TEX>;
        return x.query == nullptr
                   ? launch_grid(kernel, a, num_views, smem, stream, a, x.s, x.seed)
                   : stream_launch(kernel, x, num_views, smem, stream, a, x.s, x.seed);
      }
    } else {
      if (x.groups < 1 || x.groups > kStreamGroups || x.parts < 1)
        return (int)cudaErrorInvalidValue;
      const size_t smem = stream_smem<GEO>(a, x.groups);
      if (x.seed == nullptr)
        return stream_launch(render_streamed_kernel<GEO, RASTER, TEX>, x, num_views, smem,
                             stream, a, x.s, x.parts);
      if constexpr (RASTER) {
        return (int)cudaErrorInvalidValue;  // K9 raytraces only
      } else {
        return stream_launch(render_streamed_seeded_kernel<GEO, TEX>, x, num_views, smem,
                             stream, a, x.s, x.parts, x.seed);
      }
    }
  }
};
#endif  // MRT_STREAMED_BODY_ONLY

}  // namespace

#ifndef MRT_STREAMED_BODY_ONLY
extern "C" {

// Launches the streamed ordered variant (geo, raster, tex_filter) on
// `stream`, on the caller's current device, seeded by `seed`
// ([num_views, height, width] f32, K9; raytrace variants only) unless it is
// null, with mrt_render_resident's arguments and the visit's: order
// [num_views, CC] and spans [num_views, 2, CC]; the plan: `groups` tile
// groups a block (1-4; 0 for geo 2 and 4, whose walk takes one 16x16 block
// a tile) and `parts` blocks a view. tex_filter 4 is the 9-output mode (geo 0, 1 or 3). The
// stage copies move whole rows of a cluster: rows must be 16-byte aligned
// and S and cluster_size multiples of 4; CC below 65,536. Returns
// cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unknown variant, a missing input or a bad
// plan, or cudaErrorMisalignedAddress.
int mrt_render_streamed(const float* rows, const float* clusters, const float* cams,
                        const float* mats, const int* pool, int n_mats, float* depth,
                        int* segmask, uint32_t* rgb, int* code, float* handoff,
                        const int* order, const int* spans, const float* seed, int num_views,
                        int num_cams, int S, int CC, int cluster_size, int n_cols,
                        int n_lights, int height, int width, int seg_div, float two_over_w,
                        float two_over_h, int raster, int tex_filter, int geo, int groups,
                        int parts, void* stream) {
  const RenderArgs a = render_args(rows, clusters, cams, mats, pool, n_mats, depth,
                                   segmask, rgb, code, handoff, num_cams, S, CC,
                                   cluster_size, n_cols, n_lights, height, width,
                                   seg_div, two_over_w, two_over_h, tex_filter);
  if (order == nullptr || spans == nullptr || CC > kClusterMask ||
      cluster_size >= (1 << (31 - kCountShift)))
    return (int)cudaErrorInvalidValue;
  if (cluster_size % 4 != 0 || S % 4 != 0 || ((uintptr_t)rows & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const StreamLaunch x{StreamArgs{order, spans}, seed, groups, parts, nullptr};
  return launch_variant<StreamedRoute>(a, x, num_views, geo, raster, tex_filter,
                                       (cudaStream_t)stream);
}

// The variant's (geo, raster, tex_filter, seeded) threads a block,
// registers, local memory bytes a thread and blocks a multiprocessor with
// `groups` tile groups (0: the shadow sweeps' 16x16 blocks) at CC clusters
// of cluster_size, n_cols camera columns and n_lights lights, in out[0..3].
// Returns 0, or the CUDA error of the query.
int mrt_render_streamed_occupancy(int geo, int raster, int tex_filter, int seeded, int groups,
                                  int CC, int cluster_size, int n_cols, int n_lights,
                                  int* out) {
  RenderArgs a{};
  a.CC = CC;
  a.cluster_size = cluster_size;
  a.n_cols = n_cols;
  a.n_lights = n_lights;
  static const float kSeeded = 0.f;  // any non-null seed picks the seeded entry
  const StreamLaunch x{{}, seeded ? &kSeeded : nullptr, groups, 1, out};
  return launch_variant<StreamedRoute>(a, x, 0, geo, raster, tex_filter, nullptr);
}

const char* mrt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
#endif  // MRT_STREAMED_BODY_ONLY
