"""GPU smoke run of the PyTorch/CUDA port (madrona_renderer_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc). Phases, each
printed as JSON lines:

  1. env     — Python/torch/CUDA versions, the card's name and power limit;
  2. build   — every kernel under madrona_renderer_tpu_torch/csrc, one nvcc
               per source, all started together;
  3. kernel_vs_plain — each kernel against its plain PyTorch version on the
               same CUDA inputs at 64 worlds: the fused pack K13 in both
               layouts (``pack_rows`` prep, ``pack_rows_raw``, bitwise) and
               every variant of the render kernel (prep / raw / raw with
               shadows x raytrace / raster x untextured / nearest /
               bilinear) on the demo scene with one and with four cameras
               per world (untextured and textured), random scenes (one with
               1-3 cameras per world, per-camera fov and znear), the demo
               scene at 40x24 with two lights, and the occluder scene of
               tests/test_shadows.py with one and with two lights, each
               without and with shadows;
  4. paths   — the five paths of the port, each through MadronaRenderer and
               stepped with a position mutation through the exported tensor
               between steps, with every launch count set to 0 just before
               and read just after:
                 main             demo_config, 4096 worlds x 64x64,
                                  raytraced;
                 textured_4096w   the same with the 32x32 PNG checkerboard,
                                  nearest filtering;
                 raster_256w_png  256 worlds x 64x64 of the textured cube,
                                  RenderMode.Rasterizer;
                 multicam_1024w4c 1024 worlds x 4 cameras x 64x64 (4096
                                  views), raytraced on the raw rows;
                 shadows_4096w    main with shadows=True (raw rows and one
                                  shadow ray per pixel and light);
               then, on each path's last inputs at full size, the kernels
               against the exported frames and their plain versions (and
               for shadows_4096w the unshadowed render of the same rows:
               rgb darker somewhere, depth and segmask bitwise); one line
               per path (phase = its name) with the step and prologue times
               on the host clock and the prologue's operator count;
  5. timing  — each kernel at its path's full-size inputs: its device time
               in a CUDA graph of back-to-back launches, its time through
               the wrapper (host overhead included), its plain version's
               time, its bound; then, in lines with an ``inputs`` key that
               the kernels line leaves out, K13's raw layout on
               multicam_1024w4c's 1024 worlds and the raw sweep on main's
               one-camera rows (beside a ``prep_vs_raw`` line of phase 4
               that compares its frames with the prep sweep's);

then the nvidia-smi line, the ``kernels`` summary line and the result line
``{"ok": true, "device": {...}}``. Any failed check raises: the script then
exits non-zero and prints no result. Without a card it exits non-zero at
once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NUM_WORLDS = 4096
RASTER_WORLDS = 256
MULTICAM_WORLDS = 1024
MULTICAM_CAMS = 4
HEIGHT = WIDTH = 64
TEX_SIZE = 32
WARMUP_STEPS = 3
TIMED_STEPS = 20
RASTER_TIMED_STEPS = 60
KERNEL_REPS = 50
SMALL_WORLDS = 64

# H100 SXM peaks (NVIDIA data sheet). The published 67 TFLOP/s of FP32
# outside the tensor cores counts a fused multiply-add as two operations
# (132 SMs x 128 lanes x 2 x 1.98 GHz). The kernels are built with
# --fmad=false, so each operation counted below issues as an instruction of
# its own: their peak is half of that.
PEAK_FP32_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12

# The render kernel's FP32 operations, counted from
# csrc/render_resident.cu (add, sub, mul, div, sqrt, floor, min, max,
# compare and float<->int conversion count one each, though an IEEE divide
# or square root takes several instructions, so the bound is a floor): per
# thread, ray generation 30 + direction inverses 9 + winner resolve 36
# (raw: 16, the carried u, v are only clipped) + flip 9 + shading 29 + 14
# per light; per thread and cluster, the slab test 25; per triangle test
# 27 on prep rows, 36 on raw rows (the pvec 9, det 5, 1/det 3, u 6, v 6,
# t 1, acceptance 6), whose tv, q and t_num (17) a block computes once per
# triangle. Shadows add per thread the hit point and the bias (8), per
# light the occlusion select (4), per light and cluster the slab test (24),
# and per shadow triangle test 52; of these the light's direction and its
# inverses (12 per light) and the shadow test's pvec, det and 1/det (17 per
# light and triangle) are the same for every thread, so the work needs the
# first once per view and the second once per visiting block: the bound
# charges them so, and each thread 35 per shadow triangle test.
# The raster variant adds the cosine, its floor, the t-space near bound, z
# and the far clip (9); the textured variants add the uv resolve (8), the
# material lookup (4), the wrap (4) and the sample: nearest 11 (two
# products, two conversions, three dequant divides, three colour products,
# 1 - v), bilinear 62 (the texel-centre offsets, floors, weights and
# conversions 14, twelve dequant divides, three lerps of 12, three colour
# products).
K1_OPS_FIXED = {"prep": 113, "raw": 113 - 20}
K1_OPS_PER_LIGHT = 14
K1_OPS_PER_CLUSTER = 25
K1_OPS_PER_TRIANGLE = {"prep": 27, "raw": 36}
K1_OPS_RAW_HOIST = 17
K1_OPS_RASTER = 9
K1_OPS_TEX = {None: 0, "nearest": 8 + 4 + 4 + 11, "bilinear": 8 + 4 + 4 + 62}
K8_OPS_FIXED = 8
K8_OPS_PER_LIGHT = 4
K8_OPS_PER_CLUSTER = 24
K8_OPS_PER_TRIANGLE = 52 - 17
K8_OPS_PER_VIEW_LIGHT = 12
K8_OPS_PER_BLOCK_TRIANGLE = 17
K1_THREADS_PER_BLOCK = 256
# Rows of the pack each block reads (the geometry rows) and each hit reads
# once (the normal rows, and the colour rows (untextured) or the material
# and uv rows (textured)).
K1_GEO_ROWS = {"prep": 10, "raw": 9}
K1_ATTR_ROWS = {None: 9 + 3, "nearest": 9 + 7, "bilinear": 9 + 7}
# K13's FP32 operations per (world, triangle slot), counted from
# csrc/pack_rows.cu: six quaternion rotations of 30, the scaled vertex and
# edge products and the translation 12, the validity product 1, three
# inverse scales of 8 and the normal products 9, the texel density 26, the
# material id conversion 1, and the prep products 41 (prep layout) or the
# six edge-validity products (raw layout).
K13_OPS_PER_SLOT = {"pack_rows": 6 * 30 + 12 + 1 + 24 + 9 + 26 + 1 + 41,
                    "pack_rows_raw": 6 * 30 + 12 + 1 + 24 + 9 + 26 + 1 + 6}
# Floats K13 reads once: per instance pos, quat, scale, valid, object id;
# per world the camera origin (prep layout); per object triangle v0, e1,
# e2, n0, dn1, dn2, uv0, duv1, duv2, material, valid; per material colour
# and texture id; per texture width and height.
K13_FLOATS_PER_INSTANCE = 3 + 4 + 3 + 1 + 1
K13_FLOATS_PER_TRIANGLE = 6 * 3 + 3 * 2 + 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events (after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn`` launch: ``reps`` calls captured in one
    CUDA graph and replayed, so no host time sits between the launches (for
    kernels shorter than their wrapper's host overhead)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up outside the capture (first-use build and load)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize —
    what a caller waits for (for host-bound work, where device events would
    only time the gaps the host leaves)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def count_torch_ops(fn) -> int:
    """Number of torch operators ``fn`` dispatches, views excluded (each of
    the others is a kernel launch or a host-side op)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = {"view", "_unsafe_view", "unbind", "select", "slice", "expand",
             "unsqueeze", "alias", "t", "reshape", "as_strided"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in views:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def random_scene(seed: int, n_worlds: int, cfg_mod, texture=None, max_cams: int = 1):
    """Random triangles, 1-4 instances and one camera per world (with
    ``max_cams`` > 1: 1 to ``max_cams`` cameras per world with their own fov
    and znear); with a ``texture`` path, random uvs (beyond [0, 1], so the
    repeat wrap works) and the first mesh's material textured."""
    rng = np.random.default_rng(seed)
    meshes = [(rng.normal(size=(int(rng.integers(1, 7)) * 3, 3)) * 5).astype(np.float32)
              for _ in range(int(rng.integers(1, 4)))]
    verts = np.concatenate(meshes)
    counts = [len(m) for m in meshes]
    offs = np.cumsum([0] + counts[:-1]).astype(np.uint32)
    uvs = np.zeros((len(verts), 2), np.float32)
    mesh_mats = np.full(len(meshes), -1, np.int32)
    mats, textures = [], []
    if texture is not None:
        uvs = rng.uniform(-1.5, 2.5, size=(len(verts), 2)).astype(np.float32)
        mesh_mats[0] = 0
        mats = [cfg_mod.AdditionalMaterial(color=(0.9, 0.8, 0.7, 1.0), texture_id=0)]
        textures = [texture]
    geo = cfg_mod.GeometryConfig(
        vertices=verts, uvs=uvs,
        indices=np.concatenate([np.arange(c, dtype=np.uint32) for c in counts]),
        mesh_vertex_offsets=offs, mesh_index_offsets=offs.copy(),
        mesh_materials=mesh_mats,
    )

    def unit(v):
        return (v / np.linalg.norm(v)).tolist()

    n_inst = int(rng.integers(1, 5))
    instances, cameras, worlds = [], [], []
    for w in range(n_worlds):
        for _ in range(n_inst):
            instances.append(cfg_mod.ImportedInstance(
                position=rng.normal(size=3).tolist(), rotation=unit(rng.normal(size=4)),
                scale=rng.uniform(0.5, 2.0, size=3).tolist(),
                object_id=int(rng.integers(0, len(meshes)))))
        n_cams = 1 if max_cams == 1 else int(rng.integers(1, max_cams + 1))
        for _ in range(n_cams):
            extra = {} if max_cams == 1 else dict(
                fov_y_degrees=float(rng.choice([0.0, 60.0, 110.0])),
                znear=float(rng.choice([0.0, 0.5, 3.0])))
            cameras.append(cfg_mod.ImportedCamera(
                position=(rng.normal(size=3) * 3 + [0, -12, 0]).tolist(),
                rotation=unit(rng.normal(size=4) * 0.2 + [1, 0, 0, 0]), **extra))
        worlds.append(cfg_mod.WorldInit(n_inst, n_inst * w, n_cams, len(cameras) - n_cams))
    return geo, mats, textures, instances, cameras, worlds


def occluder_scene(n_worlds: int, cfg_mod):
    """tests/test_shadows.py's scene per world: a ground quad at y=10 and a
    small occluder quad at y=5, shifted along x from world to world, seen by
    a camera at the origin looking +y."""
    def quad(half):
        a, b, c, d = [-half, 0, -half], [half, 0, -half], [half, 0, half], [-half, 0, half]
        return np.asarray([a, b, c, a, c, d], np.float32)

    verts = np.concatenate([quad(50.0), quad(2.0)])
    offs = np.asarray([0, 6], np.uint32)
    geo = cfg_mod.GeometryConfig(
        vertices=verts, uvs=np.zeros((12, 2), np.float32),
        indices=np.tile(np.arange(6, dtype=np.uint32), 2), mesh_vertex_offsets=offs,
        mesh_index_offsets=offs.copy(), mesh_materials=np.full(2, -1, np.int32))
    ident = [1.0, 0.0, 0.0, 0.0]
    instances, cameras, worlds = [], [], []
    for w in range(n_worlds):
        instances += [cfg_mod.ImportedInstance([0, 10, 0], ident, object_id=0),
                      cfg_mod.ImportedInstance([0.05 * w - 1.6, 5, 0], ident, object_id=1)]
        cameras.append(cfg_mod.ImportedCamera([0, 0, 0], ident))
        worlds.append(cfg_mod.WorldInit(2, 2 * w, 1, w))
    return geo, [], [], instances, cameras, worlds


def demo_scene(n_worlds: int, dynamic: bool, scenes, cfg_mod, textured=False, num_cams=1):
    r = scenes.demo_config(n_worlds, cfg_mod.RenderMode.Raytracer, WIDTH, HEIGHT,
                           dynamic=dynamic, textured=textured, tex_size=TEX_SIZE,
                           num_cams=num_cams).rcfg
    return (r.geo_cfg, r.additional_mats, r.additional_textures, r.instances,
            r.cameras, r.worlds)


def compare_outputs(k, p) -> dict:
    """Kernel outputs vs plain outputs: rgb bytes, depth, segmask."""
    (kd, ks, kc), (pd, ps, pc) = k, p
    rgb_lsb = int((kc.view(torch.uint8).int() - pc.view(torch.uint8).int()).abs().max())
    depth_abs = float((kd - pd).abs().max())
    depth_bad = int((~torch.isclose(kd, pd, rtol=1e-5, atol=0.0)).sum())
    seg_mismatch = int((ks != ps).sum())
    return dict(rgb_max_lsb=rgb_lsb, depth_max_abs=depth_abs,
                depth_outside_rtol=depth_bad, seg_mismatches=seg_mismatch,
                pixels=int(ks.numel()), bitwise=bool(
                    torch.equal(kd, pd) and torch.equal(ks, ps) and torch.equal(kc, pc)))


def check_close(tag: str, c: dict) -> None:
    """The bar: rgb within 1 LSB, depth within rtol 1e-5, segmask exact."""
    if c["rgb_max_lsb"] > 1 or c["depth_outside_rtol"] or c["seg_mismatches"]:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version: {c}")


def output_err(k, p) -> float:
    return max(float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()),
               float((k[2].view(torch.uint8).int() - p[2].view(torch.uint8).int())
                     .abs().max()))


def k1_triangle_tests(kw: dict) -> tuple:
    """Triangle tests the render kernel makes on these inputs, per thread of
    a block and summed over blocks: its block culls replayed in torch ops.
    Cluster by cluster, a 16x16 block visits the cluster's valid prefix when
    the cluster is valid and any of its rays passes the slab test against
    the ray's best t so far; the rays of a visiting block then take the
    prefix's hits (above the raster variant's per-pixel near bound). With
    shadows, per light, a block visits a cluster's prefix when any of its
    shadow rays that is not yet occluded passes the slab test (tmax > 0),
    and those rays take the prefix's occlusion. Returns (primary tests,
    shadow tests)."""
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc

    H, Wd = kw["height"], kw["width"]
    if H % 16 or Wd % 16:
        raise ValueError("the replay covers images in whole 16x16 blocks")
    rows, cams, nc = kw["rows"], kw["cams"], kw["num_cams"]
    raw = kw["geo"] != "prep"
    world = torch.arange(cams.shape[0], device=cams.device) // nc
    rows_v, cl = rows[world], kw["clusters"][world]
    CC = cl.shape[2]
    size = rows.shape[2] // CC
    dirs = rc.plain_rays(cams, H, Wd)
    tiny = float(np.float32(1e-20))

    def inverse(d):
        return 1.0 / torch.where(d.abs() > tiny, d, torch.where(d < 0, -tiny, tiny))

    def slab(c, origin, inv):
        t1 = [(cl[:, k, c:c + 1] - origin[k]) * inv[k] for k in range(3)]
        t2 = [(cl[:, 3 + k, c:c + 1] - origin[k]) * inv[k] for k in range(3)]
        lo = [torch.minimum(a, b) for a, b in zip(t1, t2)]
        hi = [torch.maximum(a, b) for a, b in zip(t1, t2)]
        return (torch.maximum(torch.maximum(lo[0], lo[1]), lo[2]),
                torch.minimum(torch.minimum(hi[0], hi[1]), hi[2]))

    def blocks(possible, c):
        """Blocks that visit cluster c, and each ray's block flag."""
        block = possible.reshape(-1, H // 16, 16, Wd // 16, 16).any(4).any(2)
        block = block & (cl[:, 6, c] > 0)[:, None, None]
        ray_in = block[:, :, None, :, None].expand(-1, -1, 16, -1, 16).reshape(
            possible.shape)
        return block, ray_in

    inv = [inverse(d) for d in dirs]
    near = cams[:, 14:15]
    t_lo = near
    if kw["raster"]:
        cosf = dirs[0] * cams[:, 6:7] + dirs[1] * cams[:, 7:8] + dirs[2] * cams[:, 8:9]
        t_lo = near / torch.clamp_min(cosf, float(np.float32(1e-6)))
    origin = tuple(cams[:, k:k + 1] for k in range(3))
    far = cams[:, 15:16]
    best_t = far.expand_as(dirs[0]).clone()
    tests = 0
    for c in range(CC):
        tmin, tmax = slab(c, origin, inv)
        block, ray_in = blocks((tmax >= tmin) & (tmax > near) & (tmin < best_t), c)
        cnt = cl[:, 7, c].long()
        tests += int((block.sum((1, 2)) * cnt).sum())
        for j in range(size):
            i = c * size + j
            ok, t, _, _ = rc.plain_triangle_test(
                *dirs, rows_v[:, :10, i:i + 1], t_lo, best_t, origin if raw else None)
            best_t = torch.where(ok & ray_in & (j < cnt)[:, None], t, best_t)
    shadow_tests = 0
    if kw["geo"] == "raw_shadows":
        t_hit = torch.where(best_t < far, best_t, 0.0)
        hit = tuple(origin[k] + t_hit * dirs[k] for k in range(3))
        eps = float(np.float32(1e-3)) * (1.0 + t_hit)
        for li in range(kw["n_lights"]):
            c0 = 17 + 6 * li
            sd = tuple(-cams[:, c0 + k:c0 + k + 1] for k in range(3))
            inv_s = [inverse(d) for d in sd]
            occ = torch.zeros_like(best_t, dtype=torch.bool)
            for c in range(CC):
                tmin, tmax = slab(c, hit, inv_s)
                block, ray_in = blocks((tmax >= tmin) & (tmax > 0) & ~occ, c)
                cnt = cl[:, 7, c].long()
                shadow_tests += int((block.sum((1, 2)) * cnt).sum())
                for j in range(size):
                    i = c * size + j
                    ok, _, _, _ = rc.plain_triangle_test(
                        *sd, rows_v[:, :10, i:i + 1], eps, origin=hit)
                    occ = occ | (ok & ray_in & (j < cnt)[:, None])
    return tests, shadow_tests


def k1_bound(kw: dict, visits: int, shadow_visits: int) -> tuple:
    """Least time for the render kernel's work on these inputs: bytes over
    HBM rate vs FP32 operations over peak, the larger of the two
    (ms, 'bytes'|'operations', bytes, operations)."""
    W, _, S = kw["rows"].shape
    CC = kw["clusters"].shape[2]
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    tiles = math.ceil(kw["height"] / 16) * math.ceil(kw["width"] / 16)
    blocks = views * tiles
    threads = blocks * K1_THREADS_PER_BLOCK
    tex, lights = kw["texture"], kw["n_lights"]
    geo = "prep" if kw["geo"] == "prep" else "raw"  # the rows' layout
    nbytes = (W * (K1_GEO_ROWS[geo] + K1_ATTR_ROWS[tex]) * S * 4
              + kw["clusters"].numel() * 4 + kw["cams"].numel() * 4 + pixels * 12)
    if tex is not None:
        nbytes += kw["mats"].numel() * 4 + kw["pool"].numel() * 4
    per_thread = (K1_OPS_FIXED[geo] + K1_OPS_PER_LIGHT * lights
                  + K1_OPS_PER_CLUSTER * CC + K1_OPS_TEX[tex]
                  + (K1_OPS_RASTER if kw["raster"] else 0))
    if kw["geo"] == "raw_shadows":
        per_thread += (K8_OPS_FIXED + K8_OPS_PER_LIGHT * lights
                       + K8_OPS_PER_CLUSTER * CC * lights)
    ops = (threads * per_thread
           + visits * K1_THREADS_PER_BLOCK * K1_OPS_PER_TRIANGLE[geo]
           + shadow_visits * (K1_THREADS_PER_BLOCK * K8_OPS_PER_TRIANGLE
                              + K8_OPS_PER_BLOCK_TRIANGLE))
    if kw["geo"] == "raw_shadows":
        ops += views * lights * K8_OPS_PER_VIEW_LIGHT
    if geo == "raw":
        ops += blocks * S * K1_OPS_RAW_HOIST
    return roofline(nbytes, ops) + (nbytes, ops)


def k13_bound(state, scene, layout: str) -> tuple:
    """Least time for K13's work in ``layout`` (``pack_rows`` or
    ``pack_rows_raw``): each input read once, the [W, 40, S] rows written
    once, against its FP32 operations."""
    W, I = state.instance_obj.shape
    O, T = scene.tri_valid.shape
    M = scene.mat_color.shape[0]
    K = scene.tex_width.shape[0]
    cam_floats = W * 3 if layout == "pack_rows" else 0
    nbytes = 4 * (W * 40 * I * T + W * I * K13_FLOATS_PER_INSTANCE + cam_floats
                  + O * T * K13_FLOATS_PER_TRIANGLE + M * 5 + K * 2)
    ops = W * I * T * K13_OPS_PER_SLOT[layout]
    return roofline(nbytes, ops) + (nbytes, ops)


def roofline(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch import _build, config as cfg_mod
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene, configure_lighting
    from madrona_renderer_tpu_torch.core.state import init_state
    from madrona_renderer_tpu_torch.ops import pack_cuda
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card, "nvidia_smi": smi,
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "kernels": sorted(built), "seconds": time.perf_counter() - t0})

    # Per kernel name: the largest error against its plain version.
    max_err = {name: 0.0 for name in rc.VARIANTS + pack_cuda.LAYOUTS}

    def check_pack(tag, state, scene, cam):
        name = pack_cuda.layout_name(cam)
        k = pack_cuda.pack_rows(state, scene, cam)
        torch.cuda.synchronize()
        p = rc._pack_rows_planar(state, scene, cam)
        err = float((k - p).abs().max())
        max_err[name] = max(max_err[name], err)
        bitwise = torch.equal(k, p)
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": tag,
              "worlds": int(k.shape[0]), "slots": int(k.shape[2]),
              "max_abs_err": err, "bitwise": bitwise})
        if not bitwise:
            raise AssertionError(f"{tag}: {name} differs from its plain version")

    def variant(kw):
        return rc.variant_name(kw["raster"], kw["texture"], kw["geo"])

    def check_render(tag, kw):
        name = variant(kw)
        k_out = rc.render_resident(**kw)
        torch.cuda.synchronize()
        p_out = rc.render_resident_plain(**kw)
        c = compare_outputs(k_out, p_out)
        check_close(f"{tag} {name}", c)
        if kw["raster"] and not bool((k_out[1] == -1).all()):
            raise AssertionError(f"{tag} {name}: raster segmask is not -1 everywhere")
        max_err[name] = max(max_err[name], output_err(k_out, p_out))
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": tag,
              "hit_share": float((k_out[0] > 0).float().mean()), **c})
        return k_out

    # ---- 3. each kernel against its plain version on the card ----------- #
    tex_png = scenes.demo_texture_png(TEX_SIZE)
    two_lights = [((1.0, -1.0, -0.05), (0.7, 0.7, 0.7)),
                  ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2))]
    occluder_lights = [((1.0, 1.0, 0.0), (1.0, 1.0, 1.0))]
    cases = {
        "demo64_dynamic": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod), {}),
        "demo64_dynamic_tex32": (
            demo_scene(SMALL_WORLDS, True, scenes, cfg_mod, textured=True), {}),
        "demo64_4cams": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod, num_cams=4), {}),
        "demo64_4cams_tex32": (
            demo_scene(SMALL_WORLDS, True, scenes, cfg_mod, textured=True, num_cams=4), {}),
        "random7": (random_scene(7, SMALL_WORLDS, cfg_mod), {}),
        "random8": (random_scene(8, SMALL_WORLDS, cfg_mod), {}),
        "random9_textured": (random_scene(9, SMALL_WORLDS, cfg_mod, tex_png), {}),
        "random10_1to3cams": (random_scene(10, SMALL_WORLDS, cfg_mod, max_cams=3), {}),
        "demo64_40x24_two_lights": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod),
                                    dict(height=40, width=24, lights=two_lights)),
        "occluder64_one_light": (occluder_scene(SMALL_WORLDS, cfg_mod),
                                 dict(lights=occluder_lights)),
        "occluder64_two_lights": (occluder_scene(SMALL_WORLDS, cfg_mod),
                                  dict(lights=occluder_lights + two_lights[1:])),
    }
    for tag, (parts, opts) in cases.items():
        geo, mats, textures, insts, cams, worlds = parts
        scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
        if "lights" in opts:
            scene = configure_lighting(scene, lights=opts["lights"])
        state = init_state(insts, cams, worlds, dev)
        if state.max_cameras == 1:
            check_pack(tag, state, scene, state.camera_pos[:, 0, :])
        check_pack(tag, state, scene, None)
        size = dict(height=opts.get("height", HEIGHT), width=opts.get("width", WIDTH))
        filters = ("nearest", "bilinear") if rc.is_textured(scene) else ("nearest",)
        for shadows in (False, True):
            for raster in (False, True):
                for filt in filters:
                    kw = rc.pack_inputs(state, scene, raster=raster, texture_filter=filt,
                                        near=0.001 if raster else 0.1, shadows=shadows,
                                        **size)
                    out = check_render(tag, kw)
                    if tag.startswith("occluder") and shadows and not raster:
                        # The shadow falls on the ground: some lit pixels go dark.
                        lit = check_render(tag, dict(kw, geo="raw"))
                        darker = (lit[2].view(torch.uint8).int()
                                  - out[2].view(torch.uint8).int())
                        if not bool((darker > 10).any()) or bool((darker < 0).any()):
                            raise AssertionError(f"{tag}: the shadow does not show")

    # ---- 4. the five paths --------------------------------------------- #
    def reset_counts():
        rc.render_resident.launches = 0
        rc.render_resident.variant_launches = dict.fromkeys(rc.VARIANTS, 0)
        pack_cuda.pack_rows.layout_launches = dict.fromkeys(pack_cuda.LAYOUTS, 0)

    def drive(path, mode, n_worlds, textured, timed_steps, num_cams=1, shadows=False):
        """One path through MadronaRenderer: construct (which primes one
        step), then warm-up and timed steps, each after moving world 0's
        cube through the exported position tensor. Every view of world 0
        that saw the cube must change and every view of world 1 stay
        bit-identical. Returns the renderer, the step times, the launch
        counts of the run, the constructor's time and the variant's name."""
        cfg = scenes.demo_config(n_worlds, mode, WIDTH, HEIGHT, dynamic=True,
                                 textured=textured, tex_size=TEX_SIZE, num_cams=num_cams)
        C = num_cams
        reset_counts()
        t0 = time.perf_counter()
        r = m.MadronaRenderer(0, n_worlds, mode, WIDTH, HEIGHT, shadows=shadows,
                              **scenes.renderer_kwargs(cfg))
        torch.cuda.synchronize()
        ctor_s = time.perf_counter() - t0
        raster = mode == m.RenderMode.Rasterizer
        pos = r.instance_position_tensor().to_torch()
        step_s = []
        for i in range(WARMUP_STEPS + timed_steps):
            depth0 = r.depth_tensor().to_torch()[:2 * C].clone()
            rgb0 = r.rgb_tensor().to_torch()[:2 * C].clone()
            if raster:  # the cube shows in the depth of the views that see it
                sees = torch.ones(C, dtype=torch.bool, device=dev)
            else:
                sees = (r.segmask_tensor().to_torch()[:C] == 0).flatten(1).any(1)
            # World 0's cube (instance 0) moves along all three axes, so the
            # depth of every cube face any camera sees changes.
            pos[0][0] += 0.03
            pos[0][1] += 0.05
            pos[0][2] += 0.02
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.step()
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                step_s.append(time.perf_counter() - t0)
            depth1 = r.depth_tensor().to_torch()[:2 * C]
            rgb1 = r.rgb_tensor().to_torch()[:2 * C]
            changed = (depth0[:C] != depth1[:C]).flatten(1).any(1)
            if not bool(sees.any()) or bool((sees & ~changed).any()):
                raise AssertionError(f"{path} step {i}: a view of world 0 that sees the "
                                     f"cube did not change ({sees.tolist()}, "
                                     f"{changed.tolist()})")
            if not (torch.equal(depth0[C:], depth1[C:]) and torch.equal(rgb0[C:], rgb1[C:])):
                raise AssertionError(f"{path} step {i}: world 1 changed without a mutation")
        counts = dict(rc.render_resident.variant_launches, **pack_cuda.pack_rows.layout_launches)
        steps = 1 + WARMUP_STEPS + timed_steps
        kw = rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH, raster=raster,
                            texture_filter=r.cfg.texture_filter, shadows=shadows)
        name = variant(kw)
        layout = pack_cuda.LAYOUTS[kw["geo"] != "prep"]
        expected = dict.fromkeys(rc.VARIANTS + pack_cuda.LAYOUTS, 0)
        expected.update({name: steps, layout: steps})
        if counts != expected or rc.render_resident.launches != steps:
            raise AssertionError(f"{path}: launches {counts} in {steps} steps, "
                                 f"expected {expected}")
        return r, step_s, counts, ctor_s, name

    def path_inputs(r, **over):
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer
        kw = dict(height=HEIGHT, width=WIDTH, raster=raster,
                  near=r.cfg.raster_near_plane if raster else r.cfg.near_plane,
                  texture_filter=r.cfg.texture_filter, shadows=bool(r.cfg.shadows))
        kw.update(over)
        return rc.pack_inputs(r.state, r.scene, **kw)

    def full_size_checks(path, r, name):
        """The path's kernel on the last step's inputs reproduces the
        exported frames; K13 and the kernel equal their plain versions at
        full size."""
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer
        kw = path_inputs(r)
        k_out = rc.render_resident(**kw)
        depth = r.depth_tensor().to_torch()
        depth = depth[..., 0] if raster else depth
        rgb = r.rgb_tensor().to_torch().contiguous().view(torch.int32).squeeze(-1)
        exported = [depth, rgb]
        if not raster:
            exported.insert(1, r.segmask_tensor().to_torch())
        produced = [k_out[0], k_out[2]] if raster else list(k_out)
        if not all(torch.equal(k, e) for k, e in zip(produced, exported)):
            raise AssertionError(f"{path}: {name} on the last step's inputs differs "
                                 "from the exports")
        if not torch.isfinite(depth).all() or not bool((depth > 0).any()):
            raise AssertionError(f"{path}: depth not finite or empty")
        check_pack(path, r.state, r.scene,
                   r.state.camera_pos[:, 0, :] if kw["geo"] == "prep" else None)
        check_render(path, kw)
        return kw

    def time_path(path, r, step_s, counts, ctor_s, extra):
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer
        n_views = r.total_num_cameras
        step_ms = statistics.median(step_s) * 1e3
        emit({"phase": path, "card": card, "nvidia_smi": smi,
              "worlds": r.cfg.num_worlds, "views": n_views, "height": HEIGHT, "width": WIDTH,
              "mode": "rasterizer" if raster else "raytracer",
              "textured": rc.is_textured(r.scene), "shadows": bool(r.cfg.shadows),
              "ctor_s": ctor_s, "steps_timed": len(step_s), "step_ms_median": step_ms,
              "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
              "frames_per_s": n_views / (step_ms / 1e3),
              "prologue_ms": host_ms(lambda: path_inputs(r), TIMED_STEPS),
              "prologue_torch_ops": count_torch_ops(lambda: path_inputs(r)),
              "launches": counts, **extra,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    # Per kernel name: (inputs for its timing, launches on the paths); and
    # (name, path, inputs) of the timings on a second path's inputs.
    timing_kw, launches = {}, dict.fromkeys(rc.VARIANTS + pack_cuda.LAYOUTS, 0)
    extra_timing = []

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] += v

    # main: untextured raytrace, 4096 worlds.
    r, step_s, counts, ctor_s, name = drive("main", m.RenderMode.Raytracer,
                                            NUM_WORLDS, False, TIMED_STEPS)
    seg = r.segmask_tensor().to_torch()
    if set(torch.unique(seg).tolist()) != {-1, 0, 1}:
        raise AssertionError(f"main: segmask values {torch.unique(seg).tolist()}")
    timing_kw[name] = full_size_checks("main", r, name)
    timing_kw["pack_rows"] = (r.state, r.scene)
    # The raw sweep on main's one-camera rows, against its plain version and
    # against the prep sweep that main runs (a few ulp of depth apart: the
    # determinant rounds otherwise), and timed: what the prep rows buy.
    kw_raw = dict(timing_kw[name], rows=pack_cuda.pack_rows(r.state, r.scene), geo="raw")
    raw_out = check_render("main_inputs", kw_raw)
    emit({"phase": "prep_vs_raw", "path": "main",
          **compare_outputs(raw_out, rc.render_resident(**timing_kw[name]))})
    extra_timing.append(("render_resident_raw", "main", kw_raw))
    # The raster variant of the untextured scene runs on no path: it is held
    # to its plain version and timed on the main path's inputs.
    kw_raster = path_inputs(r, raster=True, near=r.cfg.raster_near_plane)
    check_render("main_inputs", kw_raster)
    timing_kw[variant(kw_raster)] = kw_raster
    time_path("main", r, step_s, counts, ctor_s, {})
    add_launches(counts)
    del r

    # textured_4096w: the 32x32 PNG checkerboard, nearest filtering.
    r, step_s, counts, ctor_s, name = drive("textured_4096w", m.RenderMode.Raytracer,
                                            NUM_WORLDS, True, TIMED_STEPS)
    timing_kw[name] = full_size_checks("textured_4096w", r, name)
    kw_bilinear = path_inputs(r, texture_filter="bilinear")
    check_render("textured_4096w_inputs", kw_bilinear)
    timing_kw[variant(kw_bilinear)] = kw_bilinear
    # The textured variants with shadows run on no path: held to their plain
    # versions and timed on these inputs with shadows on.
    for filt in ("nearest", "bilinear"):
        for raster in (False, True):
            kw = path_inputs(r, texture_filter=filt, shadows=True, raster=raster,
                             near=r.cfg.raster_near_plane if raster else r.cfg.near_plane)
            check_render("textured_4096w_inputs", kw)
            timing_kw[variant(kw)] = kw
    rgb = r.rgb_tensor().to_torch()[..., :3].reshape(-1, 3)
    n_colours = int(torch.unique(rgb, dim=0).shape[0])
    if n_colours < 8:
        raise AssertionError(f"textured_4096w: only {n_colours} colours: no texture shows")
    time_path("textured_4096w", r, step_s, counts, ctor_s, {"distinct_colours": n_colours})
    add_launches(counts)
    del r

    # raster_256w_png: BASELINE config 2 with the texture as PNG.
    r, step_s, counts, ctor_s, name = drive("raster_256w_png", m.RenderMode.Rasterizer,
                                            RASTER_WORLDS, True, RASTER_TIMED_STEPS)
    if tuple(r.depth_tensor().to_torch().shape) != (RASTER_WORLDS, HEIGHT, WIDTH, 1):
        raise AssertionError("raster_256w_png: depth export shape")
    try:
        r.segmask_tensor()
    except RuntimeError:
        pass
    else:
        raise AssertionError("raster_256w_png: segmask_tensor() did not raise")
    timing_kw[name] = full_size_checks("raster_256w_png", r, name)
    kw_bilinear = path_inputs(r, texture_filter="bilinear")
    check_render("raster_256w_png_inputs", kw_bilinear)
    timing_kw[variant(kw_bilinear)] = kw_bilinear
    time_path("raster_256w_png", r, step_s, counts, ctor_s, {})
    add_launches(counts)
    del r

    # multicam_1024w4c: bench.py's multi-camera row, 1024 worlds x 4 views.
    r, step_s, counts, ctor_s, name = drive(
        "multicam_1024w4c", m.RenderMode.Raytracer, MULTICAM_WORLDS, False, TIMED_STEPS,
        num_cams=MULTICAM_CAMS)
    n_views = MULTICAM_WORLDS * MULTICAM_CAMS
    if tuple(r.rgb_tensor().to_torch().shape) != (n_views, HEIGHT, WIDTH, 4):
        raise AssertionError("multicam_1024w4c: rgb export shape")
    views = r.depth_tensor().to_torch()[:MULTICAM_CAMS]
    if any(torch.equal(views[0], views[c]) for c in range(1, MULTICAM_CAMS)):
        raise AssertionError("multicam_1024w4c: two cameras of world 0 render the same view")
    timing_kw[name] = full_size_checks("multicam_1024w4c", r, name)
    extra_timing.append(("pack_rows_raw", "multicam_1024w4c", (r.state, r.scene)))
    kw_raster = path_inputs(r, raster=True, near=r.cfg.raster_near_plane)
    check_render("multicam_1024w4c_inputs", kw_raster)
    timing_kw[variant(kw_raster)] = kw_raster
    time_path("multicam_1024w4c", r, step_s, counts, ctor_s, {})
    add_launches(counts)
    del r
    # The textured raw variants run on no path: held to their plain versions
    # and timed on the textured multicam scene at the same size.
    parts = demo_scene(MULTICAM_WORLDS, True, scenes, cfg_mod, textured=True,
                       num_cams=MULTICAM_CAMS)
    geo, mats, textures, insts, cams, worlds = parts
    tex_scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
    tex_state = init_state(insts, cams, worlds, dev)
    for filt in ("nearest", "bilinear"):
        for raster in (False, True):
            kw = rc.pack_inputs(tex_state, tex_scene, height=HEIGHT, width=WIDTH,
                                raster=raster, near=0.001 if raster else 0.1,
                                texture_filter=filt)
            check_render("multicam_1024w4c_tex32", kw)
            timing_kw[variant(kw)] = kw

    # shadows_4096w: main with one shadow ray per pixel and light.
    r, step_s, counts, ctor_s, name = drive("shadows_4096w", m.RenderMode.Raytracer,
                                            NUM_WORLDS, False, TIMED_STEPS, shadows=True)
    kw = full_size_checks("shadows_4096w", r, name)
    timing_kw[name] = kw
    # K13's raw layout runs on both new paths; it is timed on the larger.
    timing_kw["pack_rows_raw"] = (r.state, r.scene)
    # Against the unshadowed render of the same rows (the raw variant): the
    # shadow darkens some pixels and changes nothing but rgb.
    lit = rc.render_resident(**dict(kw, geo="raw"))
    shadowed = (r.depth_tensor().to_torch(), r.segmask_tensor().to_torch(),
                r.rgb_tensor().to_torch().contiguous().view(torch.int32).squeeze(-1))
    if not (torch.equal(lit[0], shadowed[0]) and torch.equal(lit[1], shadowed[1])):
        raise AssertionError("shadows_4096w: depth or segmask differ from the unshadowed render")
    darker = lit[2].view(torch.uint8).int() - shadowed[2].view(torch.uint8).int()
    if not bool((darker > 0).any()) or bool((darker < 0).any()):
        raise AssertionError("shadows_4096w: shadows must darken some pixels and brighten none")
    shadowed_px = int((darker > 0).any(-1).sum())
    kw_raster = path_inputs(r, raster=True, near=r.cfg.raster_near_plane)
    check_render("shadows_4096w_inputs", kw_raster)
    timing_kw[variant(kw_raster)] = kw_raster
    time_path("shadows_4096w", r, step_s, counts, ctor_s,
              {"shadowed_pixels": shadowed_px})
    add_launches(counts)
    del r

    # ---- timings of every kernel at its path's full-size inputs --------- #
    def k13_row(layout, state, scene):
        cam = state.camera_pos[:, 0, :].contiguous() if layout == "pack_rows" else None
        bound_ms, bound_by, nbytes, ops = k13_bound(state, scene, layout)
        return {
            "name": layout, "route": "cuda",
            "source": "madrona_renderer_tpu_torch/csrc/pack_rows.cu",
            "replaces": "madrona_renderer_tpu/ops/pack_pallas.py:374",
            "launches": launches[layout], "max_abs_err": max_err[layout],
            "ms": graph_ms(lambda: pack_cuda.pack_rows(state, scene, cam), KERNEL_REPS),
            "wrapper_ms": cuda_ms(lambda: pack_cuda.pack_rows(state, scene, cam), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: rc._pack_rows_planar(state, scene, cam), 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "worlds": int(state.instance_obj.shape[0]), "bytes": nbytes, "ops": ops,
        }

    def render_row(name, kw):
        visits, shadow_visits = k1_triangle_tests(kw)
        bound_ms, bound_by, nbytes, ops = k1_bound(kw, visits, shadow_visits)
        return {
            "name": name, "route": "cuda",
            "source": "madrona_renderer_tpu_torch/csrc/render_resident.cu",
            "replaces": "madrona_renderer_tpu/ops/raytrace_pallas.py:4872",
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": graph_ms(lambda: rc.render_resident(**kw), KERNEL_REPS),
            "wrapper_ms": cuda_ms(lambda: rc.render_resident(**kw), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: rc.render_resident_plain(**kw), 2),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "views": int(kw["cams"].shape[0]), "triangle_visits": visits,
            "shadow_triangle_visits": shadow_visits, "bytes": nbytes, "ops": ops,
        }

    rows = []
    for layout in pack_cuda.LAYOUTS:
        rows.append(k13_row(layout, *timing_kw[layout]))
        emit({"phase": "timing", **rows[-1]})
    for name in rc.VARIANTS:
        rows.append(render_row(name, timing_kw[name]))
        emit({"phase": "timing", **rows[-1]})
    for name, path, inputs in extra_timing:
        row = k13_row(name, *inputs) if name in pack_cuda.LAYOUTS else render_row(name, inputs)
        emit({"phase": "timing", "inputs": path, **row})

    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
