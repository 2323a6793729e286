"""GPU smoke run of the PyTorch/CUDA port (madrona_renderer_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc). Phases, each
printed as one JSON line:

  1. env     — Python/torch/CUDA versions, the card's name and power limit;
  2. build   — every kernel under madrona_renderer_tpu_torch/csrc, one nvcc
               per source, all started together;
  3. kernels — each kernel against its plain PyTorch version on the same
               CUDA inputs (the demo scene and two random scenes, 64 worlds
               at 64x64, and the demo scene at 40x24 with two lights);
  4. main    — the main path: MadronaRenderer over demo_config at 4096
               worlds x 64x64, stepped with a position mutation through the
               exported tensor between steps; kernel launch counts and frame
               checks; then K1 on the last step's inputs, equal to the
               exported frames and held against its plain version at full
               size, and the timings;

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
HEIGHT = WIDTH = 64
WARMUP_STEPS = 3
TIMED_STEPS = 20
KERNEL_REPS = 50

# H100 SXM peaks (NVIDIA data sheet). The published 67 TFLOP/s of FP32
# outside the tensor cores counts a fused multiply-add as two operations
# (132 SMs x 128 lanes x 2 x 1.98 GHz). K1 is built with --fmad=false, so
# each operation counted below issues as an instruction of its own: its
# peak is half of that.
PEAK_FP32_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12

# K1's FP32 operations, counted from csrc/render_resident.cu (add, sub, mul,
# div, sqrt, min, max and compare count one each, though an IEEE divide or
# square root takes several instructions, so the bound is a floor): per
# thread, ray
# generation 30 + direction inverses 9 + winner resolve 36 + flip 9 +
# shading 29 + 14 per light; per thread and cluster, the slab test 25; per
# triangle test 27.
K1_OPS_FIXED = 113
K1_OPS_PER_LIGHT = 14
K1_OPS_PER_CLUSTER = 25
K1_OPS_PER_TRIANGLE = 27
K1_THREADS_PER_BLOCK = 256
K1_ROWS_READ = 22  # prep rows 0-9 + attribute rows n0, dn1, dn2, colour


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


def random_scene(seed: int, n_worlds: int, cfg_mod):
    """Random untextured triangles, 1-4 instances and one camera per world."""
    rng = np.random.default_rng(seed)
    meshes = [(rng.normal(size=(int(rng.integers(1, 7)) * 3, 3)) * 5).astype(np.float32)
              for _ in range(int(rng.integers(1, 4)))]
    verts = np.concatenate(meshes)
    counts = [len(m) for m in meshes]
    offs = np.cumsum([0] + counts[:-1]).astype(np.uint32)
    geo = cfg_mod.GeometryConfig(
        vertices=verts, uvs=np.zeros((len(verts), 2), np.float32),
        indices=np.concatenate([np.arange(c, dtype=np.uint32) for c in counts]),
        mesh_vertex_offsets=offs, mesh_index_offsets=offs.copy(),
        mesh_materials=np.full(len(meshes), -1, np.int32),
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
        cameras.append(cfg_mod.ImportedCamera(
            position=(rng.normal(size=3) * 3 + [0, -12, 0]).tolist(),
            rotation=unit(rng.normal(size=4) * 0.2 + [1, 0, 0, 0])))
        worlds.append(cfg_mod.WorldInit(n_inst, n_inst * w, 1, w))
    return geo, [], instances, cameras, worlds


def demo_scene(n_worlds: int, dynamic: bool, scenes, cfg_mod):
    r = scenes.demo_config(n_worlds, cfg_mod.RenderMode.Raytracer, WIDTH, HEIGHT,
                           dynamic=dynamic).rcfg
    return r.geo_cfg, r.additional_mats, r.instances, r.cameras, r.worlds


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
    if c["rgb_max_lsb"] > 1 or c["depth_outside_rtol"] or c["seg_mismatches"] > 1e-4 * c["pixels"]:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version: {c}")


def k1_triangle_tests(kw: dict) -> int:
    """Triangle tests K1 makes on these inputs, per thread of a block and
    summed over blocks: its block cull replayed in torch ops. Cluster by
    cluster, a 16x16 block visits the cluster's valid prefix when the
    cluster is valid and any of its rays passes the slab test against the
    ray's best t so far; the rays of a visiting block then take the
    prefix's hits."""
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc

    H, Wd = kw["height"], kw["width"]
    if H % 16 or Wd % 16:
        raise ValueError("the replay covers images in whole 16x16 blocks")
    rows, cams, nc = kw["rows"], kw["cams"], kw["num_cams"]
    world = torch.arange(cams.shape[0], device=cams.device) // nc
    rows_v, cl = rows[world], kw["clusters"][world]
    CC = cl.shape[2]
    size = rows.shape[2] // CC
    dirs = rc.plain_rays(cams, H, Wd)
    tiny = float(np.float32(1e-20))
    inv = [1.0 / torch.where(d.abs() > tiny, d, torch.where(d < 0, -tiny, tiny))
           for d in dirs]
    near = cams[:, 14:15]
    best_t = cams[:, 15:16].expand_as(dirs[0]).clone()
    tests = 0
    for c in range(CC):
        t1 = [(cl[:, k, c:c + 1] - cams[:, k:k + 1]) * inv[k] for k in range(3)]
        t2 = [(cl[:, 3 + k, c:c + 1] - cams[:, k:k + 1]) * inv[k] for k in range(3)]
        lo = [torch.minimum(a, b) for a, b in zip(t1, t2)]
        hi = [torch.maximum(a, b) for a, b in zip(t1, t2)]
        tmin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
        tmax = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
        possible = (tmax >= tmin) & (tmax > near) & (tmin < best_t)
        block = possible.reshape(-1, H // 16, 16, Wd // 16, 16).any(4).any(2)
        block = block & (cl[:, 6, c] > 0)[:, None, None]
        cnt = cl[:, 7, c].long()
        tests += int((block.sum((1, 2)) * cnt).sum())
        ray_in = block[:, :, None, :, None].expand(-1, -1, 16, -1, 16).reshape(
            possible.shape)
        for j in range(size):
            i = c * size + j
            ok, t, _, _ = rc.plain_triangle_test(
                *dirs, rows_v[:, :10, i:i + 1], near, best_t)
            best_t = torch.where(ok & ray_in & (j < cnt)[:, None], t, best_t)
    return tests


def k1_bound(kw: dict, visits: int) -> tuple:
    """Least time for K1's work on these inputs: bytes over HBM rate vs FP32
    operations over peak, the larger of the two (ms, 'bytes'|'operations')."""
    W, _, S = kw["rows"].shape
    CC = kw["clusters"].shape[2]
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    tiles = math.ceil(kw["height"] / 16) * math.ceil(kw["width"] / 16)
    threads = views * tiles * K1_THREADS_PER_BLOCK
    nbytes = (W * K1_ROWS_READ * S * 4 + kw["clusters"].numel() * 4
              + kw["cams"].numel() * 4 + pixels * 12)
    ops = (threads * (K1_OPS_FIXED + K1_OPS_PER_LIGHT * kw["n_lights"]
                      + K1_OPS_PER_CLUSTER * CC)
           + visits * K1_THREADS_PER_BLOCK * K1_OPS_PER_TRIANGLE)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch import _build, config as cfg_mod
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene, configure_lighting
    from madrona_renderer_tpu_torch.core.state import init_state
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

    # ---- 3. each kernel against its plain version on the card ----------- #
    def inputs(parts, height=HEIGHT, width=WIDTH, lights=None):
        geo, mats, insts, cams, worlds = parts
        scene = bake_scene(load_render_assets(geo, [], mats, []), dev)
        if lights is not None:
            scene = configure_lighting(scene, lights=lights)
        state = init_state(insts, cams, worlds, dev)
        return rc.pack_inputs(state, scene, height=height, width=width)

    # The main path's shapes, plus one off-path check of the image edge
    # (sizes not a multiple of the 16x16 block) and of two lights.
    two_lights = [((1.0, -1.0, -0.05), (0.7, 0.7, 0.7)),
                  ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2))]
    cases = {
        "demo64_dynamic": (demo_scene(64, True, scenes, cfg_mod), {}),
        "random7": (random_scene(7, 64, cfg_mod), {}),
        "random8": (random_scene(8, 64, cfg_mod), {}),
        "demo64_40x24_two_lights": (demo_scene(64, True, scenes, cfg_mod),
                                    dict(height=40, width=24, lights=two_lights)),
    }
    max_err = 0.0
    for tag, (parts, opts) in cases.items():
        kw = inputs(parts, **opts)
        k_out = rc.render_resident(**kw)
        torch.cuda.synchronize()
        p_out = rc.render_resident_plain(**kw)
        c = compare_outputs(k_out, p_out)
        check_close(tag, c)
        max_err = max(max_err, c["rgb_max_lsb"], c["depth_max_abs"],
                      float((k_out[1] - p_out[1]).abs().max()))
        emit({"phase": "kernel_vs_plain", "kernel": "render_resident", "case": tag,
              "hit_share": float((k_out[1] >= 0).float().mean()), **c})

    # ---- 4. the main path ------------------------------------------------ #
    cfg = scenes.demo_config(NUM_WORLDS, m.RenderMode.Raytracer, WIDTH, HEIGHT)
    rc.render_resident.launches = 0
    t0 = time.perf_counter()
    r = m.MadronaRenderer(0, NUM_WORLDS, m.RenderMode.Raytracer, WIDTH, HEIGHT,
                          **scenes.renderer_kwargs(cfg))
    torch.cuda.synchronize()
    ctor_s = time.perf_counter() - t0
    pos = r.instance_position_tensor().to_torch()
    step_s, snaps = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        prev = (r.depth_tensor().to_torch()[:2].clone(),
                r.rgb_tensor().to_torch()[:2].clone())
        pos[0][1] += 0.05  # world 0's cube (instance 0) moves toward its camera
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            step_s.append(time.perf_counter() - t0)
        snaps.append((prev, (r.depth_tensor().to_torch()[:2].clone(),
                             r.rgb_tensor().to_torch()[:2].clone())))
    launches = rc.render_resident.launches
    steps = 1 + WARMUP_STEPS + TIMED_STEPS  # the constructor primes one step
    if launches != steps:
        raise AssertionError(f"render_resident launched {launches} times in {steps} steps")
    for i, ((d0, c0), (d1, c1)) in enumerate(snaps):
        if torch.equal(d0[0], d1[0]):
            raise AssertionError(f"step {i}: world 0's depth did not change after its mutation")
        if not (torch.equal(d0[1], d1[1]) and torch.equal(c0[1], c1[1])):
            raise AssertionError(f"step {i}: world 1 changed without a mutation")

    seg = r.segmask_tensor().to_torch()
    depth = r.depth_tensor().to_torch()
    values = set(torch.unique(seg).tolist())
    if values != {-1, 0, 1} or not torch.isfinite(depth).all():
        raise AssertionError(f"segmask values {values} or non-finite depth")
    if tuple(r.rgb_tensor().to_torch().shape) != (NUM_WORLDS, HEIGHT, WIDTH, 4):
        raise AssertionError("rgb export shape")

    # K1 on the last step's inputs reproduces the exported frames; the plain
    # version on the same inputs, at full size, holds it to the bar.
    kw = rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH)
    k_out = rc.render_resident(**kw)
    exported = (depth, seg, r.rgb_tensor().to_torch().contiguous()
                .view(torch.int32).squeeze(-1))
    if not all(torch.equal(k, e) for k, e in zip(k_out, exported)):
        raise AssertionError("K1 on the last step's inputs differs from the exports")
    p_out = rc.render_resident_plain(**kw)
    c = compare_outputs(k_out, p_out)
    check_close("main", c)
    share_k = float((k_out[1] >= 0).float().mean())
    share_p = float((p_out[1] >= 0).float().mean())
    if abs(share_k - share_p) > 1e-3:
        raise AssertionError(f"main: hit share {share_k} vs plain {share_p}")
    max_err = max(max_err, c["rgb_max_lsb"], c["depth_max_abs"],
                  float((k_out[1] - p_out[1]).abs().max()))
    emit({"phase": "kernel_vs_plain", "kernel": "render_resident", "case": "main",
          "hit_share": share_k, "hit_share_plain": share_p, **c})
    del k_out, p_out, exported

    visits = k1_triangle_tests(kw)
    bound_ms, bound_by, nbytes, ops = k1_bound(kw, visits)
    k1_ms = cuda_ms(lambda: rc.render_resident(**kw), KERNEL_REPS)

    def prologue():
        return rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH)

    pack_ms = host_ms(prologue, TIMED_STEPS)
    pack_ops = count_torch_ops(prologue)
    plain_ms = cuda_ms(lambda: rc.render_resident_plain(**kw), 2)
    step_ms = statistics.median(step_s) * 1e3
    emit({"phase": "main", "card": card, "nvidia_smi": smi, "worlds": NUM_WORLDS,
          "height": HEIGHT, "width": WIDTH, "ctor_s": ctor_s,
          "steps_timed": TIMED_STEPS, "step_ms_median": step_ms,
          "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
          "frames_per_s": NUM_WORLDS / (step_ms / 1e3),
          "k1_ms": k1_ms, "prologue_ms": pack_ms, "prologue_torch_ops": pack_ops, "plain_ms": plain_ms,
          "k1_launches": launches, "k1_triangle_visits_per_block_sum": visits,
          "k1_bytes": nbytes, "k1_ops": ops,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "render_resident",
        "route": "cuda",
        "source": "madrona_renderer_tpu_torch/csrc/render_resident.cu",
        "replaces": "madrona_renderer_tpu/ops/raytrace_pallas.py:4872",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
