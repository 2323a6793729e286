"""GPU smoke run of the PyTorch/CUDA port (madrona_renderer_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc). Phases, each
printed as JSON lines:

  1. env     — Python/torch/CUDA versions, the card's name and power limit;
  2. build   — every kernel under madrona_renderer_tpu_torch/csrc, one nvcc
               per source, all started together;
  3. kernel_vs_plain — each kernel against its plain PyTorch version on the
               same CUDA inputs at 64 worlds: the fused pack K13
               (``pack_rows``, bitwise) on the demo scene, untextured and
               textured, and on a textured random scene; every variant of
               the render kernel (raytrace / raster x untextured / nearest /
               bilinear) on the demo scene and random scenes, 64x64, and the
               demo scene at 40x24 with two lights;
  4. paths   — the three paths of the port, each through MadronaRenderer and
               stepped with a position mutation through the exported tensor
               between steps, with every launch count set to 0 just before
               and read just after:
                 main            demo_config, 4096 worlds x 64x64, raytraced;
                 textured_4096w  the same with the 32x32 PNG checkerboard,
                                 nearest filtering;
                 raster_256w_png 256 worlds x 64x64 of the textured cube,
                                 RenderMode.Rasterizer;
               then, on each path's last inputs at full size, the kernels
               against the exported frames and their plain versions; one
               line per path (phase = its name) with the step and prologue
               times on the host clock and the prologue's operator count;
  5. timing  — each kernel at its path's full-size inputs: its device time
               in a CUDA graph of back-to-back launches, its time through
               the wrapper (host overhead included), its plain version's
               time, its bound;

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
# thread, ray generation 30 + direction inverses 9 + winner resolve 36 +
# flip 9 + shading 29 + 14 per light; per thread and cluster, the slab test
# 25; per triangle test 27. The raster variant adds the cosine, its floor,
# the t-space near bound, z and the far clip (9); the textured variants add
# the uv resolve (8), the material lookup (4), the wrap (4) and the sample:
# nearest 11 (two products, two conversions, three dequant divides, three
# colour products, 1 - v), bilinear 62 (the texel-centre offsets, floors,
# weights and conversions 14, twelve dequant divides, three lerps of 12,
# three colour products).
K1_OPS_FIXED = 113
K1_OPS_PER_LIGHT = 14
K1_OPS_PER_CLUSTER = 25
K1_OPS_PER_TRIANGLE = 27
K1_OPS_RASTER = 9
K1_OPS_TEX = {None: 0, "nearest": 8 + 4 + 4 + 11, "bilinear": 8 + 4 + 4 + 62}
K1_THREADS_PER_BLOCK = 256
# Rows of the pack each hit reads once: prep rows 0-9, the normal rows, and
# the colour rows (untextured) or the material and uv rows (textured).
K1_ROWS_READ = {None: 10 + 9 + 3, "nearest": 10 + 9 + 7, "bilinear": 10 + 9 + 7}
# K13's FP32 operations per (world, triangle slot), counted from
# csrc/pack_rows.cu: six quaternion rotations of 30, the scaled vertex and
# edge products and the translation 12, the validity product 1, three
# inverse scales of 8 and the normal products 9, the texel density 26, the
# prep products 41, the material id conversion 1.
K13_OPS_PER_SLOT = 6 * 30 + 12 + 1 + 24 + 9 + 26 + 41 + 1
# Floats K13 reads once: per instance pos, quat, scale, valid, object id;
# per world the camera origin; per object triangle v0, e1, e2, n0, dn1,
# dn2, uv0, duv1, duv2, material, valid; per material colour and texture
# id; per texture width and height.
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


def random_scene(seed: int, n_worlds: int, cfg_mod, texture=None):
    """Random triangles, 1-4 instances and one camera per world; with a
    ``texture`` path, random uvs (beyond [0, 1], so the repeat wrap works)
    and the first mesh's material textured."""
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
        cameras.append(cfg_mod.ImportedCamera(
            position=(rng.normal(size=3) * 3 + [0, -12, 0]).tolist(),
            rotation=unit(rng.normal(size=4) * 0.2 + [1, 0, 0, 0])))
        worlds.append(cfg_mod.WorldInit(n_inst, n_inst * w, 1, w))
    return geo, mats, textures, instances, cameras, worlds


def demo_scene(n_worlds: int, dynamic: bool, scenes, cfg_mod, textured=False):
    r = scenes.demo_config(n_worlds, cfg_mod.RenderMode.Raytracer, WIDTH, HEIGHT,
                           dynamic=dynamic, textured=textured, tex_size=TEX_SIZE).rcfg
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


def k1_triangle_tests(kw: dict) -> int:
    """Triangle tests the render kernel makes on these inputs, per thread of
    a block and summed over blocks: its block cull replayed in torch ops.
    Cluster by cluster, a 16x16 block visits the cluster's valid prefix when
    the cluster is valid and any of its rays passes the slab test against
    the ray's best t so far; the rays of a visiting block then take the
    prefix's hits (above the raster variant's per-pixel near bound)."""
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
    t_lo = near
    if kw["raster"]:
        cosf = dirs[0] * cams[:, 6:7] + dirs[1] * cams[:, 7:8] + dirs[2] * cams[:, 8:9]
        t_lo = near / torch.clamp_min(cosf, float(np.float32(1e-6)))
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
                *dirs, rows_v[:, :10, i:i + 1], t_lo, best_t)
            best_t = torch.where(ok & ray_in & (j < cnt)[:, None], t, best_t)
    return tests


def k1_bound(kw: dict, visits: int) -> tuple:
    """Least time for the render kernel's work on these inputs: bytes over
    HBM rate vs FP32 operations over peak, the larger of the two
    (ms, 'bytes'|'operations', bytes, operations)."""
    W, _, S = kw["rows"].shape
    CC = kw["clusters"].shape[2]
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    tiles = math.ceil(kw["height"] / 16) * math.ceil(kw["width"] / 16)
    threads = views * tiles * K1_THREADS_PER_BLOCK
    tex = kw["texture"]
    nbytes = (W * K1_ROWS_READ[tex] * S * 4 + kw["clusters"].numel() * 4
              + kw["cams"].numel() * 4 + pixels * 12)
    if tex is not None:
        nbytes += kw["mats"].numel() * 4 + kw["pool"].numel() * 4
    per_thread = (K1_OPS_FIXED + K1_OPS_PER_LIGHT * kw["n_lights"]
                  + K1_OPS_PER_CLUSTER * CC + K1_OPS_TEX[tex]
                  + (K1_OPS_RASTER if kw["raster"] else 0))
    ops = threads * per_thread + visits * K1_THREADS_PER_BLOCK * K1_OPS_PER_TRIANGLE
    return roofline(nbytes, ops) + (nbytes, ops)


def k13_bound(state, scene) -> tuple:
    """Least time for K13's work: each input read once, the [W, 40, S] rows
    written once, against its FP32 operations."""
    W, I = state.instance_obj.shape
    O, T = scene.tri_valid.shape
    M = scene.mat_color.shape[0]
    K = scene.tex_width.shape[0]
    nbytes = 4 * (W * 40 * I * T + W * I * K13_FLOATS_PER_INSTANCE + W * 3
                  + O * T * K13_FLOATS_PER_TRIANGLE + M * 5 + K * 2)
    ops = W * I * T * K13_OPS_PER_SLOT
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
    max_err = {name: 0.0 for name in rc.VARIANTS + ("pack_rows",)}

    def check_pack(tag, state, scene):
        cam = state.camera_pos[:, 0, :]
        k = pack_cuda.pack_rows(state, scene, cam)
        torch.cuda.synchronize()
        p = rc._pack_rows_planar(state, scene, cam)
        err = float((k - p).abs().max())
        max_err["pack_rows"] = max(max_err["pack_rows"], err)
        bitwise = torch.equal(k, p)
        emit({"phase": "kernel_vs_plain", "kernel": "pack_rows", "case": tag,
              "worlds": int(k.shape[0]), "slots": int(k.shape[2]),
              "max_abs_err": err, "bitwise": bitwise})
        if not bitwise:
            raise AssertionError(f"{tag}: pack_rows differs from its plain version")

    def check_render(tag, kw):
        name = rc.variant_name(kw["raster"], kw["texture"])
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
    cases = {
        "demo64_dynamic": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod), {}),
        "demo64_dynamic_tex32": (
            demo_scene(SMALL_WORLDS, True, scenes, cfg_mod, textured=True), {}),
        "random7": (random_scene(7, SMALL_WORLDS, cfg_mod), {}),
        "random8": (random_scene(8, SMALL_WORLDS, cfg_mod), {}),
        "random9_textured": (random_scene(9, SMALL_WORLDS, cfg_mod, tex_png), {}),
        "demo64_40x24_two_lights": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod),
                                    dict(height=40, width=24, lights=two_lights)),
    }
    for tag, (parts, opts) in cases.items():
        geo, mats, textures, insts, cams, worlds = parts
        scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
        if "lights" in opts:
            scene = configure_lighting(scene, lights=opts["lights"])
        state = init_state(insts, cams, worlds, dev)
        check_pack(tag, state, scene)
        size = dict(height=opts.get("height", HEIGHT), width=opts.get("width", WIDTH))
        filters = ("nearest", "bilinear") if rc.is_textured(scene) else ("nearest",)
        for raster in (False, True):
            for filt in filters:
                kw = rc.pack_inputs(state, scene, raster=raster, texture_filter=filt,
                                    near=0.001 if raster else 0.1, **size)
                check_render(tag, kw)

    # ---- 4. the three paths -------------------------------------------- #
    def reset_counts():
        rc.render_resident.launches = 0
        rc.render_resident.variant_launches = dict.fromkeys(rc.VARIANTS, 0)
        pack_cuda.pack_rows.launches = 0

    def drive(path, mode, n_worlds, textured, timed_steps):
        """One path through MadronaRenderer: construct (which primes one
        step), then warm-up and timed steps, each after moving world 0's
        cube through the exported position tensor. Returns the renderer,
        the step times and the launch counts of the run."""
        cfg = scenes.demo_config(n_worlds, mode, WIDTH, HEIGHT, dynamic=True,
                                 textured=textured, tex_size=TEX_SIZE)
        reset_counts()
        t0 = time.perf_counter()
        r = m.MadronaRenderer(0, n_worlds, mode, WIDTH, HEIGHT,
                              **scenes.renderer_kwargs(cfg))
        torch.cuda.synchronize()
        ctor_s = time.perf_counter() - t0
        pos = r.instance_position_tensor().to_torch()
        step_s, snaps = [], []
        for i in range(WARMUP_STEPS + timed_steps):
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
        counts = dict(rc.render_resident.variant_launches,
                      pack_rows=pack_cuda.pack_rows.launches)
        steps = 1 + WARMUP_STEPS + timed_steps
        name = rc.variant_name(mode == m.RenderMode.Rasterizer,
                               "nearest" if textured else None)
        expected = dict.fromkeys(rc.VARIANTS, 0)
        expected.update({name: steps, "pack_rows": steps})
        if counts != expected or rc.render_resident.launches != steps:
            raise AssertionError(f"{path}: launches {counts} in {steps} steps, "
                                 f"expected {expected}")
        for i, ((d0, c0), (d1, c1)) in enumerate(snaps):
            if torch.equal(d0[0], d1[0]):
                raise AssertionError(f"{path} step {i}: world 0's depth did not change "
                                     "after its mutation")
            if not (torch.equal(d0[1], d1[1]) and torch.equal(c0[1], c1[1])):
                raise AssertionError(f"{path} step {i}: world 1 changed without a mutation")
        return r, step_s, counts, ctor_s, name

    def full_size_checks(path, r, name):
        """The path's kernel on the last step's inputs reproduces the
        exported frames; K13 and the kernel equal their plain versions at
        full size."""
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer
        near = r.cfg.raster_near_plane if raster else r.cfg.near_plane
        kw = rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH, near=near,
                            raster=raster, texture_filter=r.cfg.texture_filter)
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
        check_pack(path, r.state, r.scene)
        check_render(path, kw)
        return kw

    def time_path(path, r, step_s, counts, ctor_s, n_worlds, extra):
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer

        def prologue():
            return rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH,
                                  raster=raster,
                                  near=r.cfg.raster_near_plane if raster else r.cfg.near_plane,
                                  texture_filter=r.cfg.texture_filter)

        step_ms = statistics.median(step_s) * 1e3
        emit({"phase": path, "card": card, "nvidia_smi": smi,
              "worlds": n_worlds, "height": HEIGHT, "width": WIDTH,
              "mode": "rasterizer" if raster else "raytracer",
              "textured": rc.is_textured(r.scene), "ctor_s": ctor_s,
              "steps_timed": len(step_s), "step_ms_median": step_ms,
              "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
              "frames_per_s": n_worlds / (step_ms / 1e3),
              "prologue_ms": host_ms(prologue, TIMED_STEPS),
              "prologue_torch_ops": count_torch_ops(prologue),
              "launches": counts, **extra,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    # Per kernel name: (inputs for its timing, launches on the paths).
    timing_kw, launches = {}, dict.fromkeys(rc.VARIANTS + ("pack_rows",), 0)

    # main: untextured raytrace, 4096 worlds.
    r, step_s, counts, ctor_s, name = drive("main", m.RenderMode.Raytracer,
                                            NUM_WORLDS, False, TIMED_STEPS)
    seg = r.segmask_tensor().to_torch()
    if set(torch.unique(seg).tolist()) != {-1, 0, 1}:
        raise AssertionError(f"main: segmask values {torch.unique(seg).tolist()}")
    kw = full_size_checks("main", r, name)
    timing_kw[name] = kw
    timing_kw["pack_rows"] = (r.state, r.scene)
    # The raster variant of the untextured scene runs on no path: it is held
    # to its plain version and timed on the main path's inputs.
    kw_raster = rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH,
                               near=r.cfg.raster_near_plane, raster=True)
    check_render("main_inputs", kw_raster)
    timing_kw[rc.variant_name(True, None)] = kw_raster
    time_path("main", r, step_s, counts, ctor_s, NUM_WORLDS, {})
    for k, v in counts.items():
        launches[k] += v
    del r

    # textured_4096w: the 32x32 PNG checkerboard, nearest filtering.
    r, step_s, counts, ctor_s, name = drive("textured_4096w", m.RenderMode.Raytracer,
                                            NUM_WORLDS, True, TIMED_STEPS)
    kw = full_size_checks("textured_4096w", r, name)
    timing_kw[name] = kw
    kw_bilinear = rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH,
                                 texture_filter="bilinear")
    check_render("textured_4096w_inputs", kw_bilinear)
    timing_kw[rc.variant_name(False, "bilinear")] = kw_bilinear
    rgb = r.rgb_tensor().to_torch()[..., :3].reshape(-1, 3)
    n_colours = int(torch.unique(rgb, dim=0).shape[0])
    if n_colours < 8:
        raise AssertionError(f"textured_4096w: only {n_colours} colours: no texture shows")
    time_path("textured_4096w", r, step_s, counts, ctor_s, NUM_WORLDS,
              {"distinct_colours": n_colours})
    for k, v in counts.items():
        launches[k] += v
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
    kw = full_size_checks("raster_256w_png", r, name)
    timing_kw[name] = kw
    kw_bilinear = rc.pack_inputs(r.state, r.scene, height=HEIGHT, width=WIDTH,
                                 near=r.cfg.raster_near_plane, raster=True,
                                 texture_filter="bilinear")
    check_render("raster_256w_png_inputs", kw_bilinear)
    timing_kw[rc.variant_name(True, "bilinear")] = kw_bilinear
    time_path("raster_256w_png", r, step_s, counts, ctor_s, RASTER_WORLDS, {})
    for k, v in counts.items():
        launches[k] += v
    del r

    # ---- timings of every kernel at its path's full-size inputs --------- #
    rows = []
    state, scene = timing_kw.pop("pack_rows")
    cam = state.camera_pos[:, 0, :].contiguous()
    bound_ms, bound_by, nbytes, ops = k13_bound(state, scene)
    rows.append({
        "name": "pack_rows", "route": "cuda",
        "source": "madrona_renderer_tpu_torch/csrc/pack_rows.cu",
        "replaces": "madrona_renderer_tpu/ops/pack_pallas.py:374",
        "launches": launches["pack_rows"], "max_abs_err": max_err["pack_rows"],
        "ms": graph_ms(lambda: pack_cuda.pack_rows(state, scene, cam), KERNEL_REPS),
        "wrapper_ms": cuda_ms(lambda: pack_cuda.pack_rows(state, scene, cam), KERNEL_REPS),
        "plain_ms": cuda_ms(lambda: rc._pack_rows_planar(state, scene, cam), 10),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "worlds": int(state.instance_obj.shape[0]), "bytes": nbytes, "ops": ops,
    })
    for name in rc.VARIANTS:
        kw = timing_kw[name]
        visits = k1_triangle_tests(kw)
        bound_ms, bound_by, nbytes, ops = k1_bound(kw, visits)
        rows.append({
            "name": name, "route": "cuda",
            "source": "madrona_renderer_tpu_torch/csrc/render_resident.cu",
            "replaces": "madrona_renderer_tpu/ops/raytrace_pallas.py:4872",
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": graph_ms(lambda: rc.render_resident(**kw), KERNEL_REPS),
            "wrapper_ms": cuda_ms(lambda: rc.render_resident(**kw), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: rc.render_resident_plain(**kw), 2),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "worlds": int(kw["rows"].shape[0]), "triangle_visits": visits,
            "bytes": nbytes, "ops": ops,
        })
        emit({"phase": "timing", **rows[-1]})
    emit({"phase": "timing", **rows[0]})

    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
