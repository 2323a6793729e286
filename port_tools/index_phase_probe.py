"""Where the resident index order's time goes (K1 and K6 on prep rows, K7
folded with its mip sample, K1's 9-output mode, K1-raw, K8 with its shadow
rays, K10's watertight decision, K1-none without a cluster table, and K2
and K2+K6 in the raster conventions), measured on the card, in the parent
design and on the index visit's tile groups:

    python3 port_tools/index_phase_probe.py [--parent] [CASE ...]

e.g. the raster entry's splits: ``python3 port_tools/index_phase_probe.py
raster_256w_png raster_256w_png_bilinear main_raster``.

Builds, under build/phase_probe/, a clock64 span variant of
csrc/render_resident.cu, csrc/render_mip.cu (K7 folded) and
csrc/render_none.cu (K1-none, K1's 9-output mode), each in a translation
unit of its own, never on the main path: the sources' MRT_INDEX hooks (render_body's index
branch and shadow sweep, the parent design) and MRT_PHASE hooks
(visit_body, the tile teams), empty in the port's own build, mark the
phases. It also builds the same sources without the marks (their kernels
are the port's), with a function that reads the parent entry's attributes
and occupancy. With --parent, the parent design alone.

For K1 on main's inputs (4096 worlds of the demo scene at 64x64) and
mxu_4096w_128's under "auto" (128x128), K6 on textured_4096w's (the 32x32
checker, nearest) and textured_4096w_ssaa2's (the same at 128x128), K7 on
textured256_4096w's (chip_smoke.py's paged-texture scene with its mip
chains, nearest; the parent design is the hand-off, whose split this is,
then csrc/shade_mip.cu, counted in its ms), K8 on shadows_4096w's (the
demo scene with shadows), K10 on watertight_4096w's (the 32x32 checker,
nearest, watertight), K1-none on none_4096w's (the demo scene under
accel="none"), K1's 9-output mode on tex256_cliff_4096w's (the
paged-texture scene baked without mips: a 131,072-texel pool), K1-raw on
multicam_1024w4c's (1024 worlds of the demo scene, 4 cameras each: 4096
views of raw rows), K2+K6 on raster_256w_png's (256 worlds of the 32x32
checker rasterized, nearest; raster_256w_png_bilinear its bilinear filter)
and K2 on main's rasterized (main_raster; near 0.001, ManagerConfig's
raster_near_plane), each the scene's first step (CASE names a subset),
it prints one JSON line per design (the parent, plan 0; the default plan,
index_plan's):
  ms               the kernel's device time (CUDA events, 5 launches);
  ms_spans         the span variant's (what the marks cost);
  fill_only_ms     the span variant stopped after its fill, at the same
                   grid and block;
  phases           per 16x16 tile, the cycles of each tile team's first
                   thread (a team: 64 threads; the parent's 16x16 block
                   counts as four teams walking the same tile, their sum
                   divided by four) in: fill (the
                   block's fill: K8's hoisted shadow terms among it),
                   gates (the slab votes and their barriers), tests (the
                   triangle tests of the visited clusters), pixel (ray
                   generation, resolve, texel fetch, shading, write; K7
                   folded: the held winners and the window keys), fetch
                   (taking the next tiles), shadow_gates and shadow_tests
                   (K8: the shadow rays' slab votes and any-hit tests),
                   sample (K7 folded: the view's sample pass), and each
                   phase's share; block_wall_us, a block's mean wall time;
  occupancy        the entry's threads a block, registers, local memory,
                   dynamic shared memory, and blocks and warps per SM;
then the card's name and power limit and its SM clock after the runs
(nvidia-smi), by which cycles become microseconds. Needs one card and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "port_tools"))

import resident_phase_probe as rpp  # noqa: E402

PHASES = rpp.PHASES + ("shadow_gates", "shadow_tests", "sample")
NP = len(PHASES)
N_BLOCKS = 1 << 19  # the parent's blocks at 4096 views of 128x128: 262,144
TEAM = 64  # threads of a tile team (4 pixels a thread)
SLOTS = 256  # counters each phase's cycles are spread over
# name: (view size, textured, ssaa)
CASES = {
    "main": (64, False, 1),
    "mxu_4096w_128_auto": (128, False, 1),
    "textured_4096w": (64, True, 1),
    "textured_4096w_ssaa2": (64, True, 2),
    "textured256_4096w": (64, "mip", 1),
    "shadows_4096w": (64, "shadows", 1),
    "watertight_4096w": (64, "watertight", 1),
    "none_4096w": (64, "none", 1),
    "tex256_cliff_4096w": (64, "nine", 1),
    "multicam_1024w4c": (64, "multicam", 1),
    "raster_256w_png": (64, "raster_nearest", 1),
    "raster_256w_png_bilinear": (64, "raster_bilinear", 1),
    "main_raster": (64, "raster", 1),
}
RASTER_WORLDS = 256
RASTER_NEAR = 0.001
MULTICAM_CAMS = 4
WORLDS = 4096

INDEX_HOOKS = ("#define MRT_INDEX_BEGIN MRT_PHASE_BEGIN\n#define MRT_INDEX(k) MRT_PHASE(k)\n"
               "#define MRT_INDEX_AFTER_FILL MRT_AFTER_FILL\n")
TAIL = r"""
extern "C" {
#ifndef MRT_RENDER_BODY_ONLY
int mrt_probe_parent_occupancy(int tex, size_t smem, int* out) {
  auto kernel = render_resident_kernel<0, false, 0>;
  if (tex == 1) kernel = render_resident_kernel<0, false, 1>;
  if (tex == 2) kernel = render_resident_kernel<0, false, 2>;
  if (tex == 3) kernel = render_resident_kernel<0, false, 3>;
  if (tex == 8) kernel = render_resident_kernel<2, false, 0>;
  if (tex == 9) kernel = render_resident_kernel<3, false, 0>;
  if (tex == 10) kernel = render_resident_kernel<3, false, 1>;
  if (tex == 12) kernel = render_resident_kernel<1, false, 0>;
  if (tex == 13) kernel = render_resident_kernel<0, true, 0>;
  if (tex == 14) kernel = render_resident_kernel<0, true, 1>;
  if (tex == 15) kernel = render_resident_kernel<0, true, 2>;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          attr.maxThreadsPerBlock, smem);
  out[0] = 256;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  return err;
}
#elif defined(MRT_PROBE_NONE)
int mrt_probe_parent_occupancy(int tex, size_t smem, int* out) {
  auto kernel = render_none_kernel<0, false, 0>;
  if (tex == 9) kernel = render_none_kernel<3, false, 0>;
  if (tex == 10) kernel = render_none_kernel<3, false, 1>;
  if (tex == 11) kernel = render_resident_nine_kernel<0, false>;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          attr.maxThreadsPerBlock, smem);
  out[0] = 256;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = blocks;
  return err;
}
#endif
#ifdef MRT_SPANS
int mrt_probe_spans(int fill_only, unsigned long long* span, unsigned long long* block,
                    int n_blocks, int reset) {
  int err;
  if (reset) {
    static unsigned long long zero[NP * SPAN_SLOTS];
    static unsigned long long zeros[2][N_BLOCKS];
    err = (int)cudaMemcpyToSymbol(g_mrt_span, zero, sizeof(zero));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_block, zeros, sizeof(zeros));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_fill_only, &fill_only, sizeof(int));
    return err ? err : (int)cudaDeviceSynchronize();
  }
  err = (int)cudaMemcpyFromSymbol(span, g_mrt_span, NP * SPAN_SLOTS * sizeof(unsigned long long));
  for (int k = 0; k < 2 && !err; ++k)
    err = (int)cudaMemcpyFromSymbol(block + (size_t)k * n_blocks, g_mrt_block,
                                    n_blocks * sizeof(unsigned long long),
                                    (size_t)k * sizeof(g_mrt_block[0]));
  return err;
}
#endif
}
""".replace("N_BLOCKS", str(N_BLOCKS)).replace("SPAN_SLOTS", str(SLOTS)).replace("NP", str(NP))


def spans_head() -> str:
    """resident_phase_probe's span hooks with a walker's first thread a
    64-thread team's (16 of them a block at most), room for N_BLOCKS blocks,
    and the phase sums spread over SLOTS counters (by block) so that the
    walkers' atomics at their end do not queue on five addresses."""
    head = rpp.SPANS_HEAD.replace("1 << 17", str(N_BLOCKS))
    reps = (("__device__ unsigned long long g_mrt_span[5];",
             "__device__ unsigned long long g_mrt_span[NP * SLOTS];"),
            ("atomicAdd(&g_mrt_span[k],", "atomicAdd(&g_mrt_span[(mrt_block() % SLOTS) * NP + k],"),
            ("for (int k = 0; k < 5; ++k) mrt_acc[g][k] = 0;",
             "for (int k = 0; k < NP; ++k) mrt_acc[g][k] = 0;"),
            ("for (int k = 0; k < 5; ++k) atomicAdd", "for (int k = 0; k < NP; ++k) atomicAdd"),
            ("return threadIdx.x == 0 && threadIdx.y % 16 == 0;",
             "return (threadIdx.y * blockDim.x + threadIdx.x) % TEAM == 0;"),
            ("const int g = threadIdx.y / 16;",
             "const int g = (threadIdx.y * blockDim.x + threadIdx.x) / TEAM;"),
            ("mrt_acc[4][5]", "mrt_acc[16][NP]"), ("mrt_last[4]", "mrt_last[16]"),
            ("mrt_cur[4]", "mrt_cur[16]"))
    for a, b in reps:
        if a not in head:
            raise RuntimeError(f"resident_phase_probe's span head lacks {a!r}")
        head = head.replace(a, b.replace("TEAM", str(TEAM)).replace("SLOTS", str(SLOTS))
                            .replace("NP", str(NP)))
    return head + INDEX_HOOKS


def build(csrc: Path, spans: bool, out: Path, name: str = "render_resident") -> Path:
    from madrona_renderer_tpu_torch import _build

    tu = out / f"{name}_{'spans' if spans else 'plain'}.cu"
    head = (spans_head() if spans else "") + (
        "#define MRT_PROBE_NONE\n" if name == "render_none" else "")
    tu.write_text(head + f'#include "{csrc / name}.cu"\n' + TAIL)
    lib = out / f"lib{tu.stem}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(["-DMRT_SPANS"] if spans else []),
           "-o", str(lib), str(tu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tu}:\n{proc.stderr[-3000:]}")
    return lib


def main() -> int:
    sys.path.insert(0, str(HERE))
    import torch

    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("index_phase_probe: no CUDA card", file=sys.stderr)
        return 1
    out = HERE / "build" / "phase_probe" / "index"
    out.mkdir(parents=True, exist_ok=True)
    csrc = HERE / "madrona_renderer_tpu_torch" / "csrc"
    libraries = ("render_resident", "render_mip", "render_none")
    jobs = [(n, sp) for n in libraries for sp in (False, True)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda job: ctypes.CDLL(str(build(csrc, job[1], out, job[0]))), jobs)))
    print(json.dumps({"phase": "probe_build"}), flush=True)
    real_plan = rc.index_plan
    args = sys.argv[1:]
    designs = {"parent": 0} if "--parent" in args else {"parent": 0, "default": None}
    cases = [a for a in args if a != "--parent"] or list(CASES)

    def events_ms(fn, reps=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def through(spans, kw, groups):
        """``render_resident(**kw)`` with the render libraries taken from the
        plain or span builds, on the parent design (``groups`` 0) or the
        default plan (None)."""
        fns = {n: rpp.bound(libs[(n, spans)], n) for n in libraries}
        real = rc._build
        rc._build = types.SimpleNamespace(load=lambda n, *a: fns[n] if n in fns else real.load(n))
        if groups == 0:
            rc.index_plan = lambda *a, **k: real_plan(*a, **dict(k, groups=0))
        try:
            return rc.render_resident(**kw)
        finally:
            rc._build = real
            rc.index_plan = real_plan

    def inputs(path, res, mode, ssaa):
        if mode in ("mip", "nine"):
            import chip_smoke
            from madrona_renderer_tpu_torch import config as cfg_mod
            cfg = chip_smoke.paged_tex_config(WORLDS, scenes, cfg_mod)
            r = m.MadronaRenderer(0, WORLDS, m.RenderMode.Raytracer, res, res,
                                  mipmaps="auto" if mode == "mip" else False,
                                  **scenes.renderer_kwargs(cfg))
            return r, rc.pack_inputs(r.state, r.scene, height=res, width=res,
                                     texture_filter="nearest")
        if mode in ("raster", "raster_nearest", "raster_bilinear"):
            filt = "bilinear" if mode == "raster_bilinear" else "nearest"
            r = m.Manager(scenes.demo_config(WORLDS if mode == "raster" else RASTER_WORLDS,
                                             m.RenderMode.Rasterizer, res, res, dynamic=True,
                                             textured=mode != "raster", tex_size=32,
                                             texture_filter=filt))
            return r, rc.pack_inputs(r.state, r.scene, height=res, width=res, raster=True,
                                     near=RASTER_NEAR, texture_filter=filt)
        if mode == "multicam":
            r = m.Manager(scenes.demo_config(WORLDS // MULTICAM_CAMS, m.RenderMode.Raytracer, res,
                                             res, dynamic=True, num_cams=MULTICAM_CAMS))
            return r, rc.pack_inputs(r.state, r.scene, height=res, width=res)
        shadows, watertight = mode == "shadows", mode == "watertight"
        r = m.Manager(scenes.demo_config(WORLDS, m.RenderMode.Raytracer, res, res,
                                         dynamic=mode != "none",
                                         textured=mode is True or watertight, tex_size=32,
                                         ssaa=ssaa, shadows=shadows))
        h = res * ssaa
        return r, rc.pack_inputs(r.state, r.scene, height=h, width=h, shadows=shadows,
                                 watertight=watertight, accel="none" if mode == "none" else "auto")

    shade_codes = {None: 0, "nearest": 1, "bilinear": 2}
    clock_mhz = []
    for path in cases:
        res, mode, ssaa = CASES[path]
        r, kw = inputs(path, res, mode, ssaa)
        h = res * ssaa
        mip = kw.get("fb_rows") is not None
        culled = kw["clusters"] is not None
        if rc.route_of(kw["order"], kw["spans"], kw["bins"], culled) not in (rc.INDEX, rc.NONE):
            raise AssertionError(f"{path}: not the resident index order")
        kernel = ("K7" if mip else "K8" if kw["geo"] == "raw_shadows" else
                  ("K2+K6" if kw["texture"] else "K2") if kw["raster"] else
                  "K1-none" if not culled else "K10" if kw["geo"] == "raw_wt" else
                  "K1 9-output" if kw["texture"] == "nine" else
                  "K1-raw" if kw["geo"] == "raw" else "K6" if mode else "K1")
        texture = "mip" if mip else kw["texture"]
        views = int(kw["cams"].shape[0])
        tiles = (-(-h // 16)) ** 2
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2]) if culled else 0
        cols = int(kw["cams"].shape[1])
        for design, groups in designs.items():
            line = {"phase": "index_phase_probe", "kernel": kernel, "inputs": path,
                    "design": design}
            plan = real_plan(kw["geo"], S, CC, kw["n_lights"], views, h, h, texture,
                             raster=kw["raster"], culled=culled)
            if groups is None:
                line["plan"] = plan._asdict()
            folded = mip and groups is None and plan.groups > 0
            name = ("render_mip" if folded else "render_resident"
                    if culled and texture != "nine" else "render_none")
            probe = libs[(name, True)].mrt_probe_spans
            probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int]
            line["ms"] = events_ms(lambda: through(False, kw, groups))
            for fill_only in (1, 0):
                if probe(fill_only, None, None, 0, 1):
                    raise RuntimeError("probe reset failed")
                t = events_ms(lambda: through(True, kw, groups))
                line["fill_only_ms" if fill_only else "ms_spans"] = t
            # One launch's spans; the SM clock under load, sampled while ten
            # launches run.
            if probe(0, None, None, 0, 1):
                raise RuntimeError("probe reset failed")
            through(True, kw, groups)
            torch.cuda.synchronize()
            for _ in range(10):
                through(False, kw, groups)
            clock_mhz.append(rpp.smi("clocks.sm"))
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (2 * N_BLOCKS))()
            slots = (ctypes.c_ulonglong * (NP * SLOTS))()
            if probe(0, slots, buf, N_BLOCKS, 0):
                raise RuntimeError("probe read failed")
            span = [sum(slots[s * NP + k] for s in range(SLOTS)) for k in range(NP)]
            start = torch.tensor(list(buf[:N_BLOCKS]), dtype=torch.float64)
            end = torch.tensor(list(buf[N_BLOCKS:]), dtype=torch.float64)
            used = end > 0
            mhz = float(clock_mhz[-1].split()[0])
            total = sum(span)
            walkers = 256 // TEAM if groups == 0 else 1  # leaders a tile visit has
            line["phases"] = {
                "cycles_per_tile": {p: span[k] / (views * tiles * walkers)
                                    for k, p in enumerate(PHASES)},
                "share": {p: span[k] / total for k, p in enumerate(PHASES)},
                "blocks": int(used.sum()),
                "block_wall_us": float((end[used] - start[used]).mean()) / mhz}
            occ = (ctypes.c_int * 4)()
            plain = libs[(name, False)]
            if groups == 0:
                rows = rc._VISIT_GEO_ROWS[kw["geo"]]
                smem = 4 * (rows * S + 8 * CC + cols)
                code = (8 if kernel == "K8" else 3 if mip else 11 if texture == "nine" else
                        12 if kernel == "K1-raw" else
                        13 + shade_codes[kw["texture"]] if kw["raster"] else
                        9 + (kw["texture"] is not None) if kw["geo"] == "raw_wt" else
                        int(mode is True))
                err = plain.mrt_probe_parent_occupancy(code, ctypes.c_size_t(smem), occ)
            elif folded:
                smem = plan.smem_bytes
                fn = plain.mrt_render_mip_occupancy
                fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
                err = fn(0, plan.groups, S, CC, cols, kw["n_lights"], h, h,
                         rc.mips.tile_geometry(h, h)[2], occ)
            elif texture == "nine":
                smem = plan.smem_bytes
                fn = plain.mrt_render_none_nine_occupancy
                fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
                err = fn(rc._GEO_CODES[kw["geo"]], plan.groups, S, CC, cols, kw["n_lights"], occ)
            elif not culled:
                smem = plan.smem_bytes
                fn = plain.mrt_render_none_occupancy
                fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
                err = fn(rc._GEO_CODES[kw["geo"]], rc._TEX_CODES[texture], plan.groups, S,
                         cols, kw["n_lights"], occ)
            else:
                smem = plan.smem_bytes
                fn = plain.mrt_render_resident_occupancy
                fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
                err = fn(rc._GEO_CODES[kw["geo"]], int(kw["raster"]), rc._TEX_CODES[texture],
                         plan.groups, S, CC, cols, kw["n_lights"], occ)
            if err:
                raise RuntimeError(f"occupancy query failed: {err}")
            threads, regs, local, blocks = list(occ)
            line["occupancy"] = {"threads": threads, "registers": regs, "local_bytes": local,
                                 "dynamic_smem": smem, "blocks_per_sm": blocks,
                                 "warps_per_sm": blocks * threads // 32}
            print(json.dumps(line), flush=True)
        del r, kw
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": rpp.smi("name,power.limit"),
                      "clocks_sm_after_runs": clock_mhz}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
