"""Where K1's and K6's time goes (the resident index order on prep rows),
measured on the card, in the parent design and on the index visit's tile
groups:

    python3 port_tools/index_phase_probe.py

Builds, under build/phase_probe/, a clock64 span variant of
csrc/render_resident.cu, in a translation unit of its own, never on the
main path: the source's MRT_INDEX hooks (render_body's index branch, the
parent design) and MRT_PHASE hooks (visit_body, the tile teams), empty in
the port's own build, mark the phases. It also builds the same source
without the marks (its kernels are the port's), with a function that reads
the parent entry's attributes and occupancy.

For K1 on main's inputs (4096 worlds of the demo scene at 64x64) and
mxu_4096w_128's under "auto" (128x128), and K6 on textured_4096w's (the
32x32 checker, nearest) and textured_4096w_ssaa2's (the same at 128x128),
each the scene's first step, it prints one JSON line per design (the
parent, plan 0; the default plan, index_plan's):
  ms               the kernel's device time (CUDA events, 5 launches);
  ms_spans         the span variant's (what the marks cost);
  fill_only_ms     the span variant stopped after its fill, at the same
                   grid and block;
  phases           per 16x16 tile, the cycles of each tile team's first
                   thread (a team: 64 threads; the parent's 16x16 block
                   counts as four teams walking the same tile, their sum
                   divided by four) in: fill (the
                   block's fill), gates (the slab votes and their
                   barriers), tests (the triangle tests of the visited
                   clusters), pixel (ray generation, resolve, texel fetch,
                   shading, write), fetch (taking the next tiles), and each
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

PHASES = rpp.PHASES
N_BLOCKS = 1 << 19  # the parent's blocks at 4096 views of 128x128: 262,144
TEAM = 64  # threads of a tile team (4 pixels a thread)
SLOTS = 256  # counters each phase's cycles are spread over
# name: (view size, textured, ssaa)
CASES = {
    "main": (64, False, 1),
    "mxu_4096w_128_auto": (128, False, 1),
    "textured_4096w": (64, True, 1),
    "textured_4096w_ssaa2": (64, True, 2),
}
WORLDS = 4096

INDEX_HOOKS = ("#define MRT_INDEX_BEGIN MRT_PHASE_BEGIN\n#define MRT_INDEX(k) MRT_PHASE(k)\n"
               "#define MRT_INDEX_AFTER_FILL MRT_AFTER_FILL\n")
TAIL = r"""
extern "C" {
int mrt_probe_parent_occupancy(int tex, size_t smem, int* out) {
  auto kernel = render_resident_kernel<0, false, 0>;
  if (tex == 1) kernel = render_resident_kernel<0, false, 1>;
  if (tex == 2) kernel = render_resident_kernel<0, false, 2>;
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
#ifdef MRT_SPANS
int mrt_probe_spans(int fill_only, unsigned long long* span, unsigned long long* block,
                    int n_blocks, int reset) {
  int err;
  if (reset) {
    static unsigned long long zero[5 * SPAN_SLOTS];
    static unsigned long long zeros[2][N_BLOCKS];
    err = (int)cudaMemcpyToSymbol(g_mrt_span, zero, sizeof(zero));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_block, zeros, sizeof(zeros));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_fill_only, &fill_only, sizeof(int));
    return err ? err : (int)cudaDeviceSynchronize();
  }
  err = (int)cudaMemcpyFromSymbol(span, g_mrt_span, 5 * SPAN_SLOTS * sizeof(unsigned long long));
  for (int k = 0; k < 2 && !err; ++k)
    err = (int)cudaMemcpyFromSymbol(block + (size_t)k * n_blocks, g_mrt_block,
                                    n_blocks * sizeof(unsigned long long),
                                    (size_t)k * sizeof(g_mrt_block[0]));
  return err;
}
#endif
}
""".replace("N_BLOCKS", str(N_BLOCKS)).replace("SPAN_SLOTS", str(SLOTS))


def spans_head() -> str:
    """resident_phase_probe's span hooks with a walker's first thread a
    64-thread team's (16 of them a block at most), room for N_BLOCKS blocks,
    and the phase sums spread over SLOTS counters (by block) so that the
    walkers' atomics at their end do not queue on five addresses."""
    head = rpp.SPANS_HEAD.replace("1 << 17", str(N_BLOCKS))
    reps = (("__device__ unsigned long long g_mrt_span[5];",
             "__device__ unsigned long long g_mrt_span[5 * SLOTS];"),
            ("atomicAdd(&g_mrt_span[k],", "atomicAdd(&g_mrt_span[(mrt_block() % SLOTS) * 5 + k],"),
            ("return threadIdx.x == 0 && threadIdx.y % 16 == 0;",
             "return (threadIdx.y * blockDim.x + threadIdx.x) % TEAM == 0;"),
            ("const int g = threadIdx.y / 16;",
             "const int g = (threadIdx.y * blockDim.x + threadIdx.x) / TEAM;"),
            ("mrt_acc[4][5]", "mrt_acc[16][5]"), ("mrt_last[4]", "mrt_last[16]"),
            ("mrt_cur[4]", "mrt_cur[16]"))
    for a, b in reps:
        if a not in head:
            raise RuntimeError(f"resident_phase_probe's span head lacks {a!r}")
        head = head.replace(a, b.replace("TEAM", str(TEAM)).replace("SLOTS", str(SLOTS)))
    return head + INDEX_HOOKS


def build(csrc: Path, spans: bool, out: Path) -> Path:
    from madrona_renderer_tpu_torch import _build

    tu = out / f"render_resident_{'spans' if spans else 'plain'}.cu"
    head = spans_head() if spans else ""
    tu.write_text(head + f'#include "{csrc / "render_resident"}.cu"\n' + TAIL)
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
    with ThreadPoolExecutor(2) as pool:
        plain, spans = pool.map(lambda s: ctypes.CDLL(str(build(csrc, s, out))), (False, True))
    print(json.dumps({"phase": "probe_build"}), flush=True)
    name = "render_resident"
    real_plan = rc.index_plan
    designs = {"parent": 0, "default": None}

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

    def through(lib, kw, groups):
        """``render_resident(**kw)`` with K1's library taken from ``lib``, on
        the parent design (``groups`` 0) or the default plan (None)."""
        fn = rpp.bound(lib, name)
        real = rc._build
        rc._build = types.SimpleNamespace(load=lambda n, *a: fn if n == name else real.load(n))
        if groups == 0:
            rc.index_plan = lambda *a, **k: real_plan(*a, **dict(k, groups=0))
        try:
            return rc.render_resident(**kw)
        finally:
            rc._build = real
            rc.index_plan = real_plan

    probe = spans.mrt_probe_spans
    probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int]
    clock_mhz = []
    for path, (res, textured, ssaa) in CASES.items():
        r = m.Manager(scenes.demo_config(WORLDS, m.RenderMode.Raytracer, res, res,
                                         dynamic=True, textured=textured, tex_size=32,
                                         ssaa=ssaa))
        h = res * ssaa
        kw = rc.pack_inputs(r.state, r.scene, height=h, width=h)
        if rc.route_of(kw["order"], kw["spans"], kw["bins"]) != rc.INDEX or kw["geo"] != "prep":
            raise AssertionError(f"{path}: not K1's index order on prep rows")
        views = int(kw["cams"].shape[0])
        tiles = (-(-h // 16)) ** 2
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
        for design, groups in designs.items():
            line = {"phase": "index_phase_probe", "kernel": "K6" if textured else "K1",
                    "inputs": path, "design": design}
            if groups is None:
                plan = real_plan(kw["geo"], S, CC, kw["n_lights"], views, h, h, kw["texture"])
                line["plan"] = plan._asdict()
            line["ms"] = events_ms(lambda: through(plain, kw, groups))
            for fill_only in (1, 0):
                if probe(fill_only, None, None, 0, 1):
                    raise RuntimeError("probe reset failed")
                t = events_ms(lambda: through(spans, kw, groups))
                line["fill_only_ms" if fill_only else "ms_spans"] = t
            # One launch's spans; the SM clock under load, sampled while ten
            # launches run.
            if probe(0, None, None, 0, 1):
                raise RuntimeError("probe reset failed")
            through(spans, kw, groups)
            torch.cuda.synchronize()
            for _ in range(10):
                through(plain, kw, groups)
            clock_mhz.append(rpp.smi("clocks.sm"))
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (2 * N_BLOCKS))()
            slots = (ctypes.c_ulonglong * (5 * SLOTS))()
            if probe(0, slots, buf, N_BLOCKS, 0):
                raise RuntimeError("probe read failed")
            span = [sum(slots[s * 5 + k] for s in range(SLOTS)) for k in range(5)]
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
            if groups == 0:
                smem = 4 * (10 * S + 8 * CC + int(kw["cams"].shape[1]))
                err = plain.mrt_probe_parent_occupancy(int(textured), ctypes.c_size_t(smem), occ)
            else:
                smem = plan.smem_bytes
                fn = plain.mrt_render_resident_occupancy
                fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
                err = fn(int(textured), plan.groups, S, CC, int(kw["cams"].shape[1]), occ)
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
