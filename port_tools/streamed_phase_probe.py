"""Where the streamed ordered walk's time (K3 + K5) goes, measured on the card:

    python3 port_tools/streamed_phase_probe.py [CHECKOUT] [--kernels K5|K11]

Builds, under build/phase_probe/, a clock64 span variant of CHECKOUT's
streamed ordered entry (default: this tree; e.g. the parent commit unpacked
with `git archive` under a directory that .gitignore lists), in a
translation unit of its own, never on the main path: csrc/render_streamed.cu's
MRT_PHASE hooks (empty in the port's own build) mark the phases, or, in a
tree whose streamed ordered walk is csrc/render_resident.cu's render_body,
the probe patches the same marks into a copy of it (LEGACY_MARKS). It also
builds the same source without the marks (its kernels are the port's), with
a function that reads the entry's attributes and occupancy.

For K5 on bigmesh_512w's inputs (512 worlds of the 72-grid terrain at
64x64), on the binned terrain's at 128x128 under accel="clusters" (32
worlds of the 224-grid terrain, 3,136 clusters a world: binned_32w_128's
A/B), and with shadow rays (K8's sweep, raw rows) on 64 worlds of
bigmesh_512w's scene, it prints one JSON line each:
  ms               the kernel's device time (CUDA events, 5 launches);
  ms_spans         the span variant's (what the marks cost);
  fill_only_ms     the span variant stopped after its fill, at the same
                   grid and block;
  phases           per 16x16 tile, the cycles of each tile walker's first
                   thread (a tile group's thread 0, or the 16x16 block's)
                   in: fill (the block's fill of the cluster table, order
                   and spans, or of the view's positions, shared by the
                   block's tiles), gates (the exit, row and slab gates and
                   their barriers, the copies' issue), stage (the wait for
                   a visited cluster's rows, the raw rows' hoist and their
                   barriers), tests (the triangle tests), pixel (ray
                   generation, resolve, shade, write), fetch (taking the
                   next tile), and each phase's share; block_wall_us, a
                   block's mean wall time;
  occupancy        the entry's threads a block, registers, local memory,
                   shared memory, and blocks and warps per SM
                   (cudaOccupancyMaxActiveBlocksPerMultiprocessor; a tree
                   with raytrace_cuda.streamed_occupancy reports its own
                   plan's, with its tile groups and blocks a view);

For K11 on the ordered walk (csrc/render_dmxu.cu) on bigmesh_512w_dmxu's
inputs (bigmesh_512w with deferred_mxu=True: 64x64, no row gate) and with
its row gate on 64 worlds of chip_smoke.py's varied big-mesh terrain at
64x256, it prints the same keys for each design the tree has: render_body's
16x16 blocks (the parent design, "groups": 0; the probe patches
LEGACY_MARKS and DMXU_MARKS into a copy of csrc/render_resident.cu) and, in
a tree whose K11 takes the ordered walk's tile groups, those ("groups": the
plan's); the occupancy of the tile groups' entry from
raytrace_cuda.streamed_occupancy.
--kernels K5 or K11 runs only that kernel's cases.

Then the card's name and power limit and its SM clock after the runs
(nvidia-smi), by which cycles become microseconds. Needs one card and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PHASES = ("fill", "gates", "stage", "tests", "pixel", "fetch")
CASES = (("K5", "bigmesh_512w", 512, 64, "auto", False),
         ("K5", "binned_32w_128 (accel clusters)", 32, 128, "clusters", False),
         ("K5 + K8", "bigmesh_64w_shadows", 64, 64, "auto", True))
# K11 on the ordered walk: (kernel, inputs, worlds, height, width, varied:
# chip_smoke.py's bigmesh_scene with vary=True instead of bigmesh_config).
DMXU_CASES = (("K11", "bigmesh_512w_dmxu", 512, 64, 64, False),
              ("K11 row gate", "bigmesh_64w_64x256", 64, 64, 256, True))

# The marks of a tree whose streamed ordered walk is render_body's: (anchor,
# replacement) in csrc/render_resident.cu, each anchor found exactly once.
LEGACY_MARKS = (
    ("  extern __shared__ __align__(16) float smem[];\n  // Resident:",
     "  extern __shared__ __align__(16) float smem[];\n  MRT_PHASE_BEGIN;\n  // Resident:"),
    ("  __syncthreads();\n\n  const int tile = blockIdx.y;",
     "  __syncthreads();\n  MRT_AFTER_FILL;\n  MRT_PHASE(4);\n\n  const int tile = blockIdx.y;"),
    ("    auto gate = [&](int p) {\n      const int c = s_order[p];",
     "    auto gate = [&](int p) {\n      MRT_PHASE(1);\n      const int c = s_order[p];"),
    ("    int nxt = next(pos + 1);\n", "    int nxt = next(pos + 1);\n    MRT_PHASE(2);\n"),
    ("      for (int k = 0; k < cnt; ++k) {\n        if constexpr (WT) {\n"
     "          // K10's decision; the lower index wins an exact tie.",
     "      MRT_PHASE(3);\n      for (int k = 0; k < cnt; ++k) {\n        if constexpr (WT) {\n"
     "          // K10's decision; the lower index wins an exact tie."),
    ("  const bool inside = px < a.width && py < a.height;\n  // The shadow sweep below has "
     "block-wide",
     "  MRT_PHASE(4);\n  const bool inside = px < a.width && py < a.height;\n"
     "  // The shadow sweep below has block-wide"),
    ("        auto gate_sh = [&](int c) {\n          float tmin, tmax;",
     "        auto gate_sh = [&](int c) {\n          MRT_PHASE(1);\n          float tmin, tmax;"),
    ("        auto visit_sh = [&](int c, float* buf) {\n",
     "        auto visit_sh = [&](int c, float* buf) {\n          MRT_PHASE(3);\n"),
    ("    if (!inside) return;\n  }\n\n  // Base colour. A miss",
     "    MRT_PHASE(4);\n    if (!inside) return;\n  }\n\n  // Base colour. A miss"),
)

# The sweep mark of render_body's K11 sweep (the parent design of K11 on the
# ordered walk), beside LEGACY_MARKS' gates and stage waits.
DMXU_MARKS = (
    ("        // Row skip (:1915-1990): the cluster's rows miss the warp's.\n",
     "        MRT_PHASE(3);\n        // Row skip (:1915-1990): the cluster's rows miss the warp's.\n"),
)

# The span variant's definitions of the hooks. A tile walker's first thread
# (threadIdx.x == 0 and threadIdx.y a multiple of 16) accumulates the
# cycles of the phase it is in; the block's first thread stamps the block's
# start, every walker its end.
SPANS_HEAD = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ unsigned long long g_mrt_span[6];
__device__ unsigned long long g_mrt_block[2][1 << 17];
__device__ int g_mrt_fill_only;
__device__ float g_mrt_sink[1 << 17];
__shared__ long long mrt_acc[4][6];
__shared__ long long mrt_last[4];
__shared__ int mrt_cur[4];
__device__ __forceinline__ bool mrt_leader() {
  return threadIdx.x == 0 && threadIdx.y % 16 == 0;
}
__device__ __forceinline__ unsigned mrt_block() {
  return blockIdx.x + blockIdx.y * gridDim.x;
}
__device__ __forceinline__ void mrt_phase(int k) {
  if (!mrt_leader()) return;
  const int g = threadIdx.y / 16;
  const long long now = clock64();
  mrt_acc[g][mrt_cur[g]] += now - mrt_last[g];
  mrt_last[g] = now;
  mrt_cur[g] = k;
}
struct MrtSpans {
  __device__ MrtSpans() {
    if (threadIdx.x == 0 && threadIdx.y == 0)
      g_mrt_block[0][mrt_block()] = (unsigned long long)clock64();
    if (!mrt_leader()) return;
    const int g = threadIdx.y / 16;
    for (int k = 0; k < 6; ++k) mrt_acc[g][k] = 0;
    mrt_cur[g] = 0;
    mrt_last[g] = clock64();
  }
  __device__ ~MrtSpans() {
    if (!mrt_leader()) return;
    mrt_phase(0);
    const int g = threadIdx.y / 16;
    for (int k = 0; k < 6; ++k) atomicAdd(&g_mrt_span[k], (unsigned long long)mrt_acc[g][k]);
    atomicMax(&g_mrt_block[1][mrt_block()], (unsigned long long)clock64());
  }
};
#define MRT_PHASE_BEGIN MrtSpans mrt_spans_
#define MRT_PHASE(k) mrt_phase(k)
#define MRT_AFTER_FILL                                                         \
  if (g_mrt_fill_only) {                                                       \
    if (threadIdx.x == 0 && threadIdx.y == 0) g_mrt_sink[mrt_block()] = smem[0]; \
    return;                                                                    \
  }
"""

# Appended to both builds: the entry's attributes and occupancy (the
# path's cold untextured entry, raytraced, on prep rows or, geo 2, raw rows
# with shadows, at `threads` a block), and in the span build the counters.
TAIL = r"""
extern "C" {
int mrt_probe_occupancy(size_t smem, int threads, int geo, int* out) {
  auto kernel = OCCUPANCY_KERNEL;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = blocks;
  return err;
}
#ifdef MRT_SPANS
int mrt_probe_spans(int fill_only, unsigned long long* span, unsigned long long* block,
                    int n_blocks, int reset) {
  int err;
  if (reset) {
    unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    static unsigned long long zeros[2][1 << 17];
    err = (int)cudaMemcpyToSymbol(g_mrt_span, zero, sizeof(zero));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_block, zeros, sizeof(zeros));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_fill_only, &fill_only, sizeof(int));
    return err ? err : (int)cudaDeviceSynchronize();
  }
  err = (int)cudaMemcpyFromSymbol(span, g_mrt_span, 6 * sizeof(unsigned long long));
  for (int k = 0; k < 2 && !err; ++k)
    err = (int)cudaMemcpyFromSymbol(block + (size_t)k * n_blocks, g_mrt_block,
                                    n_blocks * sizeof(unsigned long long),
                                    (size_t)k * sizeof(g_mrt_block[0]));
  return err;
}
#endif
}
"""


def probe_tree(root: Path, out: Path) -> tuple:
    """A copy of ``root``'s csrc under ``out`` with the hooks in place, and
    the library that holds its streamed ordered walk."""
    csrc = out / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(root / "madrona_renderer_tpu_torch" / "csrc", csrc)
    if (csrc / "render_streamed.cu").exists():
        return csrc, "render_streamed"
    body = csrc / "render_resident.cu"
    text = body.read_text()
    for anchor, repl in LEGACY_MARKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {body}: {anchor!r}")
        text = text.replace(anchor, repl)
    body.write_text("#ifndef MRT_PHASE\n#define MRT_PHASE_BEGIN\n#define MRT_PHASE(k)\n"
                    "#define MRT_AFTER_FILL\n#endif\n" + text)
    return csrc, "render_resident"


def dmxu_tree(root: Path, out: Path) -> Path:
    """A copy of ``root``'s csrc under ``out`` whose render_body carries the
    marks (LEGACY_MARKS, the first walk_clusters' stage mark, DMXU_MARKS),
    for K11's library (csrc/render_dmxu.cu): the parent design's 16x16
    blocks, and the tile groups' own marks where the tree has them."""
    csrc = out / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(root / "madrona_renderer_tpu_torch" / "csrc", csrc)
    body = csrc / "render_resident.cu"
    text = body.read_text()
    for anchor, repl in LEGACY_MARKS + DMXU_MARKS:
        if text.count(anchor) < 1:
            raise RuntimeError(f"anchor not found in {body}: {anchor!r}")
        if text.count(anchor) > 1 and anchor != "    int nxt = next(pos + 1);\n":
            raise RuntimeError(f"anchor found more than once in {body}: {anchor!r}")
        text = text.replace(anchor, repl, 1)  # walk_clusters' stage mark, not stream_walk's
    body.write_text("#ifndef MRT_PHASE\n#define MRT_PHASE_BEGIN\n#define MRT_PHASE(k)\n"
                    "#define MRT_AFTER_FILL\n#endif\n" + text)
    return csrc


def build(csrc: Path, name: str, spans: bool, out: Path) -> Path:
    from madrona_renderer_tpu_torch import _build

    tu = out / f"{name}_{'spans' if spans else 'plain'}.cu"
    # A tree whose walk is render_body's has an entry for every geo; the
    # tile groups' entries are prep's, raw's and K10's; K11's parent design
    # is render_body's.
    kernel = ("geo == 2 ? render_streamed_kernel<2, false, 0> : render_streamed_kernel<0, false, 0>"
              if name == "render_resident" else "render_streamed_dmxu_kernel<0, false, 0>"
              if name == "render_dmxu" else "render_streamed_kernel<0, false, 0>")
    tu.write_text((SPANS_HEAD if spans else "") + f'#include "{csrc / name}.cu"\n'
                  + TAIL.replace("OCCUPANCY_KERNEL", kernel))
    lib = out / f"lib{tu.stem}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(["-DMRT_SPANS"] if spans else []),
           "-o", str(lib), str(tu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tu}:\n{proc.stderr[-3000:]}")
    return lib


def bound(lib: ctypes.CDLL, name: str):
    """The library's launch function, bound as the port's loader binds it."""
    from madrona_renderer_tpu_torch import _build

    fn = getattr(lib, _build.SIGNATURES[name][0])
    fn.argtypes = _build.SIGNATURES[name][1]
    fn.restype = ctypes.c_int
    lib.mrt_error_string.argtypes = [ctypes.c_int]
    lib.mrt_error_string.restype = ctypes.c_char_p
    fn.error_string = lambda code: lib.mrt_error_string(code).decode()
    return fn


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def block_plan(kw) -> tuple:
    """(threads a block, dynamic shared memory) of a tree whose walk is
    render_body's: two stage buffers of the geo's rows, the cluster table,
    the camera row, the order and spans."""
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    rows = 10 if kw["geo"] == "prep" else 16
    return 256, 4 * (2 * rows * (S // CC) + 8 * CC + kw["cams"].shape[1]) + 12 * CC


def main() -> int:
    args = sys.argv[1:]
    only = None
    if "--kernels" in args:
        k = args.index("--kernels")
        only = args[k + 1]
        del args[k:k + 2]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))
    import torch

    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("streamed_phase_probe: no CUDA card", file=sys.stderr)
        return 1
    if not Path(m.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {m.__file__}, not the port of {root}")
    out = HERE / "build" / "phase_probe" / f"streamed_{root.name}"
    out.mkdir(parents=True, exist_ok=True)
    csrc, name = probe_tree(root, out)
    dmxu_out = out / "dmxu"
    dmxu_out.mkdir(parents=True, exist_ok=True)
    dmxu_csrc = dmxu_tree(root, dmxu_out)
    jobs = [(csrc, name, s, out) for s in (False, True) if only != "K11"]
    jobs += [(dmxu_csrc, "render_dmxu", s, dmxu_out) for s in (False, True) if only != "K5"]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip([(j[1], j[2]) for j in jobs],
                        pool.map(lambda j: ctypes.CDLL(str(build(*j))), jobs)))
    plain, spans = libs.get((name, False)), libs.get((name, True))
    print(json.dumps({"phase": "probe_build", "tree": str(root), "library": name}), flush=True)

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

    def through(lib, kw):
        """``render_resident(**kw)`` with ``name``'s library taken from ``lib``."""
        fn = bound(lib, name)
        real = rc._build
        rc._build = types.SimpleNamespace(load=lambda n, *a: fn if n == name else real.load(n))
        try:
            return rc.render_resident(**kw)
        finally:
            rc._build = real

    clock_mhz = []

    def spans_of(lib, fn, line, views, tiles):
        """``line``'s ms_spans, fill_only_ms and phases from ``lib``'s span
        build launched by ``fn`` (after ``line["ms"]``)."""
        probe = lib.mrt_probe_spans
        probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int]
        n_blocks = 1 << 17
        buf = (ctypes.c_ulonglong * (2 * n_blocks))()
        span = (ctypes.c_ulonglong * 6)()
        for fill_only in (1, 0):
            if probe(fill_only, None, None, 0, 1):
                raise RuntimeError("probe reset failed")
            line["fill_only_ms" if fill_only else "ms_spans"] = events_ms(fn)
        if probe(0, None, None, 0, 1):
            raise RuntimeError("probe reset failed")
        fn()
        torch.cuda.synchronize()
        clock_mhz.append(smi("clocks.sm"))
        if probe(0, span, buf, n_blocks, 0):
            raise RuntimeError("probe read failed")
        start = torch.tensor(list(buf[:n_blocks]), dtype=torch.float64)
        end = torch.tensor(list(buf[n_blocks:]), dtype=torch.float64)
        used = end > 0
        mhz = float(clock_mhz[-1].split()[0])
        total = sum(span)
        line["phases"] = None if total == 0 else {
            "cycles_per_tile": {p: span[k] / (views * tiles) for k, p in enumerate(PHASES)},
            "share": {p: span[k] / total for k, p in enumerate(PHASES)},
            "blocks": int(used.sum()),
            "block_wall_us": float((end[used] - start[used]).mean()) / mhz}

    if only != "K5":
        dmxu_cases(m, rc, scenes, libs, events_ms, spans_of, root)
    for kernel, path, worlds, res, accel, shadows in (CASES if only != "K11" else ()):
        if accel == "auto":
            cfg = scenes.bigmesh_config(worlds, res, res)
        else:
            cfg = scenes.binned_terrain_config(worlds, res, res, accel=accel)
        r = m.Manager(cfg)
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, accel=accel,
                            shadows=shadows)
        route = rc.route_of(kw["order"], kw["spans"], kw["bins"])
        if route != rc.Route(True, "ordered") or rc.library_of(route, False) != name:
            raise AssertionError(f"{path}: not the streamed ordered walk of {name}")
        line = {"phase": "streamed_phase_probe", "kernel": kernel, "inputs": path,
                "tree": str(root), "library": name}
        line["ms"] = events_ms(lambda: through(plain, kw))
        views = kw["cams"].shape[0]
        tiles = (-(-res // 16)) ** 2
        probe = spans.mrt_probe_spans
        probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int]
        n_blocks = 1 << 17
        buf = (ctypes.c_ulonglong * (2 * n_blocks))()
        span = (ctypes.c_ulonglong * 6)()
        for fill_only in (1, 0):
            if probe(fill_only, None, None, 0, 1):
                raise RuntimeError("probe reset failed")
            t = events_ms(lambda: through(spans, kw))
            line["fill_only_ms" if fill_only else "ms_spans"] = t
        # One launch's spans.
        if probe(0, None, None, 0, 1):
            raise RuntimeError("probe reset failed")
        through(spans, kw)
        torch.cuda.synchronize()
        # The SM clock under load: sampled while ten launches run.
        for _ in range(10):
            through(plain, kw)
        clock_mhz.append(smi("clocks.sm"))
        torch.cuda.synchronize()
        if probe(0, span, buf, n_blocks, 0):
            raise RuntimeError("probe read failed")
        start = torch.tensor(list(buf[:n_blocks]), dtype=torch.float64)
        end = torch.tensor(list(buf[n_blocks:]), dtype=torch.float64)
        used = end > 0
        mhz = float(clock_mhz[-1].split()[0])
        total = sum(span)
        # A walk without marks (the shadow sweeps' 16x16 blocks keep
        # render_body's walk, whose marks only a patched tree has).
        line["phases"] = None if total == 0 else {
            "cycles_per_tile": {p: span[k] / (views * tiles) for k, p in enumerate(PHASES)},
            "share": {p: span[k] / total for k, p in enumerate(PHASES)},
            "blocks": int(used.sum()),
            "block_wall_us": float((end[used] - start[used]).mean()) / mhz}
        if hasattr(rc, "streamed_occupancy"):  # the entry the plan takes
            line["occupancy"] = rc.streamed_occupancy(kw)
        else:
            threads, smem = block_plan(kw)
            occ = (ctypes.c_int * 5)()
            err = plain.mrt_probe_occupancy(ctypes.c_size_t(smem), ctypes.c_int(threads),
                                            ctypes.c_int(rc._GEO_CODES[kw["geo"]]), occ)
            if err:
                raise RuntimeError(f"occupancy query failed: {err}")
            threads, regs, local, static, blocks = list(occ)
            line["occupancy"] = {"threads": threads, "registers": regs, "local_bytes": local,
                                 "static_smem": static, "dynamic_smem": smem,
                                 "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}
        print(json.dumps(line), flush=True)
        del r, kw
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": smi("name,power.limit"),
                      "clocks_sm_after_runs": clock_mhz}), flush=True)
    return 0


def dmxu_cases(m, rc, scenes, libs, events_ms, spans_of, root) -> None:
    """K11 on the ordered walk: a line a case and design (see the header)."""
    import importlib.util

    import torch

    import madrona_renderer_tpu_torch.config as cfg_mod
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene
    from madrona_renderer_tpu_torch.core.state import init_state

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    plain, spans = libs[("render_dmxu", False)], libs[("render_dmxu", True)]
    groups_tree = "dmxu" in rc.streamed_plan.__code__.co_varnames

    def through(lib, kw, groups):
        """``render_resident(**kw)`` with render_dmxu from ``lib``; in a tree
        with K11's tile groups, on its plan (``groups`` None) or the parent
        design (0)."""
        fn = bound(lib, "render_dmxu")
        real, real_plan = rc._build, rc.streamed_plan
        rc._build = types.SimpleNamespace(
            load=lambda n, *a: fn if n == "render_dmxu" else real.load(n))
        if groups == 0 and groups_tree:
            rc.streamed_plan = lambda geo, cc, size, lights, *a, dmxu=False, **k: (
                rc.StreamPlan(0, 1, rc.streamed_block_bytes(geo, cc, size, lights, 0))
                if dmxu else real_plan(geo, cc, size, lights, *a, **k))
        try:
            return rc.render_resident(**kw)
        finally:
            rc._build = real
            rc.streamed_plan = real_plan

    for kernel, path, worlds, height, width, varied in DMXU_CASES:
        if varied:
            geo, mats, textures, insts, cams, w = cs.bigmesh_scene(worlds, cfg_mod, scenes,
                                                                   vary=True)
            dev = torch.device("cuda", 0)
            state = init_state(insts, cams, w, dev)
            scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
        else:
            r = m.Manager(scenes.bigmesh_config(worlds, height, width, deferred_mxu=True))
            state, scene = r.state, r.scene
        kw = rc.pack_inputs(state, scene, height=height, width=width, accel="clusters",
                            deferred_mxu=True)
        route = rc.route_of(kw["order"], kw["spans"], kw["bins"])
        if route != rc.Route(True, "ordered") or not kw["dmxu"]:
            raise AssertionError(f"{path}: not K11 on the streamed ordered walk")
        views = kw["cams"].shape[0]
        tiles = -(-height // 16) * -(-width // 16)
        for groups in ((0, None) if groups_tree else (0,)):
            line = {"phase": "streamed_phase_probe", "kernel": kernel, "inputs": path,
                    "tree": str(root), "library": "render_dmxu", "rowskip": kw["rowskip"]}
            if groups is None:
                S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
                plan = rc.streamed_plan(kw["geo"], CC, S // CC, kw["n_lights"], views, height,
                                        width, dmxu=True)
                line.update(groups=plan.groups, blocks_per_view=plan.parts)
                line["occupancy"] = rc.streamed_occupancy(kw)
            else:
                line["groups"] = 0
            line["ms"] = events_ms(lambda: through(plain, kw, groups))
            spans_of(spans, lambda: through(spans, kw, groups), line, views, tiles)
            print(json.dumps(line), flush=True)
        del kw, state, scene
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
