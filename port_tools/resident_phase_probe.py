"""Where K3's and K4's time on resident rows goes, measured on the card:

    python3 port_tools/resident_phase_probe.py [CHECKOUT]

Builds, under build/phase_probe/, a clock64 span variant of the two
resident-visit sources (csrc/render_resident_ordered.cu and
csrc/render_resident_binned.cu) of CHECKOUT (default: this tree; e.g. the
parent commit unpacked with `git archive` under a directory that
.gitignore lists), in translation units of their own, never on the main
path: the sources' MRT_PHASE hooks (empty in the port's own build) mark
the phases, or, in a tree that predates them, the probe patches the same
marks into a copy of csrc/render_resident.cu. It also builds the same
sources without the marks (their kernels are the port's), with a function
that reads each entry's attributes and occupancy.

For K3 on resident_terrain_4096w_64's inputs (4096 worlds of the 27-grid
terrain at 64x64, ordered) and K4 on resident_terrain_1024w_128's (1024
worlds at 128x128, binned) it prints one JSON line each:
  ms               the kernel's device time (CUDA events, 5 launches);
  ms_spans         the span variant's (what the marks cost);
  fill_only_ms     the span variant stopped after its geometry fill, at
                   the same grid and block;
  phases           per tile, the cycles of each tile walker's first
                   thread (a tile group's thread 0, or the 16x16 block's)
                   in: fill (the block's geometry fill, shared by its
                   tiles), fetch (taking the next tile), gates (the exit
                   and slab barriers), tests (the triangle tests of the
                   visited clusters), pixel (ray generation, resolve,
                   shade, write), and each phase's share; block_wall_us,
                   a block's mean wall time;
  occupancy        the entry's threads a block, registers, local memory,
                   dynamic shared memory, and blocks and warps per SM
                   (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  streamed_ms      the streamed walk (K3 + K5, render_streamed) on the
                   same inputs, as a yardstick only;
then the card's name and power limit and its SM clock after the runs
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
SOURCES = ("render_resident_ordered", "render_resident_binned")
PHASES = ("fill", "gates", "tests", "pixel", "fetch")
GRID = 27
CASES = (("K3", "resident_terrain_4096w_64", 4096, 64, "render_resident_ordered"),
         ("K4", "resident_terrain_1024w_128", 1024, 128, "render_resident_binned"))

# The marks of a tree that predates the hooks: (anchor, replacement) in
# csrc/render_resident.cu, each anchor found exactly once.
LEGACY_MARKS = (
    ("  extern __shared__ __align__(16) float smem[];\n  // Resident:",
     "  extern __shared__ __align__(16) float smem[];\n  MRT_PHASE_BEGIN;\n  // Resident:"),
    ("  __syncthreads();\n\n  const int tile = blockIdx.y;",
     "  __syncthreads();\n  MRT_AFTER_FILL;\n  MRT_PHASE(3);\n\n  const int tile = blockIdx.y;"),
    ("    for (int p = 0; p < n; ++p) {\n      const int c = s_order[p];\n"
     "      if (!(s_cl[6 * CC + c] > 0.f)) break;",
     "    for (int p = 0; p < n; ++p) {\n      MRT_PHASE(1);\n      const int c = s_order[p];\n"
     "      if (!(s_cl[6 * CC + c] > 0.f)) break;"),
    ("      if (!__syncthreads_or(possible)) continue;\n      const int base = c * cs;",
     "      if (!__syncthreads_or(possible)) continue;\n      MRT_PHASE(2);\n"
     "      const int base = c * cs;"),
    ("  const bool inside = px < a.width && py < a.height;\n  // The shadow sweep below",
     "  MRT_PHASE(3);\n  const bool inside = px < a.width && py < a.height;\n"
     "  // The shadow sweep below"),
)

# The span variant's definitions of the hooks. A tile walker's first thread
# (threadIdx.x == 0 and threadIdx.y a multiple of 16) accumulates the
# cycles of the phase it is in; the block's first thread stamps the block's
# start, every walker its end.
SPANS_HEAD = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ unsigned long long g_mrt_span[5];
__device__ unsigned long long g_mrt_block[2][1 << 17];
__device__ int g_mrt_fill_only;
__device__ float g_mrt_sink[1 << 17];
__shared__ long long mrt_acc[4][5];
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
    for (int k = 0; k < 5; ++k) mrt_acc[g][k] = 0;
    mrt_cur[g] = 0;
    mrt_last[g] = clock64();
  }
  __device__ ~MrtSpans() {
    if (!mrt_leader()) return;
    mrt_phase(0);
    const int g = threadIdx.y / 16;
    for (int k = 0; k < 5; ++k) atomicAdd(&g_mrt_span[k], (unsigned long long)mrt_acc[g][k]);
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
# path's cold untextured entry, raytraced on prep rows), and in the span
# build the counters.
TAIL = r"""
extern "C" {
int mrt_probe_occupancy(size_t smem, int* out) {
  auto kernel = KERNEL<0, false, 0>;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          attr.maxThreadsPerBlock, smem);
  out[0] = attr.maxThreadsPerBlock;
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
    unsigned long long zero[5] = {0, 0, 0, 0, 0};
    static unsigned long long zeros[2][1 << 17];
    err = (int)cudaMemcpyToSymbol(g_mrt_span, zero, sizeof(zero));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_block, zeros, sizeof(zeros));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_fill_only, &fill_only, sizeof(int));
    return err ? err : (int)cudaDeviceSynchronize();
  }
  err = (int)cudaMemcpyFromSymbol(span, g_mrt_span, 5 * sizeof(unsigned long long));
  for (int k = 0; k < 2 && !err; ++k)
    err = (int)cudaMemcpyFromSymbol(block + (size_t)k * n_blocks, g_mrt_block,
                                    n_blocks * sizeof(unsigned long long),
                                    (size_t)k * sizeof(g_mrt_block[0]));
  return err;
}
#endif
}
"""
KERNELS = {"render_resident_ordered": "render_resident_ordered_kernel",
           "render_resident_binned": "render_resident_binned_kernel"}


def probe_tree(root: Path, out: Path) -> Path:
    """A copy of ``root``'s csrc under ``out`` with the hooks in place."""
    csrc = out / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(root / "madrona_renderer_tpu_torch" / "csrc", csrc)
    body = csrc / "render_resident.cu"
    text = body.read_text()
    if "MRT_PHASE(" not in text:
        for anchor, repl in LEGACY_MARKS:
            if text.count(anchor) != 1:
                raise RuntimeError(f"anchor not found once in {body}: {anchor!r}")
            text = text.replace(anchor, repl)
        text = ("#ifndef MRT_PHASE\n#define MRT_PHASE_BEGIN\n#define MRT_PHASE(k)\n"
                "#define MRT_AFTER_FILL\n#endif\n") + text
        body.write_text(text)
    return csrc


def build(csrc: Path, name: str, spans: bool, out: Path) -> Path:
    from madrona_renderer_tpu_torch import _build

    tu = out / f"{name}_{'spans' if spans else 'plain'}.cu"
    tu.write_text((SPANS_HEAD if spans else "") + f'#include "{csrc / name}.cu"\n'
                  + TAIL.replace("KERNEL", KERNELS[name]))
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


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(root))
    import torch

    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch import _build
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("resident_phase_probe: no CUDA card", file=sys.stderr)
        return 1
    if not Path(m.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {m.__file__}, not the port of {root}")
    out = HERE / "build" / "phase_probe" / root.name
    out.mkdir(parents=True, exist_ok=True)
    csrc = probe_tree(root, out)
    jobs = [(n, s) for n in SOURCES for s in (False, True)]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        streamed = pool.submit(_build.build, "render_resident")
        libs = dict(zip(jobs, pool.map(lambda j: ctypes.CDLL(str(build(csrc, *j, out))),
                                       jobs)))
        streamed.result()
    print(json.dumps({"phase": "probe_build", "tree": str(root)}), flush=True)

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

    def through(lib, name, kw):
        """``render_resident(**kw)`` with ``name``'s library taken from ``lib``."""
        fn = bound(lib, name)
        real = rc._build
        rc._build = types.SimpleNamespace(load=lambda n, *a: fn if n == name else real.load(n))
        try:
            return rc.render_resident(**kw)
        finally:
            rc._build = real

    clock_mhz = []
    for kernel, path, worlds, res, name in CASES:
        r = m.Manager(scenes.bigmesh_config(worlds, res, res, grid=GRID))
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res)
        if rc.library_of(rc.route_of(kw["order"], kw["spans"], kw["bins"]), False) != name:
            raise AssertionError(f"{path}: not the {name} visit")
        plain, spans = libs[(name, False)], libs[(name, True)]
        line = {"phase": "resident_phase_probe", "kernel": kernel, "inputs": path,
                "tree": str(root)}
        line["ms"] = events_ms(lambda: through(plain, name, kw))
        views = kw["cams"].shape[0]
        tiles = (-(-res // 16)) ** 2
        probe = spans.mrt_probe_spans
        probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int]
        n_blocks = 1 << 17
        buf = (ctypes.c_ulonglong * (2 * n_blocks))()
        span = (ctypes.c_ulonglong * 5)()
        for fill_only in (1, 0):
            if probe(fill_only, None, None, 0, 1):
                raise RuntimeError("probe reset failed")
            t = events_ms(lambda: through(spans, name, kw))
            line["fill_only_ms" if fill_only else "ms_spans"] = t
        # One launch's spans.
        if probe(0, None, None, 0, 1):
            raise RuntimeError("probe reset failed")
        through(spans, name, kw)
        torch.cuda.synchronize()
        # The SM clock under load: sampled while ten launches run.
        for _ in range(10):
            through(plain, name, kw)
        clock_mhz.append(smi("clocks.sm"))
        torch.cuda.synchronize()
        if probe(0, span, buf, n_blocks, 0):
            raise RuntimeError("probe read failed")
        start = torch.tensor(list(buf[:n_blocks]), dtype=torch.float64)
        end = torch.tensor(list(buf[n_blocks:]), dtype=torch.float64)
        used = end > 0
        mhz = float(clock_mhz[-1].split()[0])
        total = sum(span)
        line["phases"] = {
            "cycles_per_tile": {p: span[k] / (views * tiles) for k, p in enumerate(PHASES)},
            "share": {p: span[k] / total for k, p in enumerate(PHASES)},
            "blocks": int(used.sum()),
            "block_wall_us": float((end[used] - start[used]).mean()) / mhz}
        occ = (ctypes.c_int * 5)()
        smem = (rc.resident_smem_bytes(kw["geo"], kw["rows"].shape[2], kw["clusters"].shape[2],
                                       kw["n_lights"], kw["order"] is not None)
                if hasattr(rc, "resident_smem_bytes") else
                4 * (10 * kw["rows"].shape[2] + 8 * kw["clusters"].shape[2] + kw["cams"].shape[1]
                     + (kw["clusters"].shape[2] if kw["order"] is not None else 0)))
        err = plain.mrt_probe_occupancy(ctypes.c_size_t(smem), occ)
        if err:
            raise RuntimeError(f"occupancy query failed: {err}")
        threads, regs, local, static, blocks = list(occ)
        line["occupancy"] = {"threads": threads, "registers": regs, "local_bytes": local,
                             "static_smem": static, "dynamic_smem": smem,
                             "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}
        if kw["order"] is not None:
            order = kw["order"]
        else:
            lo, hi, valid, _ = rc.world_clusters(r.state, r.scene)
            order = rc.camera_cluster_order(lo, hi, valid, r.state.camera_pos)
        lo, hi, valid, _ = rc.world_clusters(r.state, r.scene)
        fov = torch.where(r.state.camera_fov > 0, r.state.camera_fov, 90.0)
        skw = dict(kw, order=order, bins=None, bin_tile=None,
                   spans=rc.camera_cluster_rowspans(lo, hi, valid, r.state, fov, res, g_rows=16))
        line["streamed_ms"] = events_ms(lambda: rc.render_resident(**skw))
        print(json.dumps(line), flush=True)
        del r, kw, skw
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": smi("name,power.limit"),
                      "clocks_sm_after_runs": clock_mhz}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
