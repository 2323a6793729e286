"""Where K12's time (accel="mxu", csrc/render_batched.cu) goes, measured on the card:

    python3 port_tools/batched_phase_probe.py [CHECKOUT]

Builds, under build/phase_probe/, a clock64 span variant of CHECKOUT's K12
library (default: this tree; e.g. the parent commit unpacked with `git
archive` under a directory that .gitignore lists), in a translation unit of
its own, never on the main path, and the same source without the marks.
The marks: the parent design's kernel (render_batched_kernel, one pixel a
thread of a 16x16 block) has none, so the probe patches them into a copy
(PARENT_MARKS); a tree with the records design (render_batched_rec_kernel)
has its own MRT_PHASE hooks, empty in the port's own build.

For K12 on mxu_4096w's inputs (4096 worlds of the demo scene at 64x64,
accel="mxu"), mxu_4096w_128's (128x128) and textured_4096w_mxu's (the
9-output mode, the 32x32 checker), each design the tree has (the parent's
pixels 0; the records' pixels a thread, raytrace_cuda._BATCHED_PIXEL_CHOICES),
it prints one JSON line
with:
  ms               the kernel's device time (CUDA events, 5 launches);
  ms_spans         the span variant's (what the marks cost);
  phases           per block, the cycles of its first thread (thread
                   (0, 0)) in: ray (ray generation), prepass (the block's
                   prepass of a chunk and its two barriers), sweep (the
                   tests of every triangle), resolve (the winner's (u, v)),
                   shade (the normal, the shading or the 9-output values,
                   the writes), and each phase's share; blocks a view;
then the card's name and power limit and its SM clock after the runs
(nvidia-smi), by which cycles become microseconds. Needs one card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PHASES = ("prepass", "sweep", "resolve", "shade", "ray")
# (inputs, size, textured: the 9-output mode)
CASES = (("mxu_4096w", 64, False), ("mxu_4096w_128", 128, False),
         ("textured_4096w_mxu", 64, True))
WORLDS = 4096

# The marks of the parent design's kernel: (anchor, replacement) in
# csrc/render_batched.cu, each anchor found exactly once.
PARENT_MARKS = (
    ("  __shared__ float s_pre[kPreRows * kChunk];\n",
     "  __shared__ float s_pre[kPreRows * kChunk];\n  MRT_PHASE_BEGIN;\n"),
    ("    __syncthreads();  // every thread is done with the previous chunk\n"
     "    for (int k = tid; k < n; k += kThreads) prepass(",
     "    MRT_PHASE(0);\n    __syncthreads();  // every thread is done with the previous chunk\n"
     "    for (int k = tid; k < n; k += kThreads) prepass("),
    ("    __syncthreads();\n    for (int k = 0; k < n; ++k) {\n      float u, v, t;\n"
     "      numerators(s_pre + k",
     "    __syncthreads();\n    MRT_PHASE(1);\n    for (int k = 0; k < n; ++k) {\n"
     "      float u, v, t;\n      numerators(s_pre + k"),
    ("  if (px >= a.width || py >= a.height) return;\n\n  // The winner's resolve",
     "  if (px >= a.width || py >= a.height) return;\n  MRT_PHASE(2);\n\n"
     "  // The winner's resolve"),
    ("  const float flip = nx * dx + ny * dy + nz * dz > 0.f ? -1.0f : 1.0f;\n"
     "  nx = nx * flip;\n  ny = ny * flip;\n  nz = nz * flip;\n  const float t_hit = found ? "
     "best_t : 0.f;\n  const float z = t_hit * cosf_;\n  const size_t o = ((size_t)view * "
     "a.height + py) * a.width + px;\n  const size_t plane = (size_t)gridDim.x",
     "  MRT_PHASE(3);\n  const float flip = nx * dx + ny * dy + nz * dz > 0.f ? -1.0f : 1.0f;\n"
     "  nx = nx * flip;\n  ny = ny * flip;\n  nz = nz * flip;\n  const float t_hit = found ? "
     "best_t : 0.f;\n  const float z = t_hit * cosf_;\n  const size_t o = ((size_t)view * "
     "a.height + py) * a.width + px;\n  const size_t plane = (size_t)gridDim.x"),
)

# The span variant's hooks: a block's thread (0, 0) accumulates the cycles of
# the phase it is in (it starts in "ray") and adds them to the totals at its
# end.
SPANS_HEAD = r"""
#include <cuda_runtime.h>
__device__ unsigned long long g_mrt_span[5];
__device__ unsigned long long g_mrt_blocks;
struct MrtSpans {
  long long acc[5];
  long long last;
  int cur;
  bool lead;
  __device__ MrtSpans() : acc{0, 0, 0, 0, 0}, cur(4) {
    lead = threadIdx.x == 0 && threadIdx.y == 0;
    last = clock64();
  }
  __device__ void phase(int k) {
    if (!lead) return;
    const long long now = clock64();
    acc[cur] += now - last;
    last = now;
    cur = k;
  }
  __device__ ~MrtSpans() {
    if (!lead) return;
    phase(0);
    for (int k = 0; k < 5; ++k) atomicAdd(&g_mrt_span[k], (unsigned long long)acc[k]);
    atomicAdd(&g_mrt_blocks, 1ull);
  }
};
#define MRT_PHASE_BEGIN MrtSpans mrt_spans_
#define MRT_PHASE(k) mrt_spans_.phase(k)
"""

TAIL = r"""
extern "C" int mrt_probe_spans(unsigned long long* span, unsigned long long* blocks,
                               int reset) {
  int err;
  if (reset) {
    unsigned long long zero[5] = {0, 0, 0, 0, 0};
    err = (int)cudaMemcpyToSymbol(g_mrt_span, zero, sizeof(zero));
    if (!err) err = (int)cudaMemcpyToSymbol(g_mrt_blocks, zero, sizeof(zero[0]));
    return err ? err : (int)cudaDeviceSynchronize();
  }
  err = (int)cudaMemcpyFromSymbol(span, g_mrt_span, 5 * sizeof(unsigned long long));
  if (!err) err = (int)cudaMemcpyFromSymbol(blocks, g_mrt_blocks, sizeof(unsigned long long));
  return err;
}
"""


def probe_source(root: Path, out: Path) -> tuple:
    """A copy of ``root``'s csrc/render_batched.cu under ``out`` with the
    parent kernel's marks, and whether the tree has the records design."""
    src = root / "madrona_renderer_tpu_torch" / "csrc" / "render_batched.cu"
    text = src.read_text()
    # The parent kernel's body: from its signature to its closing brace.
    start = text.index("render_batched_kernel(const BatchedArgs a) {")
    end = text.index("\n}\n", start)
    body = text[start:end]
    for anchor, repl in PARENT_MARKS:
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {src}'s parent kernel: {anchor!r}")
        body = body.replace(anchor, repl)
    text = text[:start] + body + text[end:]
    if "MRT_PHASE" not in src.read_text():
        text = "#ifndef MRT_PHASE\n#define MRT_PHASE_BEGIN\n#define MRT_PHASE(k)\n#endif\n" + text
    dst = out / "render_batched.cu"
    dst.write_text(text)
    return dst, "render_batched_rec_kernel" in text


def build(src: Path, spans: bool, out: Path) -> Path:
    from madrona_renderer_tpu_torch import _build

    tu = out / f"render_batched_{'spans' if spans else 'plain'}.cu"
    tu.write_text((SPANS_HEAD if spans else "") + f'#include "{src}"\n'
                  + (TAIL if spans else ""))
    lib = out / f"lib{tu.stem}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(tu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tu}:\n{proc.stderr[-3000:]}")
    return lib


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(HERE / "port_tools"))
    import torch

    import madrona_renderer_tpu_torch as m
    import streamed_phase_probe as spp
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("batched_phase_probe: no CUDA card", file=sys.stderr)
        return 1
    if not Path(m.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {m.__file__}, not the port of {root}")
    out = HERE / "build" / "phase_probe" / f"batched_{root.name}"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    src, records = probe_source(root, out)
    libs = {s: ctypes.CDLL(str(build(src, s, out))) for s in (False, True)}
    print(json.dumps({"phase": "probe_build", "tree": str(root), "records": records}),
          flush=True)
    designs = rc._BATCHED_PIXEL_CHOICES if records else (0,)

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

    def through(lib, kw, pixels):
        """``render_batched(**kw)`` with the library taken from ``lib`` and,
        in a tree with the records design, ``pixels`` a thread."""
        fn = spp.bound(lib, "render_batched")
        real, real_plan = rc._build, getattr(rc, "batched_plan", None)
        rc._build = types.SimpleNamespace(
            load=lambda n, *a: fn if n == "render_batched" else real.load(n))
        if records:
            rc.batched_plan = lambda h, w, p=pixels: real_plan(h, w, p)
        try:
            return rc.render_batched(**kw)
        finally:
            rc._build = real
            if records:
                rc.batched_plan = real_plan

    clock_mhz = []
    for path, res, textured in CASES:
        r = m.Manager(scenes.demo_config(WORLDS, m.RenderMode.Raytracer, res, res,
                                         dynamic=textured, textured=textured, tex_size=32))
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, accel="mxu")
        for pixels in designs:
            line = {"phase": "batched_phase_probe", "inputs": path, "tree": str(root),
                    "nine": bool(kw["nine"]), "pixels": pixels}
            line["ms"] = events_ms(lambda: through(libs[False], kw, pixels))
            line["ms_spans"] = events_ms(lambda: through(libs[True], kw, pixels))
            probe = libs[True].mrt_probe_spans
            probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            span, blocks = (ctypes.c_ulonglong * 5)(), (ctypes.c_ulonglong * 1)()
            if probe(None, None, 1):
                raise RuntimeError("probe reset failed")
            through(libs[True], kw, pixels)
            torch.cuda.synchronize()
            for _ in range(10):  # the SM clock under load
                through(libs[False], kw, pixels)
            clock_mhz.append(spp.smi("clocks.sm"))
            torch.cuda.synchronize()
            if probe(span, blocks, 0):
                raise RuntimeError("probe read failed")
            total = sum(span)
            n = int(blocks[0])
            line["phases"] = None if total == 0 else {
                "cycles_per_block": {p: span[k] / n for k, p in enumerate(PHASES)},
                "share": {p: span[k] / total for k, p in enumerate(PHASES)},
                "blocks_per_view": n // int(kw["cams"].shape[0])}
            print(json.dumps(line), flush=True)
        del r, kw
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": spp.smi("name,power.limit"),
                      "clocks_sm_after_runs": clock_mhz}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
