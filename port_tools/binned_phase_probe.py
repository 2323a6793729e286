"""Where the streamed binned walk's time (K4, and K11 on the binned visit) goes,
measured on the card:

    python3 port_tools/binned_phase_probe.py [CHECKOUT]

Built the same way as port_tools/streamed_phase_probe.py (whose span hooks,
counters and helpers it reuses): under build/phase_probe/, a clock64 span
variant of CHECKOUT's binned entries (default: this tree; e.g. the parent
commit unpacked with `git archive` under a directory that .gitignore lists),
in a translation unit of its own, never on the main path, and the same
source without the marks. The marks are the MRT_PHASE hooks of the tile
groups' binned walk (csrc/render_resident.cu, empty in the port's own
build) or, in a tree whose binned walk is render_body's (one 16x16 block a
tile), the streamed probe's LEGACY_MARKS with BINNED_MARKS patched into a
copy of csrc/render_resident.cu.

For K4 on binned_32w_128's inputs (32 worlds of tools/tpu_binned_bench.py's
224-grid terrain at 128x128, accel="auto") and terrain_32w_512's (512x512,
accel="binned", a 32-px bin tile), and K11 on dmxu_32w_512's (the same at
512x512 with deferred_mxu=True and its row gate), it prints one JSON line
each with the streamed probe's keys (ms, ms_spans, fill_only_ms, the
phases per 16x16 tile: fill, gates, stage, tests, pixel, fetch, their
shares and a block's wall time; the occupancy: threads a block, registers,
local memory, shared memory, blocks and warps per SM, and in a tree with
raytrace_cuda.binned_occupancy its plan's tile groups and blocks a view),
and the bins' positions a tile (mean and largest count), then the card's
name and power limit and its SM clock after the runs (nvidia-smi). Needs
one card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import streamed_phase_probe as spp  # noqa: E402

HERE = spp.HERE
# (kernel, inputs, worlds, size, accel, deferred_mxu)
CASES = (("K4", "binned_32w_128", 32, 128, "auto", False),
         ("K4", "terrain_32w_512", 32, 512, "binned", False),
         ("K11", "dmxu_32w_512", 32, 512, "binned", True))

# The test marks of render_body's binned sweeps (K4's ranged bands, K11's
# every slot), beside LEGACY_MARKS' gates, stage waits and ordered tests.
BINNED_MARKS = (
    ("      auto visit_r = [&](int p, float* buf) {\n",
     "      auto visit_r = [&](int p, float* buf) {\n        MRT_PHASE(3);\n"),
    ("        // Row skip (:1915-1990): the cluster's rows miss the warp's.\n",
     "        MRT_PHASE(3);\n        // Row skip (:1915-1990): the cluster's rows miss the warp's.\n"),
)

# The library of each case's entry and an entry of it for the probe's own
# occupancy query (the path's cold untextured raytrace entry on prep rows):
# render_body's binned walk (K4 in render_binned.cu, K11 in render_dmxu.cu),
# or the tile groups' (both in render_binned.cu).
LEGACY_KERNELS = {"render_binned": "render_binned_kernel<0, false, 0>",
                  "render_dmxu": "render_binned_dmxu_kernel<0, false, 0>"}
GROUP_KERNELS = {"render_binned": "render_binned_kernel<0, false, 0, false>"}


def probe_tree(root: Path, out: Path) -> tuple:
    """A copy of ``root``'s csrc under ``out`` with the hooks in place, and
    whether the binned walk is the tile groups' (hooks already there)."""
    import shutil

    csrc = out / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(root / "madrona_renderer_tpu_torch" / "csrc", csrc)
    body = csrc / "render_resident.cu"
    text = body.read_text()
    if "bin_body" in text:
        return csrc, True
    for anchor, repl in spp.LEGACY_MARKS + BINNED_MARKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in {body}: {anchor!r}")
        text = text.replace(anchor, repl)
    body.write_text("#ifndef MRT_PHASE\n#define MRT_PHASE_BEGIN\n#define MRT_PHASE(k)\n"
                    "#define MRT_AFTER_FILL\n#endif\n" + text)
    return csrc, False


def build(csrc: Path, name: str, kernel: str, spans: bool, out: Path) -> Path:
    from madrona_renderer_tpu_torch import _build

    tu = out / f"{name}_{'spans' if spans else 'plain'}.cu"
    tu.write_text((spp.SPANS_HEAD if spans else "") + f'#include "{csrc / name}.cu"\n'
                  + spp.TAIL.replace("OCCUPANCY_KERNEL", kernel))
    lib = out / f"lib{tu.stem}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(["-DMRT_SPANS"] if spans else []),
           "-o", str(lib), str(tu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tu}:\n{proc.stderr[-3000:]}")
    return lib


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(root))
    import torch

    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("binned_phase_probe: no CUDA card", file=sys.stderr)
        return 1
    if not Path(m.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {m.__file__}, not the port of {root}")
    out = HERE / "build" / "phase_probe" / f"binned_{root.name}"
    out.mkdir(parents=True, exist_ok=True)
    csrc, groups = probe_tree(root, out)
    kernels = GROUP_KERNELS if groups else LEGACY_KERNELS
    jobs = [(n, s) for n in kernels for s in (False, True)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(
            lambda j: ctypes.CDLL(str(build(csrc, j[0], kernels[j[0]], j[1], out))), jobs)))
    print(json.dumps({"phase": "probe_build", "tree": str(root), "tile_groups": groups}),
          flush=True)

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
        fn = spp.bound(lib, name)
        real = rc._build
        rc._build = types.SimpleNamespace(load=lambda n, *a: fn if n == name else real.load(n))
        try:
            return rc.render_resident(**kw)
        finally:
            rc._build = real

    clock_mhz = []
    for kernel, path, worlds, res, accel, dmxu in CASES:
        r = m.Manager(scenes.binned_terrain_config(worlds, res, res, accel=accel,
                                                   deferred_mxu=dmxu))
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, accel=accel,
                            deferred_mxu=dmxu)
        route = rc.route_of(kw["order"], kw["spans"], kw["bins"])
        name = rc.library_of(route, False, dmxu=dmxu)
        if route != rc.Route(True, "binned") or name not in kernels:
            raise AssertionError(f"{path}: not the streamed binned walk")
        plain, spans = libs[(name, False)], libs[(name, True)]
        counts = kw["bins"][:, :, 0].double()
        line = {"phase": "binned_phase_probe", "kernel": kernel, "inputs": path,
                "tree": str(root), "library": name, "bin_tile": kw["bin_tile"],
                "bin_positions": {"mean": float(counts.mean()), "max": int(counts.max())}}
        line["ms"] = events_ms(lambda: through(plain, name, kw))
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
            t = events_ms(lambda: through(spans, name, kw))
            line["fill_only_ms" if fill_only else "ms_spans"] = t
        if probe(0, None, None, 0, 1):
            raise RuntimeError("probe reset failed")
        through(spans, name, kw)
        torch.cuda.synchronize()
        for _ in range(10):  # the SM clock under load
            through(plain, name, kw)
        clock_mhz.append(spp.smi("clocks.sm"))
        torch.cuda.synchronize()
        if probe(0, span, buf, n_blocks, 0):
            raise RuntimeError("probe read failed")
        start = torch.tensor(list(buf[:n_blocks]), dtype=torch.float64)
        end = torch.tensor(list(buf[n_blocks:]), dtype=torch.float64)
        used = end > 0
        mhz = float(clock_mhz[-1].split()[0])
        total = sum(span)
        line["phases"] = None if total == 0 else {
            "cycles_per_tile": {p: span[k] / (views * tiles) for k, p in enumerate(spp.PHASES)},
            "share": {p: span[k] / total for k, p in enumerate(spp.PHASES)},
            "blocks": int(used.sum()),
            "block_wall_us": float((end[used] - start[used]).mean()) / mhz}
        if hasattr(rc, "binned_occupancy"):  # the entry the plan takes
            line["occupancy"] = rc.binned_occupancy(kw)
        else:
            S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
            smem = 4 * (2 * 11 * (S // CC) + int(kw["cams"].shape[1]))
            occ = (ctypes.c_int * 5)()
            err = plain.mrt_probe_occupancy(ctypes.c_size_t(smem), ctypes.c_int(256),
                                            ctypes.c_int(0), occ)
            if err:
                raise RuntimeError(f"occupancy query failed: {err}")
            threads, regs, local, static, blocks = list(occ)
            line["occupancy"] = {"threads": threads, "registers": regs, "local_bytes": local,
                                 "static_smem": static, "dynamic_smem": smem,
                                 "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}
        print(json.dumps(line), flush=True)
        del r, kw
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": spp.smi("name,power.limit"),
                      "clocks_sm_after_runs": clock_mhz}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
