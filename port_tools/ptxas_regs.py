"""Registers and spills of every render-kernel entry point, as ptxas reports
them for the port's build flags, for this checkout and, optionally, against
another checkout (e.g. the parent commit unpacked with ``git archive``):

    python3 port_tools/ptxas_regs.py [OTHER_CHECKOUT]

Prints one JSON line: the entries of every csrc/render_*.cu with their
register counts ("name": n) and spill stores/loads ("name:spill": "s/l"),
and, with OTHER_CHECKOUT, whether every entry that tree has keeps its count
here. Entry names are the kernels' mangled names with the anonymous
namespace's per-build hash and the parameter list dropped (an entry that
gains a parameter keeps its name). Needs nvcc.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from madrona_renderer_tpu_torch import _build  # noqa: E402

CSRC = Path("madrona_renderer_tpu_torch/csrc")


def entry_name(mangled: str) -> str:
    """``_ZN<ns><len>name I<template args>E v <params>`` → ``name I...E``:
    the template arguments end where the void return type's ``Ev`` follows
    their closing ``E``."""
    name = re.sub(r"^_ZN\d+", "", re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", mangled))
    # The anonymous namespace as nvcc names it, `_<source>_cu_<hash>`, and
    # the entry's name length: the name alone, so that an entry keeps its
    # key when its source is renamed.
    name = re.sub(r"^_\w+?_cu_[0-9a-f]{8}\d+", "", name)
    cut = name.find("EEv")
    return name[:cut + 2] if cut >= 0 else name


def registers(src: Path) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "k.so"), str(src)],
            capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-3000:]}")
    regs, entry = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = entry_name(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            regs[entry + ":spill"] = f"{m.group(1)}/{m.group(2)}"
    return regs


def main() -> int:
    trees = [ROOT] + [Path(a).resolve() for a in sys.argv[1:2]]
    jobs = [(i, src) for i, t in enumerate(trees)
            for src in sorted((t / CSRC).glob("render_*.cu"))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        parts = list(pool.map(lambda job: (job[0], registers(job[1])), jobs))
    found = [{} for _ in trees]
    for i, regs in parts:
        found[i].update(regs)
    out = {"phase": "ptxas", "seconds": time.perf_counter() - t0, "entries": found[0]}
    if len(found) > 1:
        other = found[1]
        out["other_entries"] = len(other)
        out["other_kept"] = all(found[0].get(k) == v for k, v in other.items())
        out["differ"] = {k: [v, found[0].get(k)] for k, v in other.items()
                         if found[0].get(k) != v}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
