"""Registers and spills of every render-kernel entry point, as ptxas reports
them for the port's build flags, for this checkout and, optionally, against
another checkout (e.g. the parent commit unpacked with ``git archive``):

    python3 port_tools/ptxas_regs.py [OTHER_CHECKOUT]

Prints one JSON line: the entries of csrc/render_resident.cu and
csrc/render_binned.cu with their register counts ("name": n) and spill stores/loads ("name:spill": "s/l"),
and, with OTHER_CHECKOUT, whether every entry that tree has keeps its count
here. Entry names drop the anonymous namespace's per-build hash. Needs nvcc.
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

SOURCES = (Path("madrona_renderer_tpu_torch/csrc/render_resident.cu"),
           Path("madrona_renderer_tpu_torch/csrc/render_binned.cu"))


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
            entry = re.sub(r"^_ZN\d+", "", re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            regs[entry + ":spill"] = f"{m.group(1)}/{m.group(2)}"
    return regs


def main() -> int:
    trees = [ROOT] + [Path(a).resolve() for a in sys.argv[1:2]]
    jobs = [(i, t / src) for i, t in enumerate(trees) for src in SOURCES
            if (t / src).is_file()]
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
