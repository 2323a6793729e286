"""A few kernels of two source trees timed in turns on one card: this tree
and OTHER (an unpacked `git archive` of another commit, e.g. the parent,
under a directory that .gitignore lists):

    python3 port_tools/tree_ab.py OTHER [PASSES]

Each pass is a child process that imports the port from one tree (which
builds its kernels into that tree's build/) and times, each a CUDA graph
of 50 launches on the same inputs:
  pack_rows                 K13 on main's 4096 worlds (the demo scene);
  render_resident           K1 on main's inputs;
  render_resident_raster_tex_bilinear
                            K2 + K6 bilinear on raster_256w_png's inputs
                            (256 worlds of the textured demo at 64x64).
The inputs are each scene's first step. PASSES (4) alternate this tree and
OTHER, starting with this one. Prints one JSON line per pass and then one
with each kernel's times and OTHER's over this tree's mean, with the card's
name and power limit. Needs one card and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KERNELS = ("pack_rows", "render_resident", "render_resident_raster_tex_bilinear")


def this_chip_smoke():
    """This tree's chip_smoke module (its timing helpers and nvidia_smi)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one_pass(root: Path) -> dict:
    """Times the kernels with the port of ``root``; this tree's chip_smoke
    for the timing and the card's description."""
    sys.path.insert(0, str(root))
    cs = this_chip_smoke()
    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import pack_cuda
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners.scenes import demo_config

    if not Path(m.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {m.__file__}, not the port of {root}")
    out = {"phase": "tree_ab_pass", "tree": str(root)}
    main = m.Manager(demo_config(4096, m.RenderMode.Raytracer, 64, 64, dynamic=True))
    cam = main.state.camera_pos[:, 0, :].contiguous()
    out["pack_rows"] = cs.graph_ms(lambda: pack_cuda.pack_rows(main.state, main.scene, cam),
                                   cs.KERNEL_REPS)
    kw = rc.pack_inputs(main.state, main.scene, height=64, width=64)
    out["render_resident"] = cs.graph_ms(lambda: rc.render_resident(**kw), cs.KERNEL_REPS)
    del main, kw
    cfg = demo_config(256, m.RenderMode.Rasterizer, 64, 64, dynamic=True, textured=True,
                      tex_size=32)
    raster = m.Manager(cfg)
    kw = rc.pack_inputs(raster.state, raster.scene, height=64, width=64, raster=True,
                        near=cfg.raster_near_plane, texture_filter="bilinear")
    out["render_resident_raster_tex_bilinear"] = cs.graph_ms(
        lambda: rc.render_resident(**kw), cs.KERNEL_REPS)
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--pass":
        print(json.dumps(one_pass(Path(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    passes = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    trees = [HERE if i % 2 == 0 else other for i in range(passes)]
    results = []
    for root in trees:
        proc = subprocess.run([sys.executable, __file__, "--pass", str(root)],
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    summary = {"phase": "tree_ab", "this": str(HERE), "other": str(other),
               "nvidia_smi": this_chip_smoke().nvidia_smi()}
    for k in KERNELS:
        mine = [r[k] for r, t in zip(results, trees) if t == HERE]
        theirs = [r[k] for r, t in zip(results, trees) if t == other]
        summary[k] = {"this_ms": mine, "other_ms": theirs,
                      "other_over_this": [x / statistics.mean(mine) for x in theirs]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
