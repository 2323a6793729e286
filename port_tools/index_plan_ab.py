"""K1 and K6 (the resident index order on prep rows) at forced launch plans,
held bitwise against the parent design and timed in turns in one process on
one card:

    python3 port_tools/index_plan_ab.py [PASSES]

Plans (raytrace_cuda.index_plan): the parent design ("g0": render_body's
16x16 blocks, one pixel a thread) and the index visit's tile teams at
G = 1 and 2 groups a block, 4 pixels a thread ("g1", "g2"). Inputs:
main's (4096 worlds of the demo scene at 64x64), mxu_4096w_128's under
"auto" (the same scene at 128x128), textured_4096w's (the 32x32 checker,
nearest, 64x64), textured_4096w_ssaa2's (the same at 2x2 SSAA: 128x128)
and the checker's bilinear filter at 64x64, each the scene's first step.

Every plan's outputs on a case are compared with the parent's first (a
plan that differs fails the run); then PASSES (4) passes time every plan of
a case in turn, each a CUDA graph of chip_smoke.KERNEL_REPS launches, the
order reversed every other pass. Prints one JSON line per case (the plan
the wrapper takes, each plan's occupancy, times and mean, the fastest),
then the card's name and power limit. Needs one card and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

# name: (view size, textured, texture filter, ssaa)
CASES = {
    "main": (64, False, "nearest", 1),
    "mxu_4096w_128_auto": (128, False, "nearest", 1),
    "textured_4096w": (64, True, "nearest", 1),
    "textured_4096w_ssaa2": (64, True, "nearest", 2),
    "textured_4096w_bilinear": (64, True, "bilinear", 1),
}
WORLDS = 4096


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    passes = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    import torch

    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("index_plan_ab: no CUDA card", file=sys.stderr)
        return 1
    cs = chip_smoke()
    real = rc.index_plan

    def forced(groups):
        """rc.index_plan at ``groups`` tile groups (0: the parent design)."""
        def plan(*args, **kwargs):
            return real(*args, **dict(kwargs, groups=groups))
        return plan

    def on(plan, fn):
        rc.index_plan = plan
        try:
            return fn()
        finally:
            rc.index_plan = real

    plans = {f"g{g}": forced(g) for g in (0, *rc._INDEX_GROUP_CHOICES)}

    cases = []
    for name, (res, textured, filt, ssaa) in CASES.items():
        r = m.Manager(scenes.demo_config(WORLDS, m.RenderMode.Raytracer, res, res,
                                         dynamic=True, textured=textured,
                                         tex_size=cs.TEX_SIZE, texture_filter=filt,
                                         ssaa=ssaa))
        kw = rc.pack_inputs(r.state, r.scene, height=res * ssaa, width=res * ssaa,
                            texture_filter=filt)
        if rc.route_of(kw["order"], kw["spans"], kw["bins"]) != rc.INDEX or kw["geo"] != "prep":
            raise AssertionError(f"{name}: not K1's index order on prep rows")
        ref = on(plans["g0"], lambda: rc.render_resident(**kw))
        torch.cuda.synchronize()
        launches, occupancy, same = {}, {}, {}
        for key, plan in plans.items():
            out = on(plan, lambda: rc.render_resident(**kw))
            torch.cuda.synchronize()
            same[key] = all(torch.equal(a, b) for a, b in zip(out, ref))
            launches[key] = lambda plan=plan, kw=kw: on(plan, lambda: rc.render_resident(**kw))
            if key != "g0":
                occupancy[key] = on(plan, lambda: rc.index_occupancy(kw))
        print(json.dumps({"phase": "index_plan_check", "case": name, "bitwise_vs_parent": same}),
              flush=True)
        if not all(same.values()):
            raise AssertionError(f"{name}: a plan differs from the parent design: {same}")
        cases.append((name, kw, launches, occupancy))
    times = [{k: [] for k in launches} for _, _, launches, _ in cases]
    for i in range(passes):
        for (_, _, launches, _), t in zip(cases, times):
            keys = list(launches)
            for k in (keys if i % 2 == 0 else keys[::-1]):
                t[k].append(cs.graph_ms(launches[k], cs.KERNEL_REPS))
    for (name, kw, _, occupancy), t in zip(cases, times):
        means = {k: statistics.mean(v) for k, v in t.items()}
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
        plan = real(kw["geo"], S, CC, kw["n_lights"], int(kw["cams"].shape[0]), kw["height"],
                    kw["width"], kw["texture"])
        print(json.dumps({"phase": "index_plan_ab", "inputs": name, "plan": plan._asdict(),
                          "occupancy": occupancy, "ms": t, "mean_ms": means,
                          "fastest": min(means, key=means.get)}), flush=True)
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
