"""K11 on the streamed ordered walk and K12 (accel="mxu") at forced launch
plans, timed in turns in one process on one card:

    python3 port_tools/dense_plan_ab.py [PASSES]

K11 (csrc/render_dmxu.cu): render_body's 16x16 blocks (the parent design,
plan "g0") and the tile groups at G = 1, 2 and 4 groups a block with B = 1
and the plan's blocks a view ("g{G}_b{B}"), on bigmesh_512w_dmxu's inputs
(512 worlds of bench.py's 72-grid terrain at 64x64), its 9-output mode on
bigmesh_512w_tex256's (the 256x256 checker baked without mips), seeded (K9)
on a warm step's of the same scene (the seed from the depth of the step
before, world 0's terrain moved between), and on 64 worlds of chip_smoke.py's
varied big-mesh terrain at 64x256 (the row gate) on prep rows and, with two
cameras a world, on raw rows (at 64x64 and 64x256). K12
(csrc/render_batched.cu): its parent design ("p0": one pixel a thread of a
16x16 block) and the records at the pixels a thread the build offers
(raytrace_cuda._BATCHED_PIXEL_CHOICES: "p4"), on mxu_4096w's, mxu_4096w_128's and textured_4096w_mxu's inputs
(4096 worlds of the demo scene) and raytraced and rasterized at 64x64.

Each plan's time is a CUDA graph of chip_smoke.KERNEL_REPS launches; PASSES
(4) passes take every plan of a case in turn, the order reversed every other
pass. Prints one JSON line per case (the plan the wrapper takes, each plan's
times and its mean over the plan's), then the card's name and power limit.
Needs one card and nvcc.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    passes = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    import torch

    import madrona_renderer_tpu_torch as m
    import madrona_renderer_tpu_torch.config as cfg_mod
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene
    from madrona_renderer_tpu_torch.core.state import init_state
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("dense_plan_ab: no CUDA card", file=sys.stderr)
        return 1
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    real_streamed, real_batched = rc.streamed_plan, rc.batched_plan

    def k11_plan(groups, parts):
        def plan(geo, cc, size, n_lights, *args, dmxu=False, **kwargs):
            if not dmxu:
                return real_streamed(geo, cc, size, n_lights, *args, **kwargs)
            return rc.StreamPlan(groups, parts,
                                 rc.streamed_block_bytes(geo, cc, size, n_lights, groups, True))
        return plan

    def on(name, plan, fn):
        real = getattr(rc, name)
        setattr(rc, name, plan)
        try:
            return fn()
        finally:
            setattr(rc, name, real)

    def k11_plans(kw):
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
        plan = real_streamed(kw["geo"], CC, S // CC, kw["n_lights"], int(kw["cams"].shape[0]),
                             kw["height"], kw["width"], dmxu=True)
        parts = max(plan.parts, 1)
        keys = {(0, 1)} | {(g, b) for g in (1, 2, 4) for b in (1, parts)}
        return plan, {f"g{g}_b{b}" if g else "g0": (lambda kw=kw, g=g, b=b: on(
            "streamed_plan", k11_plan(g, b), lambda: rc.render_resident(**kw)))
            for g, b in sorted(keys)}

    def k12_plans(kw):
        return (real_batched(kw["height"], kw["width"]),
                {f"p{p}": (lambda kw=kw, p=p: on(
                    "batched_plan", lambda h, w: real_batched(h, w, p),
                    lambda: rc.render_batched(**kw)))
                 for p in rc._BATCHED_PIXEL_CHOICES})

    cases = []  # (kernel, inputs, plan, {plan key: launch})
    tex = cs.png_texture(f"paged_{cs.PAGED_TEX_SIZE}", cs.checker_texture(cs.PAGED_TEX_SIZE),
                         scenes)
    big = m.Manager(scenes.bigmesh_config(512, 64, 64, deferred_mxu=True))
    kw = rc.pack_inputs(big.state, big.scene, height=64, width=64, deferred_mxu=True)
    if kw["order"] is None or not kw["dmxu"]:
        raise AssertionError("bigmesh_512w_dmxu: not K11 on the ordered walk")
    cases.append(("K11", "bigmesh_512w_dmxu", *k11_plans(kw)))
    prev = big.depth_tensor().to_torch().clone()
    big.instance_position_tensor().to_torch()[0][0] += 0.3
    big.step()
    far = torch.tensor(big.cfg.far_plane, dtype=torch.float32, device=dev)
    seed = torch.where(prev > 0, torch.minimum(prev * 1.01, far), far).reshape(-1, 64, 64)
    kw = dict(rc.pack_inputs(big.state, big.scene, height=64, width=64, deferred_mxu=True),
              seed=seed.contiguous())
    cases.append(("K11 seeded", "bigmesh_512w_warm (deferred_mxu)", *k11_plans(kw)))
    nine = m.Manager(scenes.bigmesh_config(512, 64, 64, texture=tex, mipmaps=False,
                                           deferred_mxu=True))
    kw = rc.pack_inputs(nine.state, nine.scene, height=64, width=64, deferred_mxu=True)
    if kw["texture"] != "nine":
        raise AssertionError("bigmesh_512w_tex256: not the 9-output mode")
    cases.append(("K11 9-output", "bigmesh_512w_tex256 (deferred_mxu)", *k11_plans(kw)))
    for cams in (1, 2):
        geo, mats, textures, insts, cam_list, worlds = cs.bigmesh_scene(
            64, cfg_mod, scenes, vary=True, num_cams=cams)
        state = init_state(insts, cam_list, worlds, dev)
        scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
        for h, w in ((64, 256),) if cams == 1 else ((64, 64), (64, 256)):
            kw = rc.pack_inputs(state, scene, height=h, width=w, accel="clusters",
                                deferred_mxu=True)
            if kw["geo"] != ("prep" if cams == 1 else "raw") or not kw["dmxu"]:
                raise AssertionError(f"{cams} cameras a world: K11 on {kw['geo']} rows")
            cases.append((f"K11 {kw['geo']}", f"bigmesh_64w_{cams}cams_{h}x{w}",
                          *k11_plans(kw)))
    for res, textured, raster in ((64, False, False), (128, False, False), (64, True, False),
                                  (64, False, True)):
        mode = m.RenderMode.Rasterizer if raster else m.RenderMode.Raytracer
        r = m.Manager(scenes.demo_config(4096, mode, res, res, dynamic=True, textured=textured,
                                         tex_size=cs.TEX_SIZE))
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, raster=raster,
                            near=0.001 if raster else 0.1, accel="mxu")
        name = ("textured_4096w_mxu" if textured else f"mxu_4096w{'_raster' if raster else ''}"
                + ("" if res == 64 else f"_{res}"))
        cases.append((rc.batched_name(raster, kw["nine"]), name, *k12_plans(kw)))
    times = [{k: [] for k in launches} for *_, launches in cases]
    for i in range(passes):
        for (_, _, _, launches), t in zip(cases, times):
            keys = list(launches)
            for k in (keys if i % 2 == 0 else keys[::-1]):
                t[k].append(cs.graph_ms(launches[k], cs.KERNEL_REPS))
    for (kernel, inputs, plan, _), t in zip(cases, times):
        means = {k: statistics.mean(v) for k, v in t.items()}
        print(json.dumps({"phase": "dense_plan_ab", "kernel": kernel, "inputs": inputs,
                          "plan": plan._asdict(), "ms": t, "mean_ms": means,
                          "fastest": min(means, key=means.get)}), flush=True)
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
