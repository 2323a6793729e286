"""The resident index order's team entries (K1 and K6 on prep rows, K1's
9-output mode, K1-raw, K10, K1-none, K2 and K2+K6) at forced launch plans,
held bitwise against the parent design and timed in turns in one process
on one card:

    python3 port_tools/index_plan_ab.py [PASSES] [--variants NAME,...] [CASE ...]

e.g. the raster entry's plans and pixel counts on raster_256w_png's inputs,
128, 64 and 32 of its worlds and main's rasterized:

    python3 port_tools/index_plan_ab.py 4 --variants raster_px4,raster_lb1 \
        raster_256w_png raster_256w_png_bilinear raster_128w_png raster_64w_png \
        raster_32w_png main_raster

Plans (raytrace_cuda.index_plan): the parent design ("g0": render_body's
16x16 blocks, one pixel a thread) and the index visit's tile teams at
G = 1 and 2 groups a block ("g1", "g2"). Inputs: main's (4096 worlds of
the demo scene at 64x64), mxu_4096w_128's under "auto" (the same scene at
128x128), textured_4096w's (the 32x32 checker, nearest, 64x64),
textured_4096w_ssaa2's (the same at 2x2 SSAA: 128x128), the checker's
bilinear filter at 64x64, watertight_4096w's (K10: the checker, nearest,
watertight), none_4096w's (K1-none: the demo scene under accel="none"),
K10 untextured on main's scene ("watertight_main"), K1-none on K10's
rows of none_4096w's scene ("none_wt_4096w"), K1's 9-output mode on
tex256_cliff_4096w's (chip_smoke.py's paged-texture scene baked without
mips), K1-raw on multicam_1024w4c's (1024 worlds of the demo scene, 4
cameras each), K2+K6 on raster_256w_png's (256 worlds of the 32x32-textured
demo scene rasterized, nearest; "raster_256w_png_bilinear" its bilinear
filter; "raster_128w_png", "raster_64w_png" and "raster_32w_png" 128, 64
and 32 of its worlds) and K2 on main's rasterized ("main_raster"; near =
ManagerConfig.raster_near_plane on every raster case), each the scene's
first step; CASE names a subset. With --variants, the team entries are also
built from csrc/ copied under build/index_variants/NAME/ with the edits
of VARIANTS and timed as plans "g1@NAME" and "g2@NAME" on the cases whose
entry the edits touch, called through the C entry: K10's and K1-none's
watertight entries at up to 128 registers a thread (where they are held
to 64) with 1, 2 and 4 pixels a thread ("px1_lb1", "px2_lb1",
"px4_lb1"), or with every warp on the sweep's selects, no variant with kz
fixed ("kz_generic"); K1-none's prep entry at up to 128 registers
("none_lb1"), with its sweep not unrolled ("none_unroll1"), or at 2
pixels a thread ("none_px2"); K1's 9-output entry at 2 pixels a thread
("nine_px2"), at up to 128 registers ("nine_lb1"), or both
("nine_px2_lb1"); K1-raw's likewise ("raw_px2", "raw_lb1", "raw_px2_lb1");
the raster entry's at 4 pixels a thread ("raster_px4"), at up to 128
registers ("raster_lb1"), or both ("raster_px4_lb1").

Every plan's outputs on a case are compared with the parent's first (a
plan that differs fails the run); then PASSES (4) passes time every plan of
a case in turn, each a CUDA graph of chip_smoke.KERNEL_REPS launches, the
order reversed every other pass (0: the checks and occupancy alone). Prints one JSON line per case (the plan
the wrapper takes, each plan's occupancy, times and mean, the fastest),
then the card's name and power limit. Needs one card and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

# name: (view size, textured, texture filter, ssaa, pack switches); textured
# "paged": chip_smoke.paged_tex_config's scene baked without mips; the
# switch "num_cams": the demo scene at 4096 / num_cams worlds.
CASES = {
    "main": (64, False, "nearest", 1, {}),
    "mxu_4096w_128_auto": (128, False, "nearest", 1, {}),
    "textured_4096w": (64, True, "nearest", 1, {}),
    "textured_4096w_ssaa2": (64, True, "nearest", 2, {}),
    "textured_4096w_bilinear": (64, True, "bilinear", 1, {}),
    "watertight_4096w": (64, True, "nearest", 1, dict(watertight=True)),
    "none_4096w": (64, False, "nearest", 1, dict(accel="none")),
    "watertight_main": (64, False, "nearest", 1, dict(watertight=True)),
    "none_wt_4096w": (64, False, "nearest", 1, dict(accel="none", watertight=True)),
    "tex256_cliff_4096w": (64, "paged", "nearest", 1, {}),
    "multicam_1024w4c": (64, False, "nearest", 1, dict(num_cams=4)),
    "raster_256w_png": (64, True, "nearest", 1, dict(raster=True, worlds=256)),
    "raster_256w_png_bilinear": (64, True, "bilinear", 1, dict(raster=True, worlds=256)),
    "raster_128w_png": (64, True, "nearest", 1, dict(raster=True, worlds=128)),
    "raster_64w_png": (64, True, "nearest", 1, dict(raster=True, worlds=64)),
    "raster_32w_png": (64, True, "nearest", 1, dict(raster=True, worlds=32)),
    "main_raster": (64, False, "nearest", 1, dict(raster=True)),
}
RASTER_NEAR = 0.001  # ManagerConfig.raster_near_plane
WORLDS = 4096
# name: ([(source, pattern, replacement), ...], the entries it touches, by
# raytrace_cuda.index_entry_key)
_WT = {"raw_wt", "none_raw_wt"}
_NONE = {"none"}
_PX = r"constexpr int kWtPixels = \d+;"


def _lb1(source, kernel):
    """``kernel``'s entry in ``source`` at up to 128 registers a thread."""
    return (source, r"__launch_bounds__\(kThreads \* kIndexMaxGroups, 4 / kIndexMaxGroups\)\n"
                    rf"({kernel})", r"__launch_bounds__(kThreads * kIndexMaxGroups, 1)\n\1")


_NINE_PX2 = ("render_none.cu", r"constexpr int kNinePixels = \d+;",
             "constexpr int kNinePixels = 2;")
_NINE_LB1 = _lb1("render_none.cu", "render_resident_nine_index_kernel")
_RAW_PX2 = ("render_resident.cu", r"constexpr int kRawPixels = \d+;",
            "constexpr int kRawPixels = 2;")
_RAW_LB1 = _lb1("render_resident.cu", "render_index_raw_kernel")
_RASTER_PX4 = ("render_resident.cu", r"constexpr int kRasterPixels = \d+;",
               "constexpr int kRasterPixels = 4;")
_RASTER_LB1 = _lb1("render_resident.cu", "render_index_raster_kernel")
# K10's and K1-none's watertight entries at up to 128 registers a thread.
_WT_LB1 = [(source, r"__launch_bounds__\(kThreads \* kIndexMaxGroups, 4 / kIndexMaxGroups\)\n"
                    r"(render_(?:none_)?index_wt_kernel)",
            r"__launch_bounds__(kThreads * kIndexMaxGroups, 1)\n\1")
           for source in ("render_resident.cu", "render_none.cu")]
VARIANTS = {
    "px1_lb1": ([("render_resident.cu", _PX, "constexpr int kWtPixels = 1;")] + _WT_LB1, _WT),
    "px2_lb1": (_WT_LB1, _WT),
    "px4_lb1": ([("render_resident.cu", _PX, "constexpr int kWtPixels = 4;")] + _WT_LB1, _WT),
    "kz_generic": ([("render_resident.cu", r"  kw = same \? kw : -1;", "  kw = -1;")], _WT),
    "none_lb1": ([("render_none.cu",
                   r"__launch_bounds__\(kThreads \* kIndexMaxGroups, 4 / kIndexMaxGroups\)\n"
                   r"render_none_index_kernel",
                   "__launch_bounds__(kThreads * kIndexMaxGroups, 1)\nrender_none_index_kernel")],
                 _NONE),
    "none_unroll1": ([("render_resident.cu",
                       r"(    MRT_PHASE\(2\);\n)(    for \(int i = 0; i < S; \+\+i\) \{\n)",
                       r"\1#pragma unroll 1\n\2")], _NONE),
    "none_px2": ([("render_resident.cu", r"constexpr int kNonePixels = \d+;",
                   "constexpr int kNonePixels = 2;")], _NONE),
    "nine_px2": ([_NINE_PX2], {"nine"}),
    "nine_lb1": ([_NINE_LB1], {"nine"}),
    "nine_px2_lb1": ([_NINE_PX2, _NINE_LB1], {"nine"}),
    "raw_px2": ([_RAW_PX2], {"raw"}),
    "raw_lb1": ([_RAW_LB1], {"raw"}),
    "raw_px2_lb1": ([_RAW_PX2, _RAW_LB1], {"raw"}),
    "raster_px4": ([_RASTER_PX4], {"raster"}),
    "raster_lb1": ([_RASTER_LB1], {"raster"}),
    "raster_px4_lb1": ([_RASTER_PX4, _RASTER_LB1], {"raster"}),
}


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_variant(name: str) -> dict:
    """render_resident.cu and render_none.cu built with the edits VARIANTS
    names (a copy of csrc/ under build/index_variants/), their C entries
    bound as the port's loader binds them."""
    from madrona_renderer_tpu_torch import _build

    edits, _ = VARIANTS[name]
    out = HERE / "build" / "index_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    for source, pattern, replacement in edits:
        src = out / "csrc" / source
        text, n = re.subn(pattern, replacement, src.read_text())
        if n < 1:
            raise RuntimeError(f"{source} has no match for the variant {name}")
        src.write_text(text)

    def build(name):
        lib = out / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "csrc" / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}.cu ({out.name}):\n{proc.stderr[-3000:]}")
        handle = ctypes.CDLL(str(lib))
        fn = getattr(handle, _build.SIGNATURES[name][0])
        fn.argtypes = _build.SIGNATURES[name][1]
        fn.restype = ctypes.c_int
        fn.occupancy = getattr(handle, f"mrt_{name}_occupancy")
        if name == "render_none":
            fn.nine_occupancy = handle.mrt_render_none_nine_occupancy
        return fn

    with ThreadPoolExecutor(2) as pool:
        names = ("render_resident", "render_none")
        return dict(zip(names, pool.map(build, names)))


def variant_occupancy(rc, fn, kw, groups) -> dict:
    """What the card makes of a variant's entry: threads a block,
    registers and local memory a thread, blocks a multiprocessor."""
    culled = kw["clusters"] is not None
    S, n_cols = int(kw["rows"].shape[2]), int(kw["cams"].shape[1])
    out = (ctypes.c_int * 4)()
    head = [rc._GEO_CODES[kw["geo"]], rc._TEX_CODES[kw["texture"]], groups, S]
    if kw["texture"] == "nine":
        err = fn.nine_occupancy(rc._GEO_CODES[kw["geo"]], groups, S, int(kw["clusters"].shape[2]),
                                n_cols, kw["n_lights"], out)
    elif culled:
        err = fn.occupancy(head[0], int(kw["raster"]), *head[1:], int(kw["clusters"].shape[2]),
                           n_cols, kw["n_lights"], out)
    else:
        err = fn.occupancy(*head, n_cols, kw["n_lights"], out)
    if err:
        raise RuntimeError(f"the variant's occupancy query failed: {err}")
    threads, registers, local, blocks = list(out)
    return {"threads": threads, "registers": registers, "local_bytes": local,
            "blocks_per_sm": blocks}


def direct(torch, rc, fn, kw, groups):
    """One launch of a team entry through its C entry ``fn``
    (render_resident's, or render_none's without clusters and in the
    9-output mode); (depth, segmask, rgb), or the 9-output mode's nine
    outputs as render_resident returns them."""
    rows, cl, cams = kw["rows"], kw["clusters"], kw["cams"]
    W, _, S = rows.shape
    CC = 0 if cl is None else int(cl.shape[2])
    views, h, w = W * kw["num_cams"], kw["height"], kw["width"]
    dev = rows.device
    depth = torch.empty((views, h, w), dtype=torch.float32, device=dev)
    seg = torch.empty((views, h, w), dtype=torch.int32, device=dev)
    nine = kw["texture"] == "nine"
    # The 9-output mode writes the material and six f32 planes instead of rgb.
    rgb = code = torch.empty((views, h, w), dtype=torch.int32, device=dev)
    if nine:
        planes = torch.empty((rc._NINE_PLANES, views, h, w), dtype=torch.float32, device=dev)
    sampled = kw["texture"] in ("nearest", "bilinear")
    head = [rows.data_ptr(), None if cl is None else cl.data_ptr(), cams.data_ptr(),
            kw["mats"].data_ptr() if sampled else None,
            kw["pool"].data_ptr() if sampled else None,
            int(kw["mats"].shape[1]) if sampled else 0, depth.data_ptr(), seg.data_ptr(),
            None if nine else rgb.data_ptr(), code.data_ptr() if nine else None,
            planes.data_ptr() if nine else None]
    params = [views, kw["num_cams"], S, CC, S // max(CC, 1), int(cams.shape[1]), kw["n_lights"],
              h, w, kw["seg_div"], float(np.float32(2.0 / w)), float(np.float32(2.0 / h)),
              int(kw["raster"]), rc._TEX_CODES[kw["texture"]], rc._GEO_CODES[kw["geo"]]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = (fn(*head, None, *params, int(cl is not None), groups, stream)
           if cl is None or nine else fn(*head, *params, groups, stream))
    if err:
        raise RuntimeError(f"the variant's launch failed: {err}")
    return (depth, planes[0], seg, code, *planes[1:]) if nine else (depth, seg, rgb)


def main() -> int:
    args = sys.argv[1:]
    names = []
    if "--variants" in args:
        i = args.index("--variants")
        names = args[i + 1].split(",")
        del args[i:i + 2]
    passes = int(args.pop(0)) if args and args[0].isdigit() else 4
    import torch

    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    if not torch.cuda.is_available():
        print("index_plan_ab: no CUDA card", file=sys.stderr)
        return 1
    cs = chip_smoke()
    real = rc.index_plan
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        variants = dict(zip(names, pool.map(build_variant, names)))

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
    for name in args or list(CASES):
        res, textured, filt, ssaa, switches = CASES[name]
        switches = dict(switches)
        cams = switches.pop("num_cams", 1)
        worlds = switches.pop("worlds", WORLDS)
        raster = switches.get("raster", False)
        if raster:
            switches["near"] = RASTER_NEAR
        if textured == "paged":
            from madrona_renderer_tpu_torch import config as cfg_mod
            cfg = cs.paged_tex_config(WORLDS, scenes, cfg_mod)
            r = m.MadronaRenderer(0, WORLDS, m.RenderMode.Raytracer, res, res, mipmaps=False,
                                  **scenes.renderer_kwargs(cfg))
        else:
            mode = m.RenderMode.Rasterizer if raster else m.RenderMode.Raytracer
            r = m.Manager(scenes.demo_config(worlds // cams, mode, res, res,
                                             dynamic=switches.get("accel") != "none",
                                             textured=textured, tex_size=cs.TEX_SIZE,
                                             texture_filter=filt, ssaa=ssaa, num_cams=cams))
        kw = rc.pack_inputs(r.state, r.scene, height=res * ssaa, width=res * ssaa,
                            texture_filter=filt, **switches)
        culled = kw["clusters"] is not None
        route = rc.route_of(kw["order"], kw["spans"], kw["bins"], culled)
        if route not in (rc.INDEX, rc.NONE):
            raise AssertionError(f"{name}: not the resident index order")
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
        lib = "render_resident" if culled and kw["texture"] != "nine" else "render_none"
        for v, fns in variants.items():
            entry = rc.index_entry_key(kw["geo"], culled, kw["texture"], kw["raster"])
            if entry not in VARIANTS[v][1]:
                continue
            for g in rc._INDEX_GROUP_CHOICES:
                key = f"g{g}@{v}"
                out = direct(torch, rc, fns[lib], kw, g)
                torch.cuda.synchronize()
                same[key] = all(torch.equal(a, b) for a, b in zip(out, ref))
                launches[key] = lambda f=fns[lib], kw=kw, g=g: direct(torch, rc, f, kw, g)
                occupancy[key] = variant_occupancy(rc, fns[lib], kw, g)
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
        means = {k: statistics.mean(v) for k, v in t.items() if v}
        culled = kw["clusters"] is not None
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2]) if culled else 0
        plan = real(kw["geo"], S, CC, kw["n_lights"], int(kw["cams"].shape[0]), kw["height"],
                    kw["width"], kw["texture"], raster=kw["raster"], culled=culled)
        print(json.dumps({"phase": "index_plan_ab", "inputs": name, "plan": plan._asdict(),
                          "occupancy": occupancy, "ms": t, "mean_ms": means,
                          "fastest": min(means, key=means.get, default=None)}), flush=True)
    print(json.dumps({"phase": "nvidia_smi", "name_power_limit": cs.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
