"""K7 folded and K8 on the index visit's tile teams, held bitwise to their
plain versions and to the parent design at full size, then each design
timed in turns on one card:

    python3 port_tools/mip_shadow_ab.py [OUT.jsonl]

Builds every kernel (``_build.build_all``). Then, on chip_smoke.py's
``textured256_4096w`` scene (4096 worlds at 64x64, and 1024 at 128x128)
under each mip filter, K7: the folded entry at G = 1 and 2 against the two
launches (the hand-off, then shade_mip) and the plain version, bitwise;
the wrapper's launch counts; the occupancy; and the folded entry and the
pair, CUDA events over 20 calls each, two passes in turns. On the demo
scene with shadows (4096 worlds at 64x64 and 1024 at 128x128, one and
three lights, untextured and with the 32x32 texture at 64x64), K8 likewise
against the parent design (16x16 blocks) and the plain version, and timed
with the parent. Last, ``port_tools/ptxas_regs.py build/parent`` (an unpacked
``git archive`` of the parent commit there): whether every older entry kept
its registers. One JSON line each (and to OUT.jsonl); exits 1 if a check
differs. Needs one card and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import madrona_renderer_tpu_torch as m  # noqa: E402
from madrona_renderer_tpu_torch import _build, config as cfg_mod  # noqa: E402
from madrona_renderer_tpu_torch.core.scene import configure_lighting  # noqa: E402
from madrona_renderer_tpu_torch.ops import mips  # noqa: E402
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc  # noqa: E402
from madrona_renderer_tpu_torch.runners import scenes  # noqa: E402

if not torch.cuda.is_available():
    print("mip_shadow_ab: no CUDA card", file=sys.stderr)
    sys.exit(1)
OUT = open(sys.argv[1], "w") if len(sys.argv) > 1 else None


def emit(o):
    line = json.dumps(o)
    print(line, flush=True)
    if OUT is not None:
        OUT.write(line + "\n")
        OUT.flush()


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda, "smi": smi()})
t0 = time.perf_counter()
_build.build_all()
emit({"phase": "build", "s": time.perf_counter() - t0})
LIB = {"mip": _build.load("render_mip"), "res": _build.load("render_resident")}
dev = torch.device("cuda", 0)


def P(t):
    return None if t is None else t.data_ptr()


def f32(x):
    return float(np.float32(x))


def stream():
    return torch.cuda.current_stream(dev).cuda_stream

def resident(kw, groups):
    rows, cl, cams = kw["rows"], kw["clusters"], kw["cams"]
    W, _, S = rows.shape
    CC = cl.shape[2]
    nc = kw["num_cams"]
    WC, h, w = W * nc, kw["height"], kw["width"]
    shape = (WC, h, w)
    depth = torch.empty(shape, device=dev); seg = torch.empty(shape, dtype=torch.int32, device=dev)
    rgb = torch.empty(shape, dtype=torch.int32, device=dev)
    tex = kw["texture"]
    s = tex in ("nearest", "bilinear")
    err = LIB["res"](P(rows), P(cl), P(cams), P(kw["mats"]) if s else None, P(kw["pool"]) if s else None,
                   int(kw["mats"].shape[1]) if s else 0, P(depth), P(seg), P(rgb), None, None, WC, nc,
                   S, CC, S // CC, int(cams.shape[1]), kw["n_lights"], h, w, kw["seg_div"],
                   f32(2.0 / w), f32(2.0 / h), 0, rc._TEX_CODES[tex], rc._GEO_CODES[kw["geo"]],
                   groups, stream())
    assert err == 0, err
    return depth, seg, rgb

def folded(kw, groups):
    rows, cl, cams, mats, pool = kw["rows"], kw["clusters"], kw["cams"], kw["mats"], kw["pool"]
    W, _, S = rows.shape
    CC = cl.shape[2]
    h, w = kw["height"], kw["width"]
    ts, tx, nt = mips.tile_geometry(h, w)
    shape = (W, h, w)
    depth = torch.empty(shape, device=dev); seg = torch.empty(shape, dtype=torch.int32, device=dev)
    rgb = torch.empty(shape, dtype=torch.int32, device=dev)
    err = LIB["mip"](P(rows), P(cl), P(cams), P(mats), P(pool), int(mats.shape[1]), P(depth), P(seg),
                   P(rgb), W, S, CC, S // CC, int(cams.shape[1]), kw["n_lights"], h, w, kw["seg_div"],
                   f32(2.0 / w), f32(2.0 / h), mips.num_levels(mats), kw["fb_rows"], ts, tx, nt,
                   rc._MIP_FILTER_CODES[kw["texture"]], groups, stream())
    assert err == 0, err
    return depth, seg, rgb

def pair(kw):
    d, s, code, hand = rc.render_handoff(kw["rows"], kw["clusters"], kw["cams"],
                                         **{k: kw[k] for k in cs_handoff_keys if k in kw})
    return d, s, rc.shade_mip(code, hand, kw["cams"], kw["mats"], kw["pool"], fb_rows=kw["fb_rows"],
                              texture=kw["texture"], n_lights=kw["n_lights"])

cs_handoff_keys = ("num_cams", "n_lights", "height", "width", "seg_div", "raster", "geo",
                   "order", "spans", "bins", "ranges", "bin_tile", "seed", "dmxu", "rowskip")

def ev_ms(fn, reps=20):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

def same(x, y):
    return all(torch.equal(p, q) for p, q in zip(x, y))

failed = []
def check(tag, new, ref, what):
    ok = same(new, ref)
    if not ok:
        failed.append(f"{tag} vs {what}")
    return ok

def ab(tag, fns, passes=2, reps=20):
    times = {k: [] for k in fns}
    order = list(fns)
    for p in range(passes):
        for k in (order if p % 2 == 0 else order[::-1]):
            times[k].append(ev_ms(fns[k], reps))
    emit({"phase": "ab", "case": tag, "ms": times, "mean": {k: sum(v) / len(v) for k, v in times.items()}})

# ---- K7 on textured256_4096w's scene at 64x64 and 1024 worlds at 128x128
for worlds, res in ((4096, 64), (1024, 128)):
    cfg = cs.paged_tex_config(worlds, scenes, cfg_mod)
    r = m.MadronaRenderer(0, worlds, m.RenderMode.Raytracer, res, res, **scenes.renderer_kwargs(cfg))
    for filt in ("nearest", "bilinear", "trilinear"):
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, texture_filter=filt)
        assert kw["fb_rows"] is not None and kw["geo"] == "prep"
        plan = rc.check_index_plan(kw["rows"], int(kw["clusters"].shape[2]), kw["n_lights"], "prep",
                                   worlds, res, res, "mip")
        ref = pair(kw)
        plain = rc.render_resident_plain(**kw)
        line = {"phase": "k7", "case": f"paged_{worlds}w_{res}", "filter": filt, "plan": plan._asdict(),
                "S": int(kw["rows"].shape[2]), "CC": int(kw["clusters"].shape[2]),
                "pair_vs_plain": check(f"k7 {res} {filt} pair", ref, plain, "plain")}
        for g in (1, 2):
            out = folded(kw, g)
            line[f"g{g}_vs_pair"] = check(f"k7 {res} {filt} g{g}", out, ref, "pair")
            line[f"g{g}_vs_plain"] = check(f"k7 {res} {filt} g{g}", out, plain, "plain")
        # through the wrapper: one launch
        n0 = rc.render_resident.launches
        s0 = rc.shade_mip.launches
        out = rc.render_resident(**kw)
        line["wrapper_launches"] = [rc.render_resident.launches - n0, rc.shade_mip.launches - s0]
        line["wrapper_vs_plain"] = check(f"k7 {res} {filt} wrapper", out, plain, "plain")
        line["occupancy"] = rc.index_occupancy(kw)
        emit(line)
        g = plan.groups
        ab(f"k7 paged_{worlds}w_{res} {filt}", {"folded": lambda: folded(kw, g),
                                                 "pair": lambda: pair(kw)})
        del ref, plain, out
    del r
    torch.cuda.empty_cache()

# ---- K8 on shadows_4096w's scene (the demo scene, shadows) at 64x64 and 1024 worlds at 128x128
THREE = [((1.0, -1.0, -0.05), (0.5, 0.5, 0.5)), ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2)),
         ((0.5, 1.0, -1.0), (0.2, 0.2, 0.2))]
for worlds, res, textured in ((4096, 64, False), (1024, 128, False), (4096, 64, True)):
    cfg = scenes.demo_config(worlds, m.RenderMode.Raytracer, res, res, dynamic=True,
                             textured=textured, tex_size=32)
    r = m.MadronaRenderer(0, worlds, m.RenderMode.Raytracer, res, res, shadows=True,
                          **scenes.renderer_kwargs(cfg))
    for lights in (1, 3):
        scene = r.scene if lights == 1 else configure_lighting(r.scene, lights=THREE)
        for filt in (("nearest", "bilinear") if textured else (None,)):
            kw = rc.pack_inputs(r.state, scene, height=res, width=res, shadows=True,
                                texture_filter=filt or "nearest")
            assert kw["geo"] == "raw_shadows"
            plan = rc.check_index_plan(kw["rows"], int(kw["clusters"].shape[2]), kw["n_lights"],
                                       "raw_shadows", worlds, res, res, kw["texture"])
            ref = resident(kw, 0)
            plain = rc.render_resident_plain(**kw)
            lit = resident(dict(kw, geo="raw"), 0)
            line = {"phase": "k8", "case": f"demo_{worlds}w_{res}_tex{filt}_L{lights}",
                    "plan": plan._asdict(), "S": int(kw["rows"].shape[2]),
                    "shadowed": int((lit[2] != ref[2]).sum()),
                    "parent_vs_plain": check(f"k8 {res} {lights} parent", ref, plain, "plain")}
            for g in (1, 2):
                out = resident(kw, g)
                line[f"g{g}_vs_parent"] = check(f"k8 {res} {lights} g{g}", out, ref, "parent")
                line[f"g{g}_vs_plain"] = check(f"k8 {res} {lights} g{g}", out, plain, "plain")
            out = rc.render_resident(**kw)
            line["wrapper_vs_plain"] = check(f"k8 {res} {lights} wrapper", out, plain, "plain")
            line["occupancy"] = rc.index_occupancy(kw)
            emit(line)
            g = plan.groups
            ab(f"k8 demo_{worlds}w_{res}_tex{filt}_L{lights}",
               {"teams": lambda: resident(kw, g), "parent": lambda: resident(kw, 0)})
            del ref, plain, out, lit
    del r
    torch.cuda.empty_cache()

p = subprocess.run([sys.executable, str(ROOT / "port_tools" / "ptxas_regs.py"), str(ROOT / "build" / "parent")],
                   capture_output=True, text=True)
try:
    regs = json.loads(p.stdout.strip().splitlines()[-1])
    emit({"phase": "ptxas", "other_kept": regs.get("other_kept"), "differ": regs.get("differ"),
          "new": {k: v for k, v in regs["entries"].items() if "mip_kernel" in k or "shadows_kernel" in k
                  or "index" in k}})
except Exception as e:
    emit({"phase": "ptxas", "error": str(e), "tail": p.stderr[-1500:]})
emit({"phase": "done", "failed": failed, "s": time.perf_counter() - t0, "smi": smi()})
sys.exit(1 if failed else 0)
