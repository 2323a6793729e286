"""K13 and every render-kernel entry that two source trees share, timed in
turns on one card: this tree and OTHER (an unpacked `git archive` of
another commit, e.g. the parent, under a directory that .gitignore lists):

    python3 port_tools/tree_ab.py OTHER [PASSES]

Each pass is a child process that imports the port from one tree (which
builds its kernels into that tree's build/) and times, each a CUDA graph
of 50 launches on the same inputs (the scenes' first step, 64x64):
  pack_rows            K13 on main's 4096 worlds (the demo scene);
  render_resident      K1 on main's inputs;
  render_resident_raster_tex_bilinear
                       K2 + K6 bilinear on raster_256w_png's inputs (256
                       worlds of the textured demo);
  and every variant of csrc/render_resident.cu (resident and streamed)
  and csrc/render_binned.cu on 64 worlds: the resident ones on the demo
  scene (untextured, with the 32x32 texture, or chip_smoke.py's 256x256
  gradient floor for the mip hand-off), the streamed and binned ones on
  chip_smoke.py's varied big-mesh terrain (likewise), each geometry code
  from pack_inputs (the raw sweep on K13's raw rows), keyed "@64w";
  and the resident visits at the resident terrain paths' full size (the
  27-grid terrain, CUDA events over 5 launches of the first step's
  inputs): K3 and K4 on resident rows at 4096 worlds x 64x64, K4 at 1024
  x 128x128, and K3's 9-output mode on resident_terrain_4096w_64_tex256's
  inputs (the 256x256 checker baked without mips); and the streamed
  ordered walk (K3 + K5) at its paths' full size, likewise: on
  bigmesh_512w's inputs (512 worlds of the 72-grid terrain at 64x64), in
  its 9-output mode on bigmesh_512w_tex256's, seeded (K9) on a warm step's
  of bigmesh_512w_warm (the seed from the depth of the step before, world
  0's terrain moved between), and on the binned terrain paths' A/B (32
  worlds of the 224-grid terrain under accel="clusters" at 128x128,
  256x256 and 512x512); and the streamed binned walk at its paths' full
  size (BINNED_FULL): K4 on binned_32w_128's, binned_32w_256's and
  terrain_32w_512's inputs, K11 on dmxu_32w_512's and at 128x128; K11 on
  the streamed ordered walk (DMXU_FULL) on bigmesh_512w_dmxu's inputs, in
  its 9-output mode on bigmesh_512w_tex256's under deferred_mxu, and with
  its row gate on 64 worlds of chip_smoke.py's varied big-mesh terrain at
  64x256 (accel="clusters"); and K12 (BATCHED_FULL) on mxu_4096w's,
  mxu_4096w_128's and textured_4096w_mxu's inputs and rasterized on 4096
  worlds of the demo scene at 64x64.
PASSES (4) alternate this tree and OTHER, starting with this one. Prints
one JSON line per pass and then one with each kernel's times and OTHER's
over this tree's mean, with the card's name and power limit. Needs one
card and nvcc.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
GEOS = ("prep", "raw", "raw_shadows", "raw_wt", "raw_wt_shadows")
TEXTURES = (None, "nearest", "bilinear", "mip")
ROUTES = {"resident": "render_resident", "streamed": "render_streamed",
          "binned": "render_binned"}
# The resident visits at full size: key → (worlds, size, accel, textured).
RESIDENT_FULL = {
    "render_resident_ordered@4096w_64": (4096, 64, "auto", False),
    "render_resident_binned@4096w_64": (4096, 64, "binned", False),
    "render_resident_binned@1024w_128": (1024, 128, "auto", False),
    "render_resident_ordered_nine@4096w_64_tex256": (4096, 64, "auto", True),
}
# The streamed ordered walk at full size: key → (scene, worlds, size, accel,
# mode): "bigmesh" (bench.py's big mesh; mode "cold", "nine" with the
# 256x256 checker baked without mips, or "seeded") or "terrain" (the binned
# terrain).
STREAMED_FULL = {
    "render_streamed@bigmesh_512w": ("bigmesh", 512, 64, "auto", "cold"),
    "render_streamed_nine@bigmesh_512w_tex256": ("bigmesh", 512, 64, "auto", "nine"),
    "render_streamed_seeded@bigmesh_512w_warm": ("bigmesh", 512, 64, "auto", "seeded"),
    "render_streamed@binned_32w_128_clusters": ("terrain", 32, 128, "clusters", "cold"),
    "render_streamed@binned_32w_256_clusters": ("terrain", 32, 256, "clusters", "cold"),
    "render_streamed@terrain_32w_512_clusters": ("terrain", 32, 512, "clusters", "cold"),
}
# The streamed binned walk at full size (K4 and K11 on the binned visit):
# key → (worlds, size, accel, deferred_mxu) of the binned terrain.
BINNED_FULL = {
    "render_binned@binned_32w_128": (32, 128, "auto", False),
    "render_binned@binned_32w_256": (32, 256, "auto", False),
    "render_binned@terrain_32w_512": (32, 512, "binned", False),
    "render_binned_dmxu@dmxu_32w_512": (32, 512, "binned", True),
    "render_binned_dmxu@dmxu_32w_128": (32, 128, "binned", True),
}
# K11 on the streamed ordered walk: key → (worlds, height, width, scene):
# "bigmesh" (bench.py's big mesh), "nine" (textured with the 256x256 checker
# baked without mips) or "varied" (chip_smoke.py's varied terrain).
DMXU_FULL = {
    "render_streamed_dmxu@bigmesh_512w_dmxu": (512, 64, 64, "bigmesh"),
    "render_streamed_dmxu_nine@bigmesh_512w_tex256": (512, 64, 64, "nine"),
    "render_streamed_dmxu@64w_64x256": (64, 64, 256, "varied"),
}
# K12 at full size: key → (size, textured: the 9-output mode, raster).
BATCHED_FULL = {
    "render_batched@mxu_4096w": (64, False, False),
    "render_batched@mxu_4096w_128": (128, False, False),
    "render_batched_nine@textured_4096w_mxu": (64, True, False),
    "render_batched_raster@4096w": (64, False, True),
}
HANDOFF_KEYS = ("num_cams", "n_lights", "height", "width", "seg_div", "raster", "geo",
                "order", "spans", "bins", "ranges", "bin_tile")


def this_chip_smoke():
    """This tree's chip_smoke module (its scenes, timing helpers and
    nvidia_smi)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def variant_name(route: str, geo: str, raster: bool, texture) -> str:
    """The variant's name, in the form both trees give it."""
    name = ROUTES[route] + ("" if geo == "prep" else f"_{geo}")
    return name + ("_raster" if raster else "") + (f"_tex_{texture}" if texture else "")


def variants(cs, dev):
    """(name, launch) for every variant of the two sources, on 64 worlds."""
    import madrona_renderer_tpu_torch.config as cfg_mod
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene
    from madrona_renderer_tpu_torch.core.state import init_state
    from madrona_renderer_tpu_torch.ops import pack_cuda
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    def build(parts):
        geo, mats, textures, insts, cams, worlds = parts
        return (init_state(insts, cams, worlds, dev),
                bake_scene(load_render_assets(geo, [], mats, textures), dev))

    n = cs.SMALL_WORLDS
    tex = scenes.demo_texture_png(cs.TEX_SIZE)
    grad = cs.png_texture("gradient_256", cs.gradient_texture(), scenes)
    inputs = {
        "resident": {None: build(cs.demo_scene(n, True, scenes, cfg_mod)),
                     "tex": build(cs.demo_scene(n, True, scenes, cfg_mod, textured=True)),
                     "mip": build(cs.mip_scene("gradient", n, cfg_mod, grad))},
        "streamed": {None: build(cs.bigmesh_scene(n, cfg_mod, scenes, vary=True)),
                     "tex": build(cs.bigmesh_scene(n, cfg_mod, scenes, vary=True, texture=tex)),
                     "mip": build(cs.bigmesh_scene(n, cfg_mod, scenes, vary=True,
                                                   texture=grad))},
    }
    for route, geo, raster, texture in itertools.product(ROUTES, GEOS, (False, True),
                                                         TEXTURES):
        key = None if texture is None else "mip" if texture == "mip" else "tex"
        state, scene = inputs["resident" if route == "resident" else "streamed"][key]
        kw = rc.pack_inputs(state, scene, height=64, width=64, raster=raster,
                            near=0.001 if raster else 0.1,
                            texture_filter=texture if texture in ("nearest", "bilinear")
                            else "nearest",
                            shadows=geo.endswith("_shadows"), watertight=geo.startswith("raw_wt"),
                            accel="binned" if route == "binned" else "auto")
        if geo == "raw":
            kw = dict(kw, rows=pack_cuda.pack_rows(state, scene), geo="raw", ranges=None)
        if texture == "mip":
            hw = {k: kw[k] for k in HANDOFF_KEYS}
            yield (variant_name(route, geo, raster, texture) + "@64w",
                   lambda kw=kw, hw=hw: rc.render_handoff(kw["rows"], kw["clusters"],
                                                          kw["cams"], **hw))
        else:
            yield (variant_name(route, geo, raster, texture) + "@64w",
                   lambda kw=kw: rc.render_resident(**kw))


def one_pass(root: Path) -> dict:
    """Times the kernels with the port of ``root``; this tree's chip_smoke
    for the scenes, the timing and the card's description."""
    sys.path.insert(0, str(root))
    cs = this_chip_smoke()
    import torch

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
    del raster, kw
    for name, fn in variants(cs, torch.device("cuda", 0)):
        out[name] = cs.graph_ms(fn, cs.KERNEL_REPS)
    from madrona_renderer_tpu_torch.runners import scenes

    tex = cs.png_texture(f"paged_{cs.PAGED_TEX_SIZE}", cs.checker_texture(cs.PAGED_TEX_SIZE),
                         scenes)
    for key, (worlds, res, accel, textured) in RESIDENT_FULL.items():
        extra = dict(texture=tex, mipmaps=False) if textured else {}
        r = m.Manager(scenes.bigmesh_config(worlds, res, res, grid=cs.RESIDENT_GRID, **extra))
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, accel=accel)
        name = rc.variant_name(False, kw["texture"], kw["geo"],
                               rc.route_of(kw["order"], kw["spans"], kw["bins"]))
        if name != key.split("@")[0]:
            raise AssertionError(f"{key}: the inputs take {name}")
        out[key] = cs.cuda_ms(lambda kw=kw: rc.render_resident(**kw), 5)
        del r, kw
        torch.cuda.empty_cache()
    for key, (kind, worlds, res, accel, mode) in STREAMED_FULL.items():
        kw = streamed_inputs(m, rc, scenes, tex, kind, worlds, res, accel, mode)
        name = rc.variant_name(False, kw["texture"], kw["geo"],
                               rc.route_of(kw["order"], kw["spans"], kw["bins"]),
                               kw.get("seed") is not None)
        if name != key.split("@")[0]:
            raise AssertionError(f"{key}: the inputs take {name}")
        out[key] = cs.cuda_ms(lambda kw=kw: rc.render_resident(**kw), 5)
        del kw
        torch.cuda.empty_cache()
    for key, (worlds, res, accel, dmxu) in BINNED_FULL.items():
        r = m.Manager(scenes.binned_terrain_config(worlds, res, res, accel=accel,
                                                   deferred_mxu=dmxu))
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, accel=accel,
                            deferred_mxu=dmxu)
        name = rc.variant_name(False, kw["texture"], kw["geo"],
                               rc.route_of(kw["order"], kw["spans"], kw["bins"]), False, dmxu)
        if name != key.split("@")[0]:
            raise AssertionError(f"{key}: the inputs take {name}")
        out[key] = cs.cuda_ms(lambda kw=kw: rc.render_resident(**kw), 5)
        del r, kw
        torch.cuda.empty_cache()
    import madrona_renderer_tpu_torch.config as cfg_mod
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene
    from madrona_renderer_tpu_torch.core.state import init_state

    for key, (worlds, h, w, kind) in DMXU_FULL.items():
        if kind == "varied":
            geo, mats, textures, insts, cams, ws = cs.bigmesh_scene(worlds, cfg_mod, scenes,
                                                                    vary=True)
            dev = torch.device("cuda", 0)
            state = init_state(insts, cams, ws, dev)
            scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
        else:
            extra = dict(texture=tex, mipmaps=False) if kind == "nine" else {}
            r = m.Manager(scenes.bigmesh_config(worlds, w, h, deferred_mxu=True, **extra))
            state, scene = r.state, r.scene
        kw = rc.pack_inputs(state, scene, height=h, width=w, accel="clusters",
                            deferred_mxu=True)
        name = rc.variant_name(False, kw["texture"], kw["geo"],
                               rc.route_of(kw["order"], kw["spans"], kw["bins"]), False, True)
        if name != key.split("@")[0]:
            raise AssertionError(f"{key}: the inputs take {name}")
        out[key] = cs.cuda_ms(lambda kw=kw: rc.render_resident(**kw), 5)
        del kw, state, scene
        torch.cuda.empty_cache()
    for key, (res, textured, raster) in BATCHED_FULL.items():
        mode = m.RenderMode.Rasterizer if raster else m.RenderMode.Raytracer
        r = m.Manager(scenes.demo_config(4096, mode, res, res, dynamic=True, textured=textured,
                                         tex_size=cs.TEX_SIZE))
        kw = rc.pack_inputs(r.state, r.scene, height=res, width=res, raster=raster,
                            near=0.001 if raster else 0.1, accel="mxu")
        if rc.batched_name(raster, kw["nine"]) != key.split("@")[0]:
            raise AssertionError(f"{key}: the inputs take {rc.batched_name(raster, kw['nine'])}")
        out[key] = cs.cuda_ms(lambda kw=kw: rc.render_batched(**kw), 5)
        del r, kw
        torch.cuda.empty_cache()
    return out


def streamed_inputs(m, rc, scenes, tex, kind, worlds, res, accel, mode) -> dict:
    """pack_inputs' tensors of one STREAMED_FULL entry."""
    import torch

    if kind == "terrain":
        r = m.Manager(scenes.binned_terrain_config(worlds, res, res, accel=accel))
        return rc.pack_inputs(r.state, r.scene, height=res, width=res, accel=accel)
    extra = dict(texture=tex, mipmaps=False) if mode == "nine" else {}
    r = m.Manager(scenes.bigmesh_config(worlds, res, res, **extra))
    if mode != "seeded":
        return rc.pack_inputs(r.state, r.scene, height=res, width=res, accel=accel)
    prev = r.depth_tensor().to_torch().clone()
    r.instance_position_tensor().to_torch()[0][0] += 0.3
    r.step()
    far = torch.tensor(r.cfg.far_plane, dtype=torch.float32, device=prev.device)
    seed = torch.where(prev > 0, torch.minimum(prev * 1.01, far), far).contiguous()
    seed = seed.reshape(-1, res, res)
    return dict(rc.pack_inputs(r.state, r.scene, height=res, width=res, accel=accel), seed=seed)


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
    for k in results[0]:
        if k in ("phase", "tree"):
            continue
        mine = [r[k] for r, t in zip(results, trees) if t == HERE]
        theirs = [r[k] for r, t in zip(results, trees) if t == other]
        summary[k] = {"this_ms": mine, "other_ms": theirs,
                      "other_over_this": [x / statistics.mean(mine) for x in theirs]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
