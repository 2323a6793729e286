"""PyTorch port: the 9-output mode on every culled visit == the JAX package's.

A textured pool past the in-kernel route's 16,384 texels, baked without mip
chains, takes the JAX ``render_core``'s 9-output mode whatever the visit
(:4050-4073): K3 and K4 on resident rows, K3 + K5 and K4 streamed (on prep
rows row-sorted, with triangle ranges), and K11 (``MRT_DEFERRED_MXU=1``) on
both streamed visits. The port takes the same visit with ``texture="nine"``
(its kernels' entries in their routes' sources; on the CPU the plain
version, which sweeps every triangle whatever the visit) and shades in the
epilogue (``frames_from_core``). On the terrain of
``tools/tpu_bigmesh_bench.py`` at a 12 grid (resident, 4+ clusters) and a
40 grid (past the 384 KB budget), textured with tests/test_torch_epilogue.py's
144×144 checker (20,736 texels), held against the JAX package on the same
inputs at tests/test_pallas_parity.py's bar (rgb ±1 LSB, depth
rtol = atol = 1e-5, segmask exact):
  * the visit inputs ``pack_inputs`` builds and the kernel entry each launch
    names; the nine outputs bitwise the same on every visit of a scene;
  * frames against the Pallas kernel in interpret mode and the jnp
    reference (nearest; under K11 each JAX call traced afresh with
    ``MRT_DEFERRED_MXU=1``, as tests/test_torch_dmxu.py does), bilinear and
    shadows (the epilogue's ``compute_lit``) against the jnp reference, and
    rasterized;
  * the warm start bitwise a cold render, the replayed walks bitwise the
    plain version's t and idx, and ``MadronaRenderer`` on each visit.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import madrona_renderer_tpu.config as jcfg
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.assets.importer import load_render_assets as j_load
from madrona_renderer_tpu.core.scene import bake_scene as j_bake
from madrona_renderer_tpu.core.scene import configure_lighting as j_light
from madrona_renderer_tpu.core.state import init_state as j_init
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu_torch.assets.png import write_png
from madrona_renderer_tpu_torch.ops import raster_cuda, walk_replay, warmstart
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config, renderer_kwargs

from tests.fixtures import make_checker_png
from tests.test_torch_dmxu import _jax_dmxu
from tests.torch_helpers import assert_frames_close, carry_over, one_thread, terrain_spec

SIZE = 16
SUN = [((0.5, 1.0, -1.0), (1.0, 1.0, 1.0))]
# name: (terrain grid, accel, deferred_mxu, the visit, the kernel's library)
ROUTES = {
    "resident_ordered": (12, "auto", False, trc.Route(False, "ordered"),
                         "render_resident_ordered"),
    "resident_binned": (12, "binned", False, trc.Route(False, "binned"),
                        "render_resident_binned"),
    "streamed_ordered": (40, "auto", False, trc.Route(True, "ordered"), "render_streamed"),
    "streamed_binned": (40, "binned", False, trc.Route(True, "binned"), "render_binned"),
    "dmxu_ordered": (40, "auto", True, trc.Route(True, "ordered"), "render_dmxu"),
    "dmxu_binned": (40, "binned", True, trc.Route(True, "binned"), "render_binned"),
}


@pytest.fixture(scope="module")
def tex_png(tmp_path_factory):
    """The 144×144 checker (20,736 texels: past the in-kernel route's)."""
    path = str(tmp_path_factory.mktemp("nine") / "big.png")
    write_png(path, make_checker_png(144, 16))
    return path


def _textured_spec(grid, path, num_cams=1):
    """terrain_spec's scene (one world at the resident 12 grid, whose
    interpreted Pallas walk is the slow one; two at 40) with the terrain's
    uvs its xy / 8 and its material textured (the cube stays untextured)."""
    spec = terrain_spec(n_worlds=1 if grid == 12 else 2, grid=grid, num_cams=num_cams)
    spec.uvs = [spec.meshes[0][:, :2] / 8.0, np.zeros((len(spec.meshes[1]), 2), np.float32)]
    spec.textures, spec.material_textures = [path], [0, -1]
    return spec


@functools.cache
def _built(grid, path, lit=False, num_cams=1):
    """The scene baked by the JAX package with mipmaps=False (``lit``: under
    SUN) and carried over, once a worker: the tests only read it."""
    geo, mats, insts, cams, worlds = _textured_spec(grid, path, num_cams)._parts(jcfg)
    j_scene = j_bake(j_load(geo, [], mats, [path]), mipmaps=False)
    if lit:
        j_scene = j_light(j_scene, lights=SUN)
    j_state = j_init(insts, cams, worlds)
    t_state, t_scene = carry_over(j_state, j_scene)
    assert int(t_scene.tex_data.shape[0]) > 128 * 128 and not trc.has_mips(t_scene)
    assert trc.is_streamed(t_state, t_scene) == (grid == 40)
    return (j_state, j_scene), (t_state, t_scene)


def _route(name, path, **kw):
    grid, accel, dmxu, _, _ = ROUTES[name]
    (j_state, j_scene), (t_state, t_scene) = _built(grid, path, **kw)
    opts = dict(height=SIZE, width=SIZE, accel=accel, deferred_mxu=dmxu)
    return (j_state, j_scene), (t_state, t_scene), opts


@functools.cache
def _j_ref(grid, path, texture_filter="nearest", shadows=False):
    (j_state, j_scene), _ = _built(grid, path, lit=shadows)
    return j_ref(j_state, j_scene, height=SIZE, width=SIZE, texture_filter=texture_filter,
                 shadows=shadows)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_inputs_and_entries(name, tex_png):
    """pack_inputs gives the 9-output mode with the visit's own inputs (the
    streamed binned visit's row-sorted rows and ranges, none under K11);
    each launch names an entry of its route's library that RENDER_VARIANTS
    lists, seeded too; the plain outputs are those of the scene's other
    visits, bitwise."""
    _, (t_state, t_scene), opts = _route(name, tex_png)
    *_, route, library = ROUTES[name]
    kw = trc.pack_inputs(t_state, t_scene, **opts)
    assert kw["texture"] == "nine" and kw["mats"] is None and kw["geo"] == "prep"
    assert trc.route_of(kw["order"], kw["spans"], kw["bins"]) == route
    assert kw["dmxu"] == opts["deferred_mxu"] and not kw["rowskip"]
    assert (kw["spans"] is not None) == route.streamed
    ranged = route == trc.Route(True, "binned") and not kw["dmxu"]
    assert (kw["ranges"] is not None) == ranged
    if ranged:  # row 10: the original index of each sorted lane
        perm = kw["rows"][:, trc._N_PREP_ROWS].long()
        assert not torch.equal(perm[0], torch.arange(perm.shape[1]))
    for seeded in (False, True):
        name_ = trc.variant_name(False, "nine", "prep", route, seeded, kw["dmxu"])
        assert name_ in trc.CULLED_NINE_VARIANTS and name_ in trc.RENDER_VARIANTS
        assert trc.library_of(route, seeded, "nine", kw["dmxu"]) == library
    outs = trc.render_resident(**kw)
    assert len(outs) == 9 and outs[3].dtype == torch.int32
    other = {"resident_ordered": "resident_binned", "resident_binned": "resident_ordered",
             "streamed_ordered": "streamed_binned"}.get(name, "streamed_ordered")
    okw = trc.pack_inputs(t_state, t_scene, **_route(other, tex_png)[2])
    for a, b in zip(outs, trc.render_resident(**okw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_frames_match_jax(name, tex_png, monkeypatch):
    """The route's frames (nearest) against the jnp reference and the JAX
    Pallas kernel in interpret mode on the same visit (K11's under
    MRT_DEFERRED_MXU=1, traced afresh; the other streamed visits traced
    afresh without it, since the jitted JAX raytrace reads the variable only
    while it traces)."""
    (j_state, j_scene), (t_state, t_scene), opts = _route(name, tex_png)
    port = trc.raytrace(t_state, t_scene, **opts)
    assert_frames_close(_j_ref(ROUTES[name][0], tex_png), port)
    kw = dict(height=SIZE, width=SIZE, interpret=True, accel=opts["accel"])
    if opts["deferred_mxu"]:
        pallas, _ = _jax_dmxu(monkeypatch, j_pallas, j_state, j_scene, **kw)
    else:
        monkeypatch.delenv("MRT_DEFERRED_MXU", raising=False)
        if ROUTES[name][3].streamed:
            jax.clear_caches()
        pallas = j_pallas(j_state, j_scene, **kw)
    assert_frames_close(pallas, port)
    seg = port.segmask.numpy()
    assert (seg == 0).any() and (seg == 1).any()
    assert len(np.unique(port.rgb.numpy().reshape(-1, 4), axis=0)) > 8  # the checker shows


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_bilinear_shadows_and_raster_match_jax(name, tex_png):
    """Bilinear filtering and, lit by a sun, the shadow epilogue (K11 gives
    way to the route's cold visit under shadows, as in the JAX package)
    against the jnp reference; rasterized against the jnp rasterizer (depth
    z, no segmask)."""
    grid = ROUTES[name][0]
    _, (t_state, t_scene), opts = _route(name, tex_png)
    port = trc.raytrace(t_state, t_scene, texture_filter="bilinear", **opts)
    assert_frames_close(_j_ref(grid, tex_png, "bilinear"), port)
    _, (_, lit), _ = _route(name, tex_png, lit=True)
    kw = trc.pack_inputs(t_state, lit, shadows=True, **opts)
    assert kw["texture"] == "nine" and kw["geo"] == "raw" and not kw["dmxu"]
    shadowed = trc.raytrace(t_state, lit, shadows=True, **opts)
    assert_frames_close(_j_ref(grid, tex_png, shadows=True), shadowed)
    unshadowed = trc.raytrace(t_state, lit, **opts).rgb.numpy()[..., :3].astype(int)
    assert (unshadowed - shadowed.rgb.numpy()[..., :3] > 10).any()
    (j_state, j_scene), _ = _built(grid, tex_png)
    raster = raster_cuda.rasterize(t_state, t_scene, **opts)
    assert_frames_close(j_raster_ref(j_state, j_scene, height=SIZE, width=SIZE), raster)
    assert (raster.segmask.numpy() == -1).all() and (raster.depth.numpy() > 0).any()


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_warm_start_and_walk_replay(name, tex_png):
    """The warm start (K9's seed, then the repair pass) is bitwise a cold
    render of the route; the route's replayed walk gives the plain
    version's t and idx // seg_div."""
    _, (t_state, t_scene), opts = _route(name, tex_png)
    cold = trc.raytrace(t_state, t_scene, **opts)
    prev = torch.where(cold.depth > 0, cold.depth * 0.8, 1000.0)
    warm = warmstart.raytrace_warmstart(t_state, t_scene, prev_depth=prev, **opts)
    for a, b in zip((warm.rgb, warm.depth, warm.segmask), (cold.rgb, cold.depth, cold.segmask)):
        assert torch.equal(a, b)
    kw = trc.pack_inputs(t_state, t_scene, **opts)
    t, _, idx = trc.render_resident(**kw)[:3]
    walk = (walk_replay.dmxu_walk if kw["dmxu"] else walk_replay.resident_walk
            if not ROUTES[name][3].streamed else walk_replay.binned_walk
            if kw["bins"] is not None else walk_replay.streamed_walk)
    with one_thread():
        replay = walk(**kw)
    assert torch.equal(replay["depth"], t)
    assert torch.equal(replay["segmask"], torch.where(idx >= 0, idx // kw["seg_div"], -1))


def test_raw_rows_under_k11_match_jax(tex_png):
    """Two cameras a world: raw rows, on which K11 forms each view's D, A, Q
    and t_num (its plain version sweeps dmxu_rows); the frames against the
    jnp reference on both streamed visits, bitwise each other."""
    (j_state, j_scene), (t_state, t_scene) = _built(40, tex_png, num_cams=2)
    ref = j_ref(j_state, j_scene, height=SIZE, width=SIZE)
    frames = []
    for accel in ("auto", "binned"):
        opts = dict(height=SIZE, width=SIZE, accel=accel, deferred_mxu=True)
        kw = trc.pack_inputs(t_state, t_scene, **opts)
        assert kw["geo"] == "raw" and kw["dmxu"] and kw["texture"] == "nine"
        assert kw["ranges"] is None
        frames.append(trc.raytrace(t_state, t_scene, **opts))
        assert_frames_close(ref, frames[-1])
    for a, b in zip(dataclasses.astuple(frames[0]), dataclasses.astuple(frames[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_manager_renders_the_route(name, tex_png):
    """MadronaRenderer on the textured terrain (bigmesh_config with the
    checker, mipmaps=False) takes the route's 9-output visit, renders what
    raytrace renders on its state, and steps: a moved world's frames change,
    another's do not."""
    grid, accel, dmxu, route, _ = ROUTES[name]
    cfg = bigmesh_config(2, SIZE, SIZE, grid=grid, texture=tex_png)
    r = tm.MadronaRenderer(0, 2, tm.RenderMode.Raytracer, SIZE, SIZE, device="cpu",
                           mipmaps=False, accel=accel, deferred_mxu=dmxu,
                           **renderer_kwargs(cfg))
    kw = trc.pack_inputs(r.state, r.scene, height=SIZE, width=SIZE, accel=accel,
                         deferred_mxu=dmxu)
    assert kw["texture"] == "nine" and kw["dmxu"] == dmxu
    assert trc.route_of(kw["order"], kw["spans"], kw["bins"]) == route
    before = r.rgb_tensor().to_torch().clone()
    r.instance_position_tensor().to_torch()[1][0] += 0.7  # world 0's cube
    r.step()
    after = r.rgb_tensor().to_torch()
    assert not torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
    f = trc.raytrace(r.state, r.scene, height=SIZE, width=SIZE, accel=accel,
                     deferred_mxu=dmxu)
    assert torch.equal(f.rgb.reshape(after.shape), after)
    assert torch.equal(f.segmask.reshape(-1, SIZE, SIZE), r.segmask_tensor().to_torch())



@pytest.mark.parametrize("name", ["resident_ordered", "streamed_binned", "dmxu_ordered"])
def test_plain_hits_serve_every_texture_mode(name, tex_png):
    """One plain sweep (plain_hits) resolved in the 9-output mode and
    untextured, cold and seeded, and with shadow rays on raw rows, gives the
    plain version's outputs bitwise (chip_smoke.py shares a sweep so); on
    row-sorted rows and K11's the sweep takes the same row transforms."""
    _, (t_state, t_scene), opts = _route(name, tex_png)
    kw = trc.pack_inputs(t_state, t_scene, **opts)
    t = trc.render_resident_plain(**kw)[0]
    seed = torch.where(t > 0, t * 1.0001, 1000.0).contiguous()
    _, (_, lit), _ = _route(name, tex_png, lit=True)
    raw = trc.pack_inputs(t_state, lit, shadows=True, **opts)
    cases = [kw, dict(kw, seed=seed), dict(raw, texture=None, geo="raw_shadows")]
    for case in cases:
        hits = trc.plain_hits(**case)
        for texture in ("nine", None):
            one = dict(case, texture=texture)
            for a, b in zip(trc.render_resident_plain(**one),
                            trc.render_resident_plain(**one, hits=hits)):
                assert torch.equal(a, b)
    assert any(o.any() for o in trc.plain_hits(**cases[2]).occluded)
