"""PyTorch port: the tile-binned visit (kernel K4) == the JAX package's.

On a mesh past the resident budget with enough clusters and TPU tiles, the
streamed route bins each view's clusters per 2D tile (``band_cluster_bins``,
front to back), row-sorts each cluster's triangles (``cluster_row_sort``,
prep rows only) and walks each block's bin, its 8-row bands sweeping only
their triangle ranges. On the CPU the kernel's plain version renders (the
index-order sweep); ``ops/walk_replay.binned_walk`` replays the kernel's
walk. Held against the JAX package on the same inputs:
  * the helpers' integers: the bins' counts and members (at the JAX
    package's TPU tiles and the port's 16- and 32-pixel bin tiles), the row
    sort's permutation and ranges and the row spans at 8-row bands, each JAX
    function called eagerly;
  * the binned frames (``raytrace`` / ``rasterize`` with ``accel="binned"``)
    against the jnp reference and the Pallas kernel in interpret mode at
    tests/test_pallas_parity.py's bar (rgb ±1 LSB, depth 1e-5, segmask
    exact), watertight at its knife-edge bar;
  * exact ties under the row sort go to the lower original index;
  * the route: ``accel="auto"`` bins where the JAX ``render_core`` bins;
  * the walk replay: the plain frames, and less work than the ordered walk.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.ops import quat as j_quat
from madrona_renderer_tpu.ops import raytrace_pallas as jrp
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_raster_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import build_world_soup
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu_torch.assets.importer import load_render_assets as t_load
from madrona_renderer_tpu_torch.assets.png import write_png
from madrona_renderer_tpu_torch.core.scene import bake_scene as t_bake
from madrona_renderer_tpu_torch.core.state import init_state as t_init
from madrona_renderer_tpu_torch.ops import quat as t_quat
from madrona_renderer_tpu_torch.ops import raster_cuda, walk_replay
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.ops.raytrace_ref import planar_soup_parts
from madrona_renderer_tpu_torch.runners.scenes import binned_terrain_config
from tools.tpu_binned_bench import build_scene as j_binned_scene

from tests.test_torch_bake import _assert_bitwise
from tests.test_torch_bigmesh import _both, _cloud, _cloud_spec, _inst, _origin_cams, _world
from tests.test_torch_watertight import _assert_frames_equal_knife_edge
from tests.torch_helpers import SceneSpec, assert_frames_close, carry_over, one_thread, \
    spec_from_config, terrain_spec


def _straddle_spec():
    """tests/test_pallas_parity.py::test_parity_camera_inside_scene_straddle_bins
    (:878): a 3,600-triangle cloud around a camera at the origin, so that
    many clusters straddle the camera plane."""
    rng = np.random.default_rng(89)
    centers = rng.uniform(-25, 25, size=(3600, 3)).astype(np.float32)
    tris = np.repeat(centers, 3, axis=0)
    tris[1::3] += rng.normal(size=(3600, 3)).astype(np.float32) * 0.5
    tris[2::3] += rng.normal(size=(3600, 3)).astype(np.float32) * 0.5
    return SceneSpec(meshes=[tris], instances=[_inst([0, 0, 0])], cameras=_origin_cams(),
                     worlds=[_world(1, 0)])


def _random_spec(seed, n_worlds=2):
    """A random streamed scene: a 3,600-triangle cloud per world, turned and
    moved at random, one camera per world near the origin."""
    rng = np.random.default_rng(seed)
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        q = rng.normal(size=4) * 0.2 + [1, 0, 0, 0]
        insts.append(_inst(rng.normal(size=3).tolist(), rot=(q / np.linalg.norm(q)).tolist()))
        q = rng.normal(size=4) * 0.1 + [1, 0, 0, 0]
        cams.append(dict(position=rng.normal(size=3).tolist(),
                         rotation=(q / np.linalg.norm(q)).tolist()))
        worlds.append(_world(1, w, 1, w))
    return SceneSpec(meshes=[_cloud(seed)], instances=insts, cameras=cams, worlds=worlds)


def _terrain40_spec():
    return spec_from_config(binned_terrain_config(2, 64, 64, grid=40, device="cpu"))


SCENES = {
    "random3": lambda: _random_spec(3),
    "straddle": _straddle_spec,
    "terrain40": _terrain40_spec,
}


# The JAX helpers, each compiled once per shape (eager calls compile every
# primitive of them per shape).
_J_BINS = jax.jit(jrp.band_cluster_bins, static_argnums=(5, 6, 7),
                  static_argnames=("tile_pix", "tiles_x", "tile_sub", "tile_cols"))
_J_ROW_SORT = jax.jit(jrp.cluster_row_sort, static_argnums=(3, 4, 5, 6))
_J_SPANS = jax.jit(jrp.camera_cluster_rowspans, static_argnums=(5,), static_argnames=("g_rows",))


@functools.cache
def _built(name):
    """A scene of SCENES baked by the JAX package and carried over, once a
    worker: the tests below only read it."""
    j_state, j_scene = SCENES[name]().build_jax()
    return (j_state, j_scene), carry_over(j_state, j_scene)


@functools.cache
def _clusters(name):
    (j_state, j_scene), (t_state, _) = _built(name)
    j_lo, j_hi, j_valid, _ = jrp.world_clusters(j_state, j_scene)
    lo, hi, valid = (torch.from_numpy(np.array(x)) for x in (j_lo, j_hi, j_valid))
    j_fov = np.where(np.asarray(j_state.camera_fov) > 0, np.asarray(j_state.camera_fov),
                     90.0).astype(np.float32)
    t_fov = torch.where(t_state.camera_fov > 0, t_state.camera_fov, 90.0)
    return (j_state, j_scene, j_lo, j_hi, j_valid, j_fov), (t_state, lo, hi, valid, t_fov)


# ------------------------------------------------------------ helpers ----
def test_binned_terrain_config_is_the_bench_tool_scene():
    """runners/scenes.binned_terrain_config bakes the scene and state of
    tools/tpu_binned_bench.py::build_scene, bitwise (at a 40 grid)."""
    j_state, j_scene = j_binned_scene(3, 40)
    cfg = binned_terrain_config(3, 32, 32, grid=40, device="cpu").rcfg
    t_scene = t_bake(t_load(cfg.geo_cfg, [], cfg.additional_mats, []), "cpu")
    t_state = t_init(cfg.instances, cfg.cameras, cfg.worlds, "cpu")
    _assert_bitwise(j_scene, t_scene)
    _assert_bitwise(j_state, t_state)
    assert t_scene.tris_per_object == j_scene.tris_per_object


def test_quat_step_matches_jax():
    """The paths' step q <- normalize(dq q): both bitwise."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(500, 4)).astype(np.float32)
    b = rng.normal(size=(500, 4)).astype(np.float32)
    jm = np.asarray(j_quat.quat_multiply(a, b))
    tmul = t_quat.quat_multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(jm.view(np.uint32), tmul.view(np.uint32))
    jn = np.asarray(j_quat.quat_normalize(a))
    tn = t_quat.quat_normalize(torch.from_numpy(a)).numpy()
    assert np.array_equal(jn.view(np.uint32), tn.view(np.uint32))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_band_cluster_bins_equal_jax(name):
    """Counts and the first count ids equal the JAX function's, at the TPU
    tiles of 256² (and on the terrain 512²: 32 × 128) and the port's bin
    tiles (16 px square, on the terrain 32 px too), including a cropped
    height."""
    (j_state, _, j_lo, j_hi, j_valid, j_fov), (t_state, lo, hi, valid, t_fov) = \
        _clusters(name)
    tiles = [(256, 256, 32, 128), (128, 128, 16, 16), (48, 64, 16, 16), (40, 24, 16, 16)]
    if name == "terrain40":
        tiles += [(512, 512, 32, 128), (64, 64, 32, 32)]
    for h, w, sub, cols in tiles:
        tx, ty = -(-w // cols), -(-h // sub)
        jb = np.asarray(_J_BINS(j_lo, j_hi, j_valid, j_state, j_fov, h, w, tx * ty,
                                tile_pix=sub * 128, tiles_x=tx, tile_sub=sub, tile_cols=cols))
        tb = trc.band_cluster_bins(lo, hi, valid, t_state, t_fov, h, w, tx * ty, tx, sub,
                                   cols).numpy()
        assert tb.dtype == np.int32 and tb.shape == jb.shape
        count = jb[..., 0]
        np.testing.assert_array_equal(tb[..., 0], count, err_msg=f"{name} {h}x{w}/{sub}")
        assert count.max() > 0
        for v, t in zip(*np.nonzero(count)):
            np.testing.assert_array_equal(tb[v, t, 1:1 + count[v, t]],
                                          jb[v, t, 1:1 + count[v, t]])


@pytest.mark.parametrize("name", ["random3", "terrain40"])
def test_cluster_row_sort_and_spans_equal_jax(name):
    """perm, lo and hi of cluster_row_sort at 16- and 8-row bands, and the
    row spans at 8-row bands, equal the JAX functions' on the same soup and
    cluster bounds."""
    (j_state, j_scene, j_lo, j_hi, j_valid, j_fov), (t_state, lo, hi, valid, t_fov) = \
        _clusters(name)
    _, t_scene = _built(name)[1]
    soup = build_world_soup(j_state, j_scene)
    p = planar_soup_parts(t_state, t_scene, what="geo")
    W = p["valid"].shape[0]
    planes = [tuple(x.reshape(W, -1) for x in p[k]) for k in ("v0", "e1", "e2")]
    cs = t_scene.tris_per_object // int(t_scene.cl_valid.shape[1])
    for height, g_rows in ((32, 16), (32, 8), (64, 8), (40, 8)):
        n_bands = -(-height // g_rows)
        jp, jl, jh = (np.asarray(x) for x in _J_ROW_SORT(
            soup, j_state, j_fov, height, cs, g_rows, n_bands))
        tp, tl, th = trc.cluster_row_sort(*planes, p["valid"].reshape(W, -1), t_state, t_fov,
                                          height, cs, g_rows, n_bands)
        for a, b in ((jp, tp), (jl, tl), (jh, th)):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f"{height} {g_rows}")
        assert (tl <= th).all() and (th.numpy() > 0).any()
        j_spans = np.asarray(_J_SPANS(j_lo, j_hi, j_valid, j_state, j_fov, height,
                                      g_rows=g_rows))
        spans = trc.camera_cluster_rowspans(lo, hi, valid, t_state, t_fov, height,
                                            g_rows=g_rows)
        np.testing.assert_array_equal(spans.numpy(), j_spans)


def test_row_sorted_rows_round_trip():
    """The row-sorted rows carry each lane's original index in row 10 and
    go back to the index-order rows exactly; the attribute rows stay."""
    t_state, t_scene = terrain_spec().build_torch()
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, accel="binned")
    assert kw["ranges"] is not None and kw["ranges"].shape[-1] == 2
    plain_rows = trc._pack_rows_planar(t_state, t_scene, t_state.camera_pos[:, 0, :])
    assert torch.equal(trc._index_order_rows(kw["rows"]), plain_rows)
    assert torch.equal(kw["rows"][:, 16:], plain_rows[:, 16:])
    perm = kw["rows"][:, 10].long()
    assert not torch.equal(perm, torch.arange(perm.shape[1]).expand_as(perm))


# ------------------------------------------------------------- frames ----
FRAMES = {
    # name: (spec, height, width, light, kwargs)
    "cloud_prep_ranges": (lambda: _cloud_spec("cloud"), 32, 64, None, {}),
    "two_cams_raw": (lambda: _cloud_spec("two_cams"), 32, 64, None, {}),
    "cloud_shadows": (lambda: _cloud_spec("shadows"), 32, 64, ((0.5, 1, 0), (1, 1, 1)),
                      dict(shadows=True)),
}


@functools.cache
def _frames_scene(name):
    """A scene of FRAMES through both packages, once a worker."""
    make, _, _, light, _ = FRAMES[name]
    return _both(make(), light=light)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_binned_frames_match_jax(name):
    _, h, w, _, opts = FRAMES[name]
    (j_state, j_scene), (t_state, t_scene) = _frames_scene(name)
    assert trc.visit_route(t_state, t_scene, h, w, "binned") == trc.Route(True, "binned")
    kw = trc.pack_inputs(t_state, t_scene, height=h, width=w, accel="binned", **opts)
    assert kw["bins"] is not None and (kw["ranges"] is not None) == (kw["geo"] == "prep")
    port = trc.raytrace(t_state, t_scene, height=h, width=w, accel="binned", **opts)
    assert_frames_close(j_ref(j_state, j_scene, height=h, width=w, **opts), port)
    assert_frames_close(j_pallas(j_state, j_scene, height=h, width=w, interpret=True,
                                 accel="binned", **opts), port)
    assert (port.segmask.numpy() >= 0).any()


def test_binned_raster_matches_jax():
    (j_state, j_scene), (t_state, t_scene) = _frames_scene("cloud_prep_ranges")
    port = raster_cuda.rasterize(t_state, t_scene, height=32, width=64, accel="binned")
    for j in (j_raster_ref(j_state, j_scene, height=32, width=64),
              j_raster_pallas(j_state, j_scene, height=32, width=64, interpret=True,
                              accel="binned")):
        assert np.abs(np.asarray(j.rgb, np.int16) - port.rgb.numpy().astype(np.int16)).max() <= 1
        np.testing.assert_allclose(np.asarray(j.depth), port.depth.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_binned_watertight_matches_jax():
    """Under watertight the rows are raw and the bins stay (no ranges):
    both JAX paths at the knife-edge bar; the walk replay renders the plain
    frames."""
    (j_state, j_scene), (t_state, t_scene) = _both(terrain_spec())
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, watertight=True,
                         accel="binned")
    assert kw["geo"] == "raw_wt" and kw["bins"] is not None and kw["ranges"] is None
    port = trc.raytrace(t_state, t_scene, height=32, width=32, watertight=True,
                        accel="binned")
    for ref in (j_ref(j_state, j_scene, height=32, width=32, watertight=True),
                j_pallas(j_state, j_scene, height=32, width=32, interpret=True,
                         watertight=True, accel="binned")):
        _assert_frames_equal_knife_edge(ref, port)
    with one_thread():
        replay = walk_replay.binned_walk(**kw)
    assert torch.equal(replay["segmask"], port.segmask[:, 0])
    assert torch.equal(replay["depth"], port.depth[:, 0])


def test_coplanar_ties_take_the_lower_original_index(tmp_path):
    """tests/test_pallas_parity.py::test_parity_tri_ranges_coplanar_shared_edge
    (:940): two coplanar triangles share an edge, and the row sort puts the
    second (its vertices above the edge) first; textured by a checker, the
    frames equal the jnp reference's (the lower index wins the edge), as
    does the binned walk's replay."""
    from tests.fixtures import make_checker_png

    rng = np.random.default_rng(5)
    quad = np.asarray([[-4, 10, 0], [4, 10, 0], [0, 10, -4],
                       [-4, 10, 0], [4, 10, 0], [0, 10, 4]], np.float32)
    uv = np.asarray([[0, 0.5], [1, 0.5], [0.5, 0.0], [0, 0.5], [1, 0.5], [0.5, 1.0]],
                    np.float32)
    centers = rng.uniform(-10, 10, size=(3600, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(20, 40, size=3600)
    fill = np.repeat(centers, 3, axis=0)
    fill[1::3] += rng.normal(size=(3600, 3)).astype(np.float32) * 0.4
    fill[2::3] += rng.normal(size=(3600, 3)).astype(np.float32) * 0.4
    tex = str(tmp_path / "checker.png")
    write_png(tex, make_checker_png())
    spec = SceneSpec(meshes=[np.concatenate([quad, fill])],
                     uvs=[np.concatenate([uv, np.zeros((len(fill), 2), np.float32)])],
                     mesh_materials=[0], instances=[_inst([0, 0, 0])],
                     cameras=_origin_cams(), worlds=[_world(1, 0)],
                     materials=[(1, 1, 1, 1)], textures=[tex], material_textures=[0])
    (j_state, j_scene), (t_state, t_scene) = _both(spec)
    kw = trc.pack_inputs(t_state, t_scene, height=64, width=256, accel="binned")
    # The bake's clusters reorder the triangles: find the pair (the only
    # triangles at y = 10) and check the row sort puts the upper one, the
    # higher index, first.
    p = planar_soup_parts(t_state, t_scene, what="geo")
    pair = torch.nonzero(p["v0"][1].reshape(-1) == 10.0)[:, 0].tolist()
    assert len(pair) == 2 and pair[1] - pair[0] < 32
    lanes = kw["rows"][0, 10].long().tolist()
    upper = max(pair, key=lambda i: float(p["v0"][2].reshape(-1)[i] + p["e2"][2].reshape(-1)[i]))
    assert upper == pair[1] and lanes.index(pair[1]) < lanes.index(pair[0]), \
        "the row sort must flip the coplanar pair"
    port = trc.raytrace(t_state, t_scene, height=64, width=256, accel="binned")
    assert_frames_close(j_ref(j_state, j_scene, height=64, width=256), port)
    with one_thread():
        replay = walk_replay.binned_walk(**kw)
    assert torch.equal(replay["segmask"], port.segmask[:, 0])
    assert torch.equal(replay["depth"], port.depth[:, 0])


# ---------------------------------------------------------------- route ----
@pytest.mark.parametrize("size", [64, 128, 256, 512])
def test_auto_bins_where_jax_bins(size, monkeypatch):
    """accel="auto" takes the binned route exactly where the JAX
    render_core builds bins (its trace calls band_cluster_bins): not at 64²
    (one TPU tile), at 128² and up."""
    (j_state, j_scene), (t_state, t_scene) = _built("terrain40")
    called = []
    real = jrp.band_cluster_bins
    monkeypatch.setattr(jrp, "band_cluster_bins",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    import jax

    jax.eval_shape(lambda s: jrp.render_core(s, j_scene, height=size, width=size, near=0.1,
                                             far=1000.0, fov_y_degrees=90.0, interpret=True),
                   j_state)
    route = trc.visit_route(t_state, t_scene, size, size, "auto").visit
    assert route == ("binned" if called else "ordered")
    assert (route == "binned") == (size >= 128)
    kw = trc.pack_inputs(t_state, t_scene, height=size, width=size)
    assert (kw["bins"] is not None) == (route == "binned")
    assert (kw["order"] is not None) == (route == "ordered")


def test_accel_values():
    """The JAX package's five values: "clusters" keeps the ordered visit,
    "binned" bins at any size, "none" sweeps without a cluster table, "mxu"
    takes the batched kernel; others raise. A resident scene of one cluster
    renders the same frames with every value: bitwise for "auto" (K1-none
    there: one cluster), "clusters" (K1), "binned" (the resident binned
    visit) and "none"; within the JAX bar for "mxu" (K12 rounds otherwise)."""
    t_state, t_scene = terrain_spec().build_torch()
    with pytest.raises(ValueError, match="accel"):
        trc.pack_inputs(t_state, t_scene, height=32, width=32, accel="bvh")
    assert trc.ACCELS == ("auto", "none", "clusters", "binned", "mxu")
    assert trc.visit_route(t_state, t_scene, 128, 128, "clusters") == trc.Route(True, "ordered")
    assert trc.visit_route(t_state, t_scene, 32, 32, "binned") == trc.Route(True, "binned")
    assert trc.visit_route(t_state, t_scene, 32, 32, "mxu") == trc.Route(False, "mxu")
    with pytest.raises(ValueError, match="SMEM budget"):
        trc.visit_route(t_state, t_scene, 32, 32, "none")
    assert trc.variant_name(False, None, "prep", trc.Route(True, "binned")) == "render_binned"
    assert len(trc.BINNED_VARIANTS) == 40 and "render_binned_raw_wt_shadows_raster_tex_mip" \
        in trc.BINNED_VARIANTS
    small = SceneSpec(meshes=[np.asarray([[-1, 5, -1], [1, 5, -1], [0, 5, 1]], np.float32)],
                      instances=[_inst([0, 0, 0])], cameras=_origin_cams(),
                      worlds=[_world(1, 0)])
    s_state, s_scene = small.build_torch()
    frames = {a: trc.raytrace(s_state, s_scene, height=16, width=16, accel=a)
              for a in trc.ACCELS}
    for a in ("clusters", "binned", "none"):
        f = frames[a]
        assert torch.equal(f.rgb, frames["auto"].rgb) and torch.equal(f.depth, frames["auto"].depth)
        assert torch.equal(f.segmask, frames["auto"].segmask)
    assert_frames_close(frames["auto"], frames["mxu"])
    assert (frames["auto"].segmask >= 0).any()
    auto = trc.pack_inputs(s_state, s_scene, height=16, width=16, accel="auto")
    assert auto["bins"] is None and auto["clusters"] is None  # K1-none
    binned = trc.pack_inputs(s_state, s_scene, height=16, width=16, accel="binned")
    assert binned["bins"] is not None and binned["spans"] is None
    assert trc.pack_inputs(s_state, s_scene, height=16, width=16, accel="mxu")["nine"] is False
    with pytest.raises(ValueError, match="SMEM budget"):
        tm.Manager(binned_terrain_config(1, 32, 32, grid=40, device="cpu", accel="none"))


def test_bin_tile_rule():
    """16·2^k px: the smallest whose dense bins hold at most 2^25 entries."""
    assert [trc.bin_tile_for(32, r, r, 3136) for r in (128, 256, 512)] == [16, 16, 32]
    assert trc.bin_tile_for(1, 40, 24, 100) == 16


# ---------------------------------------------------------- walk replay ----
@pytest.mark.parametrize("case", ["terrain_prep", "terrain_crop_prep", "two_cams_raw"])
def test_binned_walk_is_the_plain_sweep_with_less_work(case):
    """The replay of K4's walk (bins, early exit, row gate, slab test, the
    bands' ranges) renders the plain version's depth and segmask bitwise and
    tests fewer triangles than the ordered walk; a cropped height (40 rows:
    a band below the image) too."""
    spec = _cloud_spec("two_cams") if case == "two_cams_raw" else terrain_spec()
    t_state, t_scene = spec.build_torch()
    h, w = (40, 32) if "crop" in case else (32, 32)
    kw = trc.pack_inputs(t_state, t_scene, height=h, width=w, accel="binned")
    depth, seg, _ = trc.render_resident_plain(**kw)
    with one_thread():
        replay = walk_replay.binned_walk(**kw)
    assert torch.equal(replay["depth"], depth) and torch.equal(replay["segmask"], seg)
    assert replay["cluster_visits"] <= replay["slab_tests"] <= replay["gated"]
    tests = replay["triangle_visits"] * replay["sweep_threads"]
    views = kw["cams"].shape[0]
    assert 0 < tests < views * -(-h // 16) * -(-w // 16) * 256 * kw["rows"].shape[2]
    if case == "terrain_prep":
        ordered_kw = trc.pack_inputs(t_state, t_scene, height=h, width=w, accel="clusters")
        with one_thread():
            ordered = walk_replay.streamed_walk(**ordered_kw)
        assert tests < ordered["triangle_visits"] * 256
        assert replay["gated"] < ordered["gated"]


def test_binned_manager_renders_and_steps():
    """The binned terrain (a 40x40 grid) through the port's Manager on the
    CPU with accel="binned": turning world 0's terrain changes its frames,
    not world 1's."""
    r = tm.Manager(binned_terrain_config(2, 64, 64, grid=40, device="cpu", accel="binned"))
    kw = trc.pack_inputs(r.state, r.scene, height=64, width=64, accel=r.cfg.accel)
    assert kw["bins"] is not None
    rgb0 = r.rgb_tensor().to_torch().clone()
    rot = r.instance_rotation_tensor().to_torch()
    dq = torch.tensor([np.cos(0.01), 0.0, 0.0, np.sin(0.01)], dtype=torch.float32)
    rot[0] = t_quat.quat_normalize(t_quat.quat_multiply(dq, rot[0]))
    r.step()
    rgb1 = r.rgb_tensor().to_torch()
    assert not torch.equal(rgb0[0], rgb1[0]) and torch.equal(rgb0[1], rgb1[1])
