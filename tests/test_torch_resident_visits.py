"""PyTorch port: the resident visits (K3 and K4 on resident rows) == the JAX
package's.

A world within the resident budget keeps its rows in the block's shared
memory; with 4 or more clusters the JAX ``render_core`` walks them front to
back (``ordered``), and with enough clusters and TPU tiles (or
``accel="binned"``) it walks each tile's bin (``binned``). The port picks the
same visit (``visit_route``), builds the same order and bins, and renders
the same frames: on the CPU the kernel's plain version (the index-order
sweep), with ``ops/walk_replay.resident_walk`` replaying each visit's walk.
Held against the JAX package on the same inputs:
  * the route, where the JAX ``render_core`` traces ``camera_cluster_order``
    (ordered) or ``band_cluster_bins`` (binned), at 32²-256²;
  * ``camera_cluster_order`` and ``band_cluster_bins`` on resident worlds:
    integers equal;
  * frames (raytrace and raster) against the jnp reference and the Pallas
    kernel in interpret mode at tests/test_pallas_parity.py's bar (rgb ±1
    LSB, depth 1e-5, segmask exact), the walks' replays bitwise equal to
    the plain frames;
  * exact-t ties across clusters go to the lower index under the ordered
    visit (the JAX Pallas ordered sweep keeps the first visited, a note of
    ROADMAP Queue 3);
  * the replayed walks render the plain frames with fewer clusters swept
    than index order on an occluder scene.
The resident terrain is bench.py's big-mesh scene at a 27 grid (2 worlds,
S = 2,928 slots, 366 clusters of 8; the frames at a 12 grid, where the JAX
Pallas kernel in interpret mode takes some 7 s on a CPU, not 35), each
scene built once a worker.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.ops import raytrace_pallas as jrp
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_raster_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu_torch.ops import walk_replay
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.runners.scenes import demo_config

from tests.test_torch_bigmesh import _cloud, _inst, _origin_cams, _world
from tests.torch_helpers import SceneSpec, assert_frames_close, carry_over, one_thread, \
    quad_xz, spec_from_config, terrain_spec


def _occluder_spec():
    """A 600-triangle cloud 8-20 ahead of the camera (instance 0, first in
    index order) behind a wall 3 ahead (instance 1) with a gap on the right
    through which part of the cloud shows."""
    wall = quad_xz(2.0, 0.0)
    return SceneSpec(meshes=[_cloud(7, 600, 6.0, 8.0, 20.0, 0.4), wall],
                     instances=[_inst([0, 0, 0]), _inst([-1.2, 3, 0], 1)],
                     cameras=_origin_cams(), worlds=[_world(2, 0)])


def _tie_spec():
    """tests/test_torch_bigmesh.py's tie scene made resident: instance 0 a
    quad 10 ahead, instance 1 the same quad at the same pose with a small
    triangle 5 ahead (its cluster is visited first), and two more instances
    behind the camera, so the world has 4 clusters and walks them in order."""
    small = np.asarray([[-0.5, -5.0, -0.5], [0.5, -5.0, -0.5], [0.0, -5.0, 0.5]], np.float32)
    quad = quad_xz(4.0)
    insts = [_inst([0, 10, 0], 0), _inst([0, 10, 0], 1), _inst([0, -30, 0], 0),
             _inst([3, -40, 0], 0)]
    return SceneSpec(meshes=[quad, np.concatenate([quad, small])], instances=insts,
                     cameras=_origin_cams(), worlds=[_world(4, 0)])


def _six_spec():
    """Six one-cluster instances of a small mesh ahead of the camera: 6
    clusters, fewer than auto-binning needs."""
    tri = np.asarray([[-1, 0, -1], [1, 0, -1], [0, 0, 1]], np.float32)
    insts = [_inst([(i - 2.5) * 1.5, 6 + i, 0]) for i in range(6)]
    return SceneSpec(meshes=[tri], instances=insts, cameras=_origin_cams(),
                     worlds=[_world(6, 0)])


SCENES = {
    "terrain27": lambda: terrain_spec(grid=27),
    "terrain12": lambda: terrain_spec(grid=12),
    "demo": lambda: spec_from_config(demo_config(2, tm.RenderMode.Raytracer, 16, 16,
                                                 dynamic=True)),
    "six": _six_spec,
    "occluder": _occluder_spec,
    "tie": _tie_spec,
}


# The JAX bins compiled once per shape (an eager call compiles each of its
# primitives per shape).
_J_BINS = jax.jit(jrp.band_cluster_bins, static_argnums=(5, 6, 7),
                  static_argnames=("tile_pix", "tiles_x", "tile_sub", "tile_cols"))


@functools.cache
def _built(name):
    """A scene of SCENES baked by the JAX package and carried over, once a
    worker: the tests below only read it."""
    j_state, j_scene = SCENES[name]().build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    assert not trc.is_streamed(t_state, t_scene), "the scene must stay resident"
    return (j_state, j_scene), (t_state, t_scene)


# ---------------------------------------------------------------- route ----
@pytest.mark.parametrize("name,size,accel", [
    ("terrain27", 32, "auto"), ("terrain27", 64, "auto"), ("terrain27", 128, "auto"),
    ("terrain27", 256, "auto"), ("terrain27", 64, "binned"), ("terrain27", 128, "clusters"),
    ("demo", 64, "auto"), ("demo", 64, "clusters"), ("six", 64, "auto"), ("six", 128, "auto"),
])
def test_visit_route_is_jax_render_core(name, size, accel, monkeypatch):
    """visit_route gives the visit whose inputs the JAX render_core builds
    for this scene and size: bins (band_cluster_bins) → binned, a visit
    order (camera_cluster_order) → ordered, neither → index order. The
    trace stops at the render kernel's pallas_call: the inputs are built by
    then."""
    (j_state, j_scene), (t_state, t_scene) = _built(name)
    called = []
    for fn in ("band_cluster_bins", "camera_cluster_order"):
        real = getattr(jrp, fn)
        monkeypatch.setattr(jrp, fn, lambda *a, _r=real, _n=fn, **k: called.append(_n)
                            or _r(*a, **k))

    class KernelReached(Exception):
        pass

    def stop(*a, **k):
        raise KernelReached

    monkeypatch.setattr(jrp, "pl", types.SimpleNamespace(**dict(vars(jrp.pl),
                                                                pallas_call=stop)))
    with pytest.raises(KernelReached):
        jax.eval_shape(lambda s: jrp.render_core(s, j_scene, height=size, width=size,
                                                 near=0.1, far=1000.0, fov_y_degrees=90.0,
                                                 interpret=True, accel=accel), j_state)
    jax_visit = ("binned" if "band_cluster_bins" in called
                 else "ordered" if "camera_cluster_order" in called else "index")
    route = trc.visit_route(t_state, t_scene, size, size, accel)
    assert route == trc.Route(False, jax_visit)
    kw = trc.pack_inputs(t_state, t_scene, height=size, width=size, accel=accel)
    assert kw["spans"] is None and kw["ranges"] is None
    assert (kw["order"] is not None) == (jax_visit == "ordered")
    assert (kw["bins"] is not None) == (jax_visit == "binned")
    assert trc.route_of(kw["order"], kw["spans"], kw["bins"]) == route


def test_resident_route_names_and_inputs():
    """The resident visits' variants and launch inputs: 40 entries each,
    100 seeded (K9) over the five routes of K1's source and the visits';
    300 such entries, and with K1-none's 69 and K1's 9-output mode's 9
    (csrc/render_none.cu) 378, with K11's 48 (csrc/render_dmxu.cu) 426, with
    the culled visits' 48 9-output entries 474; a resident visit takes no
    spans,
    and rows past the resident budget need them."""
    assert len(trc.RESIDENT_ORDERED_VARIANTS) == len(trc.RESIDENT_BINNED_VARIANTS) == 40
    assert trc.variant_name(False, None, "prep", trc.Route(False, "ordered")) \
        == "render_resident_ordered"
    assert trc.variant_name(True, "mip", "raw_wt_shadows", trc.Route(False, "binned")) \
        == "render_resident_binned_raw_wt_shadows_raster_tex_mip"
    assert len(trc.SEEDED_VARIANTS) == 100 and not any("raster" in n
                                                       for n in trc.SEEDED_VARIANTS)
    assert "render_streamed_seeded_raw_tex_bilinear" in trc.SEEDED_VARIANTS
    assert len(set(trc.RENDER_VARIANTS)) == 474 and len(trc.CULLED_NINE_VARIANTS) == 48
    assert len(set(trc.RENDER_VARIANTS) - set(trc.NONE_VARIANTS + trc.NINE_VARIANTS
                                              + trc.DMXU_VARIANTS
                                              + trc.CULLED_NINE_VARIANTS)) == 300
    _, (t_state, t_scene) = _built("terrain27")
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32)
    assert kw["order"].shape == (2, kw["clusters"].shape[2]) and kw["spans"] is None
    big = terrain_spec(grid=40).build_torch()
    streamed = trc.pack_inputs(*big, height=32, width=32)
    with pytest.raises(ValueError, match="past the resident budget"):
        trc.render_resident(**dict(streamed, spans=None))
    with pytest.raises(ValueError, match="raytrace conventions"):
        trc.render_resident(**dict(trc.pack_inputs(t_state, t_scene, height=32, width=32,
                                                   raster=True),
                                   seed=torch.ones((2, 32, 32))))


# ------------------------------------------------------- order and bins ----
def test_order_and_bins_equal_jax():
    """camera_cluster_order and band_cluster_bins on the resident terrain:
    the order equals the JAX function's; the bins' counts and members equal
    it at the JAX package's TPU tiles of 256² and at the port's 16-pixel bin
    tiles of 128² and 40x24."""
    (j_state, j_scene), (t_state, t_scene) = _built("terrain27")
    j_lo, j_hi, j_valid, _ = jrp.world_clusters(j_state, j_scene)
    lo, hi, valid = (torch.from_numpy(np.array(x)) for x in (j_lo, j_hi, j_valid))
    order = trc.camera_cluster_order(lo, hi, valid, t_state.camera_pos)
    j_order = np.asarray(jrp.camera_cluster_order(j_lo, j_hi, j_valid, j_state.camera_pos))
    np.testing.assert_array_equal(order.numpy(), j_order.reshape(order.shape))
    fov = np.full(np.asarray(j_state.camera_fov).shape, 90.0, np.float32)
    for h, w, sub, cols in ((256, 256, 32, 128), (128, 128, 16, 16), (40, 24, 16, 16)):
        tx, ty = -(-w // cols), -(-h // sub)
        jb = np.asarray(_J_BINS(j_lo, j_hi, j_valid, j_state, fov, h, w, tx * ty,
                                tile_pix=sub * 128, tiles_x=tx, tile_sub=sub, tile_cols=cols))
        tb = trc.band_cluster_bins(lo, hi, valid, t_state, torch.from_numpy(fov), h, w,
                                   tx * ty, tx, sub, cols, order=order).numpy()
        count = jb[..., 0]
        np.testing.assert_array_equal(tb[..., 0], count, err_msg=f"{h}x{w}/{sub}")
        assert count.max() > 0
        for v, t in zip(*np.nonzero(count)):
            np.testing.assert_array_equal(tb[v, t, 1:1 + count[v, t]], jb[v, t, 1:1 + count[v, t]])


# ------------------------------------------------------------- frames ----
def _replay_matches(kw, frames):
    with one_thread():
        replay = walk_replay.resident_walk(**kw)
    assert torch.equal(replay["depth"], frames.depth.reshape(replay["depth"].shape))
    assert torch.equal(replay["segmask"], frames.segmask.reshape(replay["segmask"].shape))
    return replay


@pytest.mark.parametrize("accel", ["auto", "binned"])
def test_resident_visit_frames_match_jax(accel):
    """The resident terrain (a 12 grid: 18 clusters of 32) at 32²: "auto"
    orders, "binned" bins (both in the JAX render_core too); the port's
    frames against both JAX paths, the visit's replayed walk bitwise equal
    to them."""
    (j_state, j_scene), (t_state, t_scene) = _built("terrain12")
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, accel=accel)
    assert trc.route_of(kw["order"], kw["spans"], kw["bins"]).visit == \
        ("ordered" if accel == "auto" else "binned")
    port = trc.raytrace(t_state, t_scene, height=32, width=32, accel=accel)
    assert_frames_close(j_ref(j_state, j_scene, height=32, width=32), port)
    assert_frames_close(j_pallas(j_state, j_scene, height=32, width=32, interpret=True,
                                 accel=accel), port)
    assert (port.segmask.numpy() == 1).any() and (port.segmask.numpy() == 0).any()
    _replay_matches(kw, port)


def test_resident_visit_raster_matches_jax():
    """Regime 2 of the rasterizer on resident rows (the ordered visit)."""
    (j_state, j_scene), (t_state, t_scene) = _built("terrain12")
    from madrona_renderer_tpu_torch.ops import raster_cuda

    port = raster_cuda.rasterize(t_state, t_scene, height=32, width=32)
    for j in (j_raster_ref(j_state, j_scene, height=32, width=32),
              j_raster_pallas(j_state, j_scene, height=32, width=32, interpret=True)):
        assert np.abs(np.asarray(j.rgb, np.int16) - port.rgb.numpy().astype(np.int16)).max() <= 1
        np.testing.assert_allclose(np.asarray(j.depth), port.depth.numpy(), rtol=1e-5,
                                   atol=1e-5)
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, raster=True, near=0.001)
    assert kw["order"] is not None
    depth, _, _ = trc.render_resident_plain(**kw)
    assert torch.equal(depth.reshape(port.depth.shape), port.depth)


def test_exact_ties_take_the_lower_index():
    """Every quad pixel ties between instances 0 and 1; instance 1's cluster
    comes first in the visit order. The port and its ordered walk's replay
    give instance 0, as the jnp reference does; the JAX Pallas ordered
    sweep (t < best_t only) keeps instance 1, the first visited."""
    (j_state, j_scene), (t_state, t_scene) = _built("tie")
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32)
    assert kw["order"] is not None and int(kw["order"][0, 0]) == 1
    port = trc.raytrace(t_state, t_scene, height=32, width=32)
    assert_frames_close(j_ref(j_state, j_scene, height=32, width=32), port)
    seg = port.segmask.numpy()
    quad = seg == 0
    assert quad.sum() > 100 and (seg == 1).any()
    _replay_matches(kw, port)
    pallas = np.asarray(j_pallas(j_state, j_scene, height=32, width=32,
                                 interpret=True).segmask)
    assert (pallas[quad] == 1).all()


@pytest.mark.parametrize("shadows", [False, True])
def test_resident_walks_cut_work_on_an_occluder(shadows):
    """Behind a wall the ordered and binned walks stop early: each replay
    renders the plain frames bitwise and sweeps fewer clusters and
    triangles than index order (K1), which sweeps the cloud's clusters
    before it meets the wall (with shadows on the raw rows, each light's
    any-hit walk replayed too)."""
    _, (t_state, t_scene) = _built("occluder")
    opts = dict(height=32, width=32, shadows=shadows)
    kw = trc.pack_inputs(t_state, t_scene, accel="clusters", **opts)
    depth, seg, _ = trc.render_resident_plain(**kw)
    walks = {}
    for visit, over in (("index", dict(order=None)), ("ordered", {}),
                        ("binned", dict(trc.pack_inputs(t_state, t_scene, accel="binned",
                                                        **opts), order=None))):
        with one_thread():
            w = walk_replay.resident_walk(**dict(kw, **over))
        assert torch.equal(w["depth"], depth) and torch.equal(w["segmask"], seg), visit
        walks[visit] = w
    for visit in ("ordered", "binned"):
        assert walks[visit]["cluster_visits"] < walks["index"]["cluster_visits"] / 2
        assert walks[visit]["triangle_visits"] < walks["index"]["triangle_visits"] / 2
    assert walks["binned"]["gated"] < walks["ordered"]["gated"]
