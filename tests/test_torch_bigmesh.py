"""PyTorch port: streamed big meshes (kernels K3 + K5) == the JAX package's.

A mesh whose rows exceed the resident budget (32·S·4 bytes > 384 KB) takes
the streamed route: the prologue adds each view's front-to-back cluster
order and its clusters' pixel-row spans, and the kernel walks that order
with the occlusion early exit, streaming the visited clusters. On the CPU
the kernel's plain version renders (it sweeps every triangle in index
order); ``ops/walk_replay.py`` replays the kernel's walk in torch ops.
A cluster table past the ordered walk's shared memory takes the binned
route (tests/test_torch_binned.py). Held against the JAX package on the
same inputs:
  * ``camera_cluster_order`` and ``camera_cluster_rowspans`` (at the JAX
    package's band height and at the kernel's 16 rows): integers equal;
  * frames of the port's ``raytrace`` / ``rasterize`` against the jnp
    reference and the Pallas kernel in interpret mode on the terrain of
    ``tools/tpu_bigmesh_bench.py`` (40x40 grid) and the streamed scenes of
    tests/test_pallas_parity.py, tests/test_shadows.py and tests/test_mips.py,
    at tests/test_pallas_parity.py's bar (rgb ±1 LSB, depth 1e-5, segmask
    exact);
  * a scene of exact-t ties across clusters: the port, like the jnp
    reference, takes the lower triangle index;
  * the walk replay: its frames are the plain version's, its work less.
"""


import numpy as np
import pytest
import torch

import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.core.scene import configure_lighting as j_light
from madrona_renderer_tpu.ops import raytrace_pallas as jrp
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_raster_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu_torch.assets.png import write_png
from madrona_renderer_tpu_torch.ops import raster_cuda, walk_replay
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config, terrain_mesh
from tools.tpu_bigmesh_bench import terrain_mesh as j_terrain_mesh

from tests.torch_helpers import (
    IDENTITY, SceneSpec, assert_frames_close, carry_over, gradient_image, mip_spec,
    one_thread, quad_xz, terrain_spec,
)


def _cloud(seed, n_tris=3600, spread=10.0, y_lo=4.0, y_hi=40.0, jitter=0.4):
    """tests/test_pallas_parity.py's random triangle cloud."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n_tris, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(y_lo, y_hi, size=n_tris)
    tris = np.repeat(centers, 3, axis=0)
    tris[1::3] += rng.normal(size=(n_tris, 3)).astype(np.float32) * jitter
    tris[2::3] += rng.normal(size=(n_tris, 3)).astype(np.float32) * jitter
    return tris


def _inst(pos, obj=0, rot=IDENTITY, scale=(1, 1, 1)):
    return dict(position=list(pos), rotation=list(rot), scale=list(scale), object_id=obj)


def _world(n_inst, inst_off, n_cams=1, cam_off=0):
    return dict(num_instances=n_inst, instance_offset=inst_off, num_cameras=n_cams,
                camera_offset=cam_off)


def _origin_cams(n=1):
    cams = [dict(position=[0, 0, 0], rotation=IDENTITY),
            dict(position=[5, -2, 1], rotation=[0.96, 0, 0, 0.28])]
    return cams[:n]


def _cloud_spec(kind):
    """The streamed scenes of tests/test_pallas_parity.py (:176-233,
    :596-678) and tests/test_shadows.py (:158-195)."""
    if kind == "instances64":
        insts = [_inst([(i % 8 - 3.5) * 2, 0, (i // 8 - 3.5) * 2], scale=(0.5, 0.5, 0.5))
                 for i in range(64)]
        return SceneSpec(meshes=[_cloud(13, 500, 6.0, 4.0, 25.0, 0.5)], instances=insts,
                         cameras=_origin_cams(), worlds=[_world(64, 0)])
    if kind == "hetero":
        return SceneSpec(meshes=[_cloud(41)], cameras=_origin_cams() * 2,
                         instances=[_inst([0, 0, 0]), _inst([3, 5, 0], scale=(0.5,) * 3)],
                         worlds=[_world(2, 0, 1, 0), _world(1, 0, 1, 1)])
    if kind == "two_cams":
        return SceneSpec(meshes=[_cloud(43)], instances=[_inst([0, 0, 0])],
                         cameras=_origin_cams(2), worlds=[_world(1, 0, 2, 0)])
    seed = {"cloud": 11, "shadows": 17}[kind]
    return SceneSpec(meshes=[_cloud(seed)], instances=[_inst([0, 0, 0])],
                     cameras=_origin_cams(), worlds=[_world(1, 0)])


def _tie_spec(n_worlds=2):
    """Exact-t ties across clusters: instance 0 a quad 10 ahead of the
    camera, instance 1 the same quad at the same pose with a small triangle
    5 ahead (its cluster comes first in the visit order), and a 3,600-
    triangle cloud behind the camera that makes the mesh streamed."""
    small = np.asarray([[-0.5, -5.0, -0.5], [0.5, -5.0, -0.5], [0.0, -5.0, 0.5]], np.float32)
    quad = quad_xz(4.0)
    insts, worlds = [], []
    for w in range(n_worlds):
        insts += [_inst([0.01 * w, 10, 0], 0), _inst([0.01 * w, 10, 0], 1),
                  _inst([0, -60, 0], 2)]
        worlds.append(_world(3, 3 * w, 1, w))
    return SceneSpec(meshes=[quad, np.concatenate([quad, small]), _cloud(11)],
                     instances=insts, cameras=_origin_cams() * n_worlds, worlds=worlds)


def _both(spec, light=None):
    j_state, j_scene = spec.build_jax()
    if light is not None:
        j_scene = j_light(j_scene, *light)
    t_state, t_scene = carry_over(j_state, j_scene)
    assert trc.is_streamed(t_state, t_scene), "the scene must take the streamed route"
    return (j_state, j_scene), (t_state, t_scene)


# ------------------------------------------------------------ helpers ----
def test_terrain_mesh_is_the_bench_tool_mesh():
    for n in (40, 72):
        assert np.array_equal(terrain_mesh(n).view(np.uint32), j_terrain_mesh(n).view(np.uint32))


@pytest.mark.parametrize("case", ["terrain", "rotated", "two_cams"])
def test_cluster_order_and_rowspans_equal_jax(case):
    """Both helpers' integers equal JAX's on the same cluster bounds (the
    unrotated terrain: on the port's own refit, bitwise the JAX one), at the
    band heights 16 (the kernel's) and 32 (the JAX kernel's at 64x64)."""
    spec = terrain_spec(n_worlds=3, rotated=case == "rotated",
                         num_cams=2 if case == "two_cams" else 1)
    (j_state, j_scene), (t_state, t_scene) = _both(spec)
    j_lo, j_hi, j_valid, _ = jrp.world_clusters(j_state, j_scene)
    lo, hi, valid = (torch.from_numpy(np.array(x)) for x in (j_lo, j_hi, j_valid))
    if case != "rotated":
        t_lo, t_hi, t_valid, _ = trc.world_clusters(t_state, t_scene)
        assert torch.equal(t_lo, lo) and torch.equal(t_hi, hi) and torch.equal(t_valid, valid)
    j_order = np.asarray(jrp.camera_cluster_order(j_lo, j_hi, j_valid, j_state.camera_pos))
    order = trc.camera_cluster_order(lo, hi, valid, t_state.camera_pos)
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), j_order[:, 0].astype(np.int32))
    j_fov = np.where(np.asarray(j_state.camera_fov) > 0, np.asarray(j_state.camera_fov), 90.0)
    t_fov = torch.where(t_state.camera_fov > 0, t_state.camera_fov, 90.0)
    for height in (32, 64):
        for g_rows in (0, 16, 32):
            j_spans = np.asarray(jrp.camera_cluster_rowspans(
                j_lo, j_hi, j_valid, j_state, j_fov.astype(np.float32), height, g_rows=g_rows))
            spans = trc.camera_cluster_rowspans(lo, hi, valid, t_state, t_fov, height,
                                                g_rows=g_rows)
            np.testing.assert_array_equal(spans.numpy(), j_spans, err_msg=f"{height} {g_rows}")


def test_route_choice():
    """Past the resident budget pack_inputs adds the order and the spans (at
    16-row bands) and the streamed variants are named; a resident scene of
    one cluster takes the non-culled sweep under "auto" (K1-none, no
    cluster table: the JAX render_core's route since the ninth slice; K1
    before) and K1 under "clusters" (no order, no spans), and spans without
    an order or bins raise."""
    _, (t_state, t_scene) = _both(terrain_spec())
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32)
    assert kw["order"].shape == (2, kw["clusters"].shape[2])
    assert kw["spans"].shape == (2, 2, kw["clusters"].shape[2])
    assert trc.variant_name(False, None, "prep", trc.Route(True, "ordered")) == "render_streamed"
    assert "render_streamed_raw_shadows_raster_tex_mip" in trc.VARIANTS
    small = SceneSpec(meshes=[quad_xz(4.0)], instances=[_inst([0, 10, 0])],
                      cameras=_origin_cams(), worlds=[_world(1, 0)])
    s_state, s_scene = small.build_torch()
    assert not trc.is_streamed(s_state, s_scene)
    kw = trc.pack_inputs(s_state, s_scene, height=16, width=16)
    assert kw["order"] is None and kw["spans"] is None and kw["clusters"] is None
    with pytest.raises(ValueError, match="no visit inputs"):
        trc.render_resident(**dict(kw, spans=torch.zeros((1, 2, 1), dtype=torch.int32)))
    kw = trc.pack_inputs(s_state, s_scene, height=16, width=16, accel="clusters")
    assert kw["order"] is None and kw["spans"] is None and kw["clusters"] is not None
    with pytest.raises(ValueError, match="both order and spans"):
        trc.render_resident(**dict(kw, spans=torch.zeros((1, 2, 1), dtype=torch.int32)))


def test_cluster_table_past_shared_memory_raises(monkeypatch):
    """A cluster table too large for the ordered walk's shared memory no
    longer raises: the scene takes the binned route (K4, whose block keeps
    no cluster table), whatever accel says, and renders the plain frames;
    the binned walk's replay renders them too."""
    _, (t_state, t_scene) = _both(terrain_spec())
    plain = trc.render_resident_plain(**trc.pack_inputs(t_state, t_scene, height=32, width=32))
    monkeypatch.setattr(trc, "_MAX_SMEM", 1024)
    trc.check_supported(t_state, t_scene)
    for accel in ("auto", "clusters"):
        kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, accel=accel)
        assert kw["bins"] is not None and kw["order"] is None
        out = trc.render_resident(**kw)
        assert all(torch.equal(a, b) for a, b in zip(out, plain))
    with one_thread():
        replay = walk_replay.binned_walk(**kw)
    assert torch.equal(replay["depth"], plain[0]) and torch.equal(replay["segmask"], plain[1])


# ------------------------------------------------------------- frames ----
FRAMES = {
    # name: (spec, height, width, light)
    "terrain40_32x32": (lambda: terrain_spec(), 32, 32, None),
    "cloud3600_16x16": (lambda: _cloud_spec("cloud"), 16, 16, None),
    "instances64_16x16": (lambda: _cloud_spec("instances64"), 16, 16, None),
    "hetero_worlds_16x16": (lambda: _cloud_spec("hetero"), 16, 16, None),
    "two_cams_16x16": (lambda: _cloud_spec("two_cams"), 16, 16, None),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_streamed_frames_match_jax(name):
    make, h, w, _ = FRAMES[name]
    (j_state, j_scene), (t_state, t_scene) = _both(make())
    port = trc.raytrace(t_state, t_scene, height=h, width=w)
    ref = j_ref(j_state, j_scene, height=h, width=w)
    assert_frames_close(ref, port)
    assert_frames_close(j_pallas(j_state, j_scene, height=h, width=w, interpret=True), port)
    assert (port.segmask.numpy() >= 0).any()


def test_streamed_raster_matches_jax():
    (j_state, j_scene), (t_state, t_scene) = _both(terrain_spec())
    port = raster_cuda.rasterize(t_state, t_scene, height=32, width=32)
    for j in (j_raster_ref(j_state, j_scene, height=32, width=32),
              j_raster_pallas(j_state, j_scene, height=32, width=32, interpret=True)):
        assert np.abs(np.asarray(j.rgb, np.int16) - port.rgb.numpy().astype(np.int16)).max() <= 1
        np.testing.assert_allclose(np.asarray(j.depth), port.depth.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_streamed_shadows_match_jax():
    """tests/test_shadows.py:158-195: shadows on the streamed cloud."""
    (j_state, j_scene), (t_state, t_scene) = _both(
        _cloud_spec("shadows"), light=((0.5, 1, 0), (1, 1, 1)))
    port = trc.raytrace(t_state, t_scene, height=16, width=16, shadows=True)
    assert_frames_close(j_ref(j_state, j_scene, height=16, width=16, shadows=True), port)
    assert_frames_close(j_pallas(j_state, j_scene, height=16, width=16, interpret=True,
                                 shadows=True), port)
    lit = trc.raytrace(t_state, t_scene, height=16, width=16)
    assert (lit.rgb.numpy() != port.rgb.numpy()).any()


def test_streamed_mips_match_jax(tmp_path):
    """tests/test_mips.py:286-306: a streamed cloud in front of a mip-mapped
    floor."""
    path = str(tmp_path / "gradient.png")
    write_png(path, gradient_image(256))
    spec = mip_spec(path, extra_mesh=_cloud(31, 3600, 30.0, 4.0, 50.0, 1.0))
    (j_state, j_scene), (t_state, t_scene) = _both(spec)
    assert trc.has_mips(t_scene)
    port = trc.raytrace(t_state, t_scene, height=16, width=16)
    assert_frames_close(j_ref(j_state, j_scene, height=16, width=16), port)
    assert_frames_close(j_pallas(j_state, j_scene, height=16, width=16, interpret=True), port)


def test_exact_ties_take_the_lower_index():
    """Every quad pixel ties between instances 0 and 1 (the same quad at the
    same pose); instance 1's cluster is visited first. The port, its walk
    replay and the jnp reference give instance 0. The JAX Pallas ordered
    sweep accepts only t < best_t (its tie rule is off without row-sorted
    ranges), so it keeps instance 1, the first visited: a property of that
    reference, not of the port."""
    (j_state, j_scene), (t_state, t_scene) = _both(_tie_spec())
    port = trc.raytrace(t_state, t_scene, height=32, width=32)
    ref = j_ref(j_state, j_scene, height=32, width=32)
    assert_frames_close(ref, port)
    seg = port.segmask.numpy()
    quad = seg == 0
    assert quad.sum() > 100 and (seg == 1).any()  # the quad, and the small triangle
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32)
    with one_thread():
        replay = walk_replay.streamed_walk(**kw)
    assert torch.equal(replay["segmask"].reshape(seg.shape), port.segmask)
    pallas = np.asarray(j_pallas(j_state, j_scene, height=32, width=32, interpret=True).segmask)
    assert (pallas[quad] == 1).all()


@pytest.mark.parametrize("case", ["terrain_prep", "terrain_raw_two_cams", "tie"])
def test_walk_replay_is_the_plain_sweep_with_less_work(case):
    """The replay of the streamed kernel's walk (order, early exit, row gate,
    slab test) renders the plain version's depth and segmask bitwise while
    sweeping a fraction of the triangles."""
    spec = (_tie_spec() if case == "tie"
            else terrain_spec(num_cams=2 if "two_cams" in case else 1))
    t_state, t_scene = spec.build_torch()
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32)
    depth, seg, _ = trc.render_resident_plain(**kw)
    with one_thread():
        replay = walk_replay.streamed_walk(**kw)
    assert torch.equal(replay["depth"], depth) and torch.equal(replay["segmask"], seg)
    views, blocks = kw["cams"].shape[0], 4
    full = views * blocks * kw["rows"].shape[2]
    assert 0 < replay["triangle_visits"] < full / 4
    assert replay["cluster_visits"] <= replay["slab_tests"] <= replay["gated"]


def test_bigmesh_manager_renders_and_steps():
    """bench.py's bigmesh scene (at a 40x40 grid) through the port's Manager on
    the CPU: moving world 0's terrain changes its frames, not world 1's."""
    r = tm.Manager(bigmesh_config(2, 32, 32, grid=40, device="cpu"))
    rgb0 = r.rgb_tensor().to_torch().clone()
    pos = r.instance_position_tensor().to_torch()
    pos[0][2] += 0.5
    r.step()
    rgb1 = r.rgb_tensor().to_torch()
    assert not torch.equal(rgb0[0], rgb1[0]) and torch.equal(rgb0[1], rgb1[1])
    assert set(r.segmask_tensor().to_torch().unique().tolist()) == {-1, 0, 1}
