"""PyTorch port: the watertight decision sweep (kernel K10) == the JAX
package's.

Under ``watertight=True`` every scene takes the raw rows and the sweep
decides each primary hit by the Woop sheared edge-function test
(``ops/watertight.py``), ANDed with the pack's validity row 9; the
Möller–Trumbore (u, v) only interpolate the winner's attributes, and the
shadow rays stay Möller–Trumbore. On the CPU the kernel's plain version
renders. Held against both JAX paths on the same inputs, at the knife-edge
bar of tests/test_watertight_pallas.py:48-69: XLA:CPU contracts
``a*b - c*d`` into a fused multiply-add inside compiled code (the jnp
reference's scan, the interpret-mode kernel under jit), which moves
exactly-zero edge functions by ±1 ulp, so at most a handful of pixels may
flip their decision, each a crack of the reference's; everywhere else rgb
±1 LSB, depth 1e-5 (the demo's huge ground plane: the JAX package's
watertight depth bar, rel 1e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_renderer_tpu as jm
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.ops import watertight as j_wt
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_raster_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu.runners.scenes import demo_config
from madrona_renderer_tpu.runners.scenes import demo_config as j_demo
from madrona_renderer_tpu_torch.ops import raster_cuda, walk_replay
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.ops import watertight as t_wt
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config, renderer_kwargs
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo

from tests.test_watertight import _edge_targets, _grid_mesh, _interior_edges
from tests.torch_helpers import IDENTITY, SceneSpec, carry_over, one_thread, quad_xz, \
    spec_from_config, terrain_spec


def _quad_seam_spec(split_instances=True):
    """tests/test_watertight_pallas.py's crack scene: two triangles sharing
    the quad diagonal, 3 ahead of a camera at the origin, in two instances
    (a seam across clusters) or in one."""
    tri_a = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1]], np.float32)
    tri_b = np.array([[-1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    pose = dict(position=[0, 3, 0], rotation=IDENTITY, scale=[1, 1, 1])
    if split_instances:
        meshes = [tri_a, tri_b]
        insts = [dict(object_id=0, **pose), dict(object_id=1, **pose)]
    else:
        meshes = [np.concatenate([tri_a, tri_b])]
        insts = [dict(object_id=0, **pose)]
    return SceneSpec(meshes=meshes, instances=insts,
                     cameras=[dict(position=[0, 0, 0], rotation=IDENTITY)],
                     worlds=[dict(num_instances=len(insts), instance_offset=0,
                                  num_cameras=1, camera_offset=0)])


def _shadow_spec():
    """tests/test_watertight_pallas.py:109-124: a ground quad 10 ahead and a
    thin occluder 5 ahead of a camera at the origin."""
    return SceneSpec(
        meshes=[quad_xz(100.0)],
        instances=[dict(position=[0, 10, 0], rotation=IDENTITY, scale=[1, 1, 1],
                        object_id=0),
                   dict(position=[0, 5, 0], rotation=IDENTITY, scale=[0.05, 1, 0.05],
                        object_id=0)],
        cameras=[dict(position=[0, 0, 0], rotation=IDENTITY)],
        worlds=[dict(num_instances=2, instance_offset=0, num_cameras=1, camera_offset=0)])


def _both(spec):
    j_state, j_scene = spec.build_jax()
    return (j_state, j_scene), carry_over(j_state, j_scene)


def _assert_frames_equal_knife_edge(a, b, max_flips=4, far=None):
    """tests/test_watertight_pallas.py:48-69 with the port's frames as
    ``b``: pixels whose decision flipped (a segmask disagreement, or in
    raster mode a depth hit/miss flip) are exempt, at most ``max_flips``;
    elsewhere rgb ±1 LSB, depth rtol = atol = 1e-5. The pixels of the mask
    ``far`` take the JAX package's watertight depth bar, rel 1e-3
    (tools/tpu_parity_check.py::wt_depth_ok): on the demo's 20,000-unit
    ground plane the edge functions cancel some 10^3 times over, so the
    Woop t rounds apart by up to 3.5e-4 between any two of the three paths
    (JAX's jnp reference and Pallas kernel differ by 2.8e-4 there)."""
    seg_a, seg_b = np.asarray(a.segmask), b.segmask.numpy()
    if (seg_a == -1).all() and (seg_b == -1).all():
        flip = (np.asarray(a.depth) > 0) != (b.depth.numpy() > 0)
    else:
        flip = seg_a != seg_b
    assert flip.sum() <= max_flips, f"{flip.sum()} knife-edge flips"
    # Every flip is a crack of the reference: the port shows a surface
    # nearer than the reference's there (no crack opens in the port).
    d_a, d_b = np.asarray(a.depth)[flip], b.depth.numpy()[flip]
    assert ((d_b > 0) & ((d_a == 0) | (d_b < d_a))).all(), "a crack in the port"
    same = ~flip
    rgb_a = np.asarray(a.rgb).astype(np.int16)[same]
    rgb_b = b.rgb.numpy().astype(np.int16)[same]
    assert np.abs(rgb_a - rgb_b).max() <= 1
    far = np.zeros_like(same) if far is None else far
    near = same & ~far
    np.testing.assert_allclose(np.asarray(a.depth)[near], b.depth.numpy()[near],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.depth)[same & far], b.depth.numpy()[same & far],
                               rtol=1e-3, atol=0)


# ------------------------------------------------------------- module ----
@pytest.mark.parametrize("jitter", [None, 0.25])
def test_woop_intersect_matches_jax_and_edge_rays_hit(jitter):
    """``woop_intersect`` on explicit vertices equals the JAX module's,
    bitwise (both round each operation on its own here), and every ray
    through a shared edge or vertex of tests/test_watertight.py:69's grid
    hits (no crack)."""
    v0, v1, v2, verts, faces = _grid_mesh(n=4, jitter=jitter)
    targets = np.concatenate([
        _edge_targets(verts, _interior_edges(faces), fracs=[0.25, 0.5, 0.75]),
        verts[(np.abs(verts[:, 0]) < 2.0) & (np.abs(verts[:, 1]) < 2.0)]])
    origins = np.array([[0.3, -0.7, 5.0], [-2.1, 1.3, 7.0], [4.0, 3.0, 3.0]], np.float32)
    for o in origins:
        dirs = targets - o[None, :]
        jt, jacc, jbary = j_wt.woop_intersect(jnp.asarray(o), jnp.asarray(dirs),
                                              jnp.asarray(v0), jnp.asarray(v1),
                                              jnp.asarray(v2))
        t, acc, bary = t_wt.woop_intersect(*(torch.from_numpy(x) for x in (o, dirs, v0, v1, v2)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(bary.numpy(), np.asarray(jbary))
        ok = acc & (t > 0.0) & torch.isfinite(t)
        assert ok.any(dim=1).all(), "an edge or vertex ray fell through a crack"


def test_shear_select_is_the_one_hot_frame():
    """The kernel's select-form shear frame equals the one-hot form on rays
    whose largest components tie (|dx| = |dz|, |dx| = |dy| = |dz|) and on
    random rays."""
    rng = np.random.default_rng(5)
    d = np.concatenate([rng.normal(size=(64, 3)),
                        [[1, 0.5, -1], [-2, 2, 2], [0.5, -0.5, 0.25], [0, 0, -3]]])
    d = torch.from_numpy(d.astype(np.float32))
    ox, oy, oz, sx, sy, sz = t_wt._shear_frame(d)
    kz_x, kz_y, s_x, s_y, s_z = t_wt.shear_select(d[:, 0], d[:, 1], d[:, 2])
    assert torch.equal(kz_x, oz[:, 0] > 0) and torch.equal(kz_y, oz[:, 1] > 0)
    assert torch.equal(s_x, sx) and torch.equal(s_y, sy) and torch.equal(s_z, sz)


# ------------------------------------------------------------- frames ----
FRAMES = {
    # name: (spec, height, width, shadows, max_flips, instance held to the
    # watertight depth bar)
    "seam_split_32x32": (lambda: _quad_seam_spec(True), 32, 32, False, 4, None),
    "seam_unsplit_32x32": (lambda: _quad_seam_spec(False), 32, 32, False, 4, None),
    # The occluder fills the view; the JAX paths' contracted edge functions
    # open 4 (jnp) and 6 (Pallas) crack pixels on its diagonal seam.
    "shadows_32x32": (_shadow_spec, 32, 32, True, 8, None),
    "demo_textured_16x16": (lambda: spec_from_config(demo_config(
        2, RenderMode.Raytracer, 16, 16, dynamic=True, textured=True, tex_size=32)),
        16, 16, False, 8, 1),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_watertight_frames_match_jax(name):
    make, h, w, shadows, flips, far_instance = FRAMES[name]
    (j_state, j_scene), (t_state, t_scene) = _both(make())
    port = trc.raytrace(t_state, t_scene, height=h, width=w, shadows=shadows,
                        watertight=True)
    assert (port.segmask.numpy() >= 0).sum() > 50
    far = None if far_instance is None else port.segmask.numpy() == far_instance
    _assert_frames_equal_knife_edge(
        j_ref(j_state, j_scene, height=h, width=w, shadows=shadows, watertight=True),
        port, flips, far)
    _assert_frames_equal_knife_edge(
        j_pallas(j_state, j_scene, height=h, width=w, shadows=shadows, interpret=True,
                 watertight=True), port, flips, far)


def test_watertight_raster_matches_jax():
    """tests/test_watertight_pallas.py:127-135: raster mode on the seam."""
    (j_state, j_scene), (t_state, t_scene) = _both(_quad_seam_spec())
    port = raster_cuda.rasterize(t_state, t_scene, height=32, width=32, watertight=True)
    for ref in (j_raster_ref(j_state, j_scene, height=32, width=32, watertight=True),
                j_raster_pallas(j_state, j_scene, height=32, width=32, interpret=True,
                                watertight=True)):
        _assert_frames_equal_knife_edge(ref, port)


def test_streamed_watertight_matches_jax():
    """The 40x40-grid terrain past the resident budget (the shape
    tests/test_torch_bigmesh.py uses): the streamed route with K10's
    decision against both JAX paths, and the walk replay renders the plain
    version's frames."""
    (j_state, j_scene), (t_state, t_scene) = _both(terrain_spec())
    assert trc.is_streamed(t_state, t_scene)
    port = trc.raytrace(t_state, t_scene, height=32, width=32, watertight=True)
    for ref in (j_ref(j_state, j_scene, height=32, width=32, watertight=True),
                j_pallas(j_state, j_scene, height=32, width=32, interpret=True,
                         watertight=True)):
        _assert_frames_equal_knife_edge(ref, port)
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, watertight=True)
    assert kw["geo"] == "raw_wt" and kw["order"] is not None
    with one_thread():
        replay = walk_replay.streamed_walk(**kw)
    assert torch.equal(replay["segmask"], port.segmask[:, 0])
    assert torch.equal(replay["depth"], port.depth[:, 0])


def test_watertight_no_interior_crack():
    """tests/test_watertight_pallas.py:138-154: pixels strictly inside the
    seam quad's projection never miss through the shared diagonal."""
    t_state, t_scene = _quad_seam_spec().build_torch()
    seg = trc.raytrace(t_state, t_scene, height=64, width=64,
                       watertight=True).segmask.numpy()[0, 0]
    lo = int(np.ceil(64 * (0.5 - 1.0 / 6.0))) + 2
    hi = int(np.floor(64 * (0.5 + 1.0 / 6.0))) - 2
    interior = seg[lo:hi, lo:hi]
    assert interior.size > 100
    assert (interior >= 0).all(), f"{(interior < 0).sum()} crack pixels inside the quad"


def test_watertight_decision_really_changes():
    """tests/test_watertight_pallas.py:157-175: the watertight render's hit
    t differs in its bits somewhere from the ε-slack render's (the flag
    reaches the sweep) while agreeing geometrically."""
    t_state, t_scene = _quad_seam_spec().build_torch()
    f_wt = trc.raytrace(t_state, t_scene, height=32, width=32, watertight=True)
    f_mt = trc.raytrace(t_state, t_scene, height=32, width=32)
    d_wt, d_mt = f_wt.depth.numpy(), f_mt.depth.numpy()
    both = (f_wt.segmask.numpy() >= 0) & (f_mt.segmask.numpy() >= 0)
    assert both.any()
    assert (d_wt[both].view(np.uint32) != d_mt[both].view(np.uint32)).any()
    np.testing.assert_allclose(d_wt[both], d_mt[both], rtol=1e-4, atol=1e-4)


def test_route_and_validity_row():
    """Watertight takes the raw rows even for one camera without shadows;
    the variants are named; the validity row 9 masks a disabled instance,
    whose zero edges also leave every edge function exactly zero."""
    t_state, t_scene = _quad_seam_spec().build_torch()
    assert trc.pack_inputs(t_state, t_scene, height=16, width=16)["geo"] == "prep"
    kw = trc.pack_inputs(t_state, t_scene, height=16, width=16, watertight=True)
    assert kw["geo"] == "raw_wt"
    assert trc.pack_inputs(t_state, t_scene, height=16, width=16, watertight=True,
                           shadows=True)["geo"] == "raw_wt_shadows"
    assert trc.variant_name(False, "nearest", "raw_wt") == "render_resident_raw_wt_tex_nearest"
    assert len(trc.VARIANTS) == 80 and "render_streamed_raw_wt_shadows_raster_tex_mip" in trc.VARIANTS
    valid = kw["rows"][0, 9].reshape(2, -1)  # [instance, triangle slot]
    assert valid[:, 0].tolist() == [1.0, 1.0]
    off = dataclasses.replace(t_state, instance_valid=torch.tensor([[1.0, 0.0]]))
    kw = trc.pack_inputs(off, t_scene, height=32, width=32, watertight=True)
    assert not kw["rows"][0, 9].reshape(2, -1)[1].any()
    assert set(trc.render_resident(**kw)[1].unique().tolist()) == {-1, 0}


@pytest.mark.parametrize("case", ["rasterizer", "streamed"])
def test_manager_watertight(case):
    """MadronaRenderer(watertight=True) in raster mode, against the JAX
    Manager at the knife-edge bar (the demo's plane at the watertight depth
    bar, found by a raytraced render of the same state), and on a streamed
    mesh: the Manager's frames are the port's watertight raytrace of its
    state, and they differ from the ε-slack render's somewhere."""
    if case == "streamed":
        r = tm.Manager(bigmesh_config(2, 16, 16, grid=40, watertight=True, device="cpu"))
        assert trc.is_streamed(r.state, r.scene)
        want = trc.raytrace(r.state, r.scene, height=16, width=16, watertight=True)
        assert torch.equal(r.frames.depth, want.depth)
        assert torch.equal(r.frames.rgb, want.rgb)
        eps = trc.raytrace(r.state, r.scene, height=16, width=16)
        assert not torch.equal(r.frames.depth, eps.depth)
        return
    kw = renderer_kwargs(t_demo(2, tm.RenderMode.Rasterizer, 16, 16, dynamic=True))
    t = tm.MadronaRenderer(0, 2, tm.RenderMode.Rasterizer, 16, 16, device="cpu",
                           watertight=True, **kw)
    j = jm.Manager(j_demo(2, jm.RenderMode.Rasterizer, 16, 16, dynamic=True, impl="jnp",
                          watertight=True))
    plane = trc.raytrace(t.state, t.scene, height=16, width=16,
                         watertight=True).segmask.numpy() == 1
    _assert_frames_equal_knife_edge(j.frames, t.frames, far=plane)
    assert t.depth_tensor().shape == (2, 16, 16, 1)
