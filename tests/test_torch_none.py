"""PyTorch port: the non-culled sweep K1-none (``accel="none"``) == the JAX
package's.

``accel="none"``, and ``"auto"`` on worlds of fewer than 16 triangles or a
single cluster, take the JAX ``render_core``'s non-culled launch
(``raytrace_pallas.py:4911``): every triangle for every pixel, no cluster
table. The port's ``pack_inputs`` gives that route no cluster table
(``clusters`` None) and ``render_resident`` launches K1-none
(``csrc/render_none.cu``) on the card, its plain version (K1's, which
sweeps every triangle) on the CPU. Held here against the JAX Pallas kernel
in interpret mode and the jnp reference at tests/test_pallas_parity.py's
bar (rgb within ±1 LSB, depth rtol = atol = 1e-5, segmask exact), on
tests/test_pallas_parity.py:136's scene; the route where the JAX
``render_core`` skips its clusters; the SMEM-budget refusal
(tests/test_pallas_parity.py:199-201); the warm start on it.
"""

import numpy as np
import pytest
import torch

import madrona_renderer_tpu.ops.raytrace_pallas as jrp
from madrona_renderer_tpu.config import ImportedInstance
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu_torch.ops import raster_cuda, warmstart
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc

from tests.helpers import build, cam_at_origin_looking_plus_y, quad_xz
from tests.torch_helpers import assert_frames_close, carry_over, random_spec


def _cloud_and_wall():
    """tests/test_pallas_parity.py::test_parity_cluster_culled_large_mesh's
    scene: a 300-triangle cloud in front of a wall."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(-8, 8, size=(300, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(5, 30, size=300)
    tris = []
    for c in centers:
        tris += [c + rng.normal(size=3) * 0.5 for _ in range(3)]
    return build(
        [np.asarray(tris, np.float32), quad_xz(half=50.0, y=0.0)],
        [ImportedInstance(position=[0, 0, 0], rotation=[1, 0, 0, 0], scale=[1, 1, 1],
                          object_id=0),
         ImportedInstance(position=[0, 35, 0], rotation=[1, 0, 0, 0], scale=[1, 1, 1],
                          object_id=1)],
        [cam_at_origin_looking_plus_y()],
    )


def test_none_frames_match_jax():
    """accel="none" against the JAX non-culled Pallas kernel and the jnp
    reference; the culled routes' frames are the same, bit for bit."""
    j_state, j_scene = _cloud_and_wall()
    t_state, t_scene = carry_over(j_state, j_scene)
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, accel="none")
    assert kw["clusters"] is None and kw["order"] is None and kw["bins"] is None
    assert trc.route_of(kw["order"], kw["spans"], kw["bins"], culled=False) == trc.NONE
    port = trc.raytrace(t_state, t_scene, height=32, width=32, accel="none")
    assert_frames_close(j_ref(j_state, j_scene, height=32, width=32), port)
    assert_frames_close(jrp.raytrace(j_state, j_scene, height=32, width=32, interpret=True,
                                     accel="none"), port)
    assert set(np.unique(port.segmask.numpy())) >= {0, 1}
    for accel in ("auto", "clusters"):
        culled = trc.raytrace(t_state, t_scene, height=32, width=32, accel=accel)
        for a, b in zip((culled.rgb, culled.depth, culled.segmask),
                        (port.rgb, port.depth, port.segmask)):
            assert torch.equal(a, b)
    # Raster conventions, and shadows (the non-culled sweep's own shadow
    # rays, every triangle per light).
    assert_frames_close(j_raster_ref(j_state, j_scene, height=32, width=32),
                        raster_cuda.rasterize(t_state, t_scene, height=32, width=32,
                                              accel="none"))
    assert_frames_close(j_ref(j_state, j_scene, height=32, width=32, shadows=True),
                        trc.raytrace(t_state, t_scene, height=32, width=32, shadows=True,
                                     accel="none"))


@pytest.mark.parametrize("seed", [0, 3, 21])
def test_auto_skips_clusters_where_jax_does(seed, monkeypatch):
    """accel="auto" takes the non-culled route exactly where the JAX
    render_core traces no cluster refit (fewer than 16 triangles or one
    cluster a world): the random scenes' tiny worlds, not the cloud."""
    scenes = [random_spec(seed, n_worlds=2).build_jax(), _cloud_and_wall()]
    for j_state, j_scene in scenes:
        called = []
        real = jrp.world_clusters
        monkeypatch.setattr(jrp, "world_clusters",
                            lambda *a, **k: called.append(1) or real(*a, **k))
        import jax

        jax.eval_shape(lambda s: jrp.render_core(s, j_scene, height=32, width=32, near=0.1,
                                                 far=1000.0, fov_y_degrees=90.0,
                                                 interpret=True), j_state)
        monkeypatch.setattr(jrp, "world_clusters", real)
        t_state, t_scene = carry_over(j_state, j_scene)
        route = trc.visit_route(t_state, t_scene, 32, 32, "auto")
        assert (route == trc.NONE) == (not called), (seed, route)
        S = t_state.max_instances * t_scene.tris_per_object
        n_cl = t_state.max_instances * int(t_scene.cl_valid.shape[1])
        assert (route == trc.NONE) == (S < 16 or n_cl < 2)
        assert trc.visit_route(t_state, t_scene, 32, 32, "none") == trc.NONE


def test_none_past_the_budget_raises():
    """tests/test_pallas_parity.py:199-201: accel="none" on a mesh past the
    resident budget raises the JAX package's ValueError; "clusters" streams
    it."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(-10, 10, size=(3600, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(4, 40, size=3600)
    tris = np.repeat(centers, 3, axis=0)
    tris[1::3] += rng.normal(size=(3600, 3)).astype(np.float32) * 0.4
    tris[2::3] += rng.normal(size=(3600, 3)).astype(np.float32) * 0.4
    j_state, j_scene = build(
        [tris], [ImportedInstance(position=[0, 0, 0], rotation=[1, 0, 0, 0], scale=[1, 1, 1],
                                  object_id=0)],
        [cam_at_origin_looking_plus_y()])
    t_state, t_scene = carry_over(j_state, j_scene)
    with pytest.raises(ValueError, match="SMEM budget"):
        trc.raytrace(t_state, t_scene, height=16, width=16, accel="none")
    assert trc.visit_route(t_state, t_scene, 16, 16, "clusters").streamed


def test_none_warm_start_is_bitwise_cold():
    """The warm start on K1-none (the JAX non-culled launch takes the seed):
    a stale seed's suspects are repaired, the frames bitwise a cold
    render's."""
    j_state, j_scene = _cloud_and_wall()
    t_state, t_scene = carry_over(j_state, j_scene)
    kw = dict(height=32, width=32, accel="none")
    cold = trc.raytrace(t_state, t_scene, **kw)
    prev = torch.where(cold.depth > 0, cold.depth * 0.7, 1000.0)
    warm = warmstart.raytrace_warmstart(t_state, t_scene, prev_depth=prev, **kw)
    for a, b in zip((warm.rgb, warm.depth, warm.segmask), (cold.rgb, cold.depth, cold.segmask)):
        assert torch.equal(a, b)


def test_none_entries():
    """csrc/render_none.cu's entries: K1-none in every GEO, raster and TEX
    mode K1 has and the 9-output mode (no shadow geometry there), each
    raytrace variant seeded too; K1's 9-output entries."""
    assert len(trc.NONE_VARIANTS) == 69 and len(trc.NINE_VARIANTS) == 9
    assert "render_none_raw_wt_shadows_raster_tex_mip" in trc.NONE_VARIANTS
    assert "render_none_seeded_raw_nine" in trc.NONE_VARIANTS
    assert not any("shadows" in n for n in trc.NINE_VARIANTS)
    assert trc.library_of(trc.NONE, False) == trc.library_of(trc.INDEX, True, "nine") \
        == "render_none"
    assert set(trc.NONE_VARIANTS + trc.NINE_VARIANTS) <= set(trc.RENDER_VARIANTS)
