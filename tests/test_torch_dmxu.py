"""PyTorch port: the deferred matmul sweep K11 (``deferred_mxu``) == the JAX
package's ``MRT_DEFERRED_MXU=1``.

On the streamed route's deferred visits (binned, or ordered), without
shadows and without the watertight decision, the JAX ``render_core`` turns
its ``dmxu`` switch on, and ``rowskip`` where its TPU tiling has more than
one tile across. The port takes the same keyword (``deferred_mxu``, the
port reads no environment knobs) to the same place (``dmxu_route``): K11
on the card, on the CPU the plain version (the index-order sweep; on raw
rows of each view's D, A, Q, t_num), and ``walk_replay.dmxu_walk`` replays
K11's walk. Held against the JAX package on the same inputs:
  * the route: ``dmxu`` and ``rowskip`` where the JAX ``render_core`` hands
    them to ``_render_kernel`` (a spy on the factory, traced afresh under
    the variable) on streamed binned and ordered, resident, ``"none"``,
    ``"mxu"``, shadows, watertight, and 128² against 64×256;
  * frames against the jnp reference and the Pallas kernel in interpret
    mode under ``MRT_DEFERRED_MXU=1`` on tests/test_pallas_parity.py's
    dense fields (binned 16², ordered 16², ``rowskip`` at 64×256; rgb ±1
    LSB, depth 1e-5, segmask exact). The JAX ``raytrace`` is jitted on
    shapes and keywords only and reads the variable while it traces, so
    each JAX call here clears the caches and the spy asserts that
    ``dmxu=True`` reached the kernel factory;
  * streamed raster, the paged-mips scene of tests/test_mips.py:647-667,
    ``rowskip=False`` against ``rowskip=True``, the replayed walk bitwise
    the plain frames with less work under the row gate, exact ties to the
    lower index, and ``Manager(deferred_mxu=True)``.
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
from madrona_renderer_tpu_torch.assets.png import write_png
from madrona_renderer_tpu_torch.ops import raster_cuda, walk_replay
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.ops.quat import quat_multiply, quat_normalize
from madrona_renderer_tpu_torch.runners.scenes import binned_terrain_config, demo_config

from tests.test_pallas_parity import _dense_field_scene
from tests.test_torch_bigmesh import _both, _tie_spec
from tests.torch_helpers import (
    assert_frames_close, carry_over, gradient_image, mip_spec, one_thread, spec_from_config,
    terrain_spec,
)


@functools.cache
def _dense(seed, two_instances=True):
    """tests/test_pallas_parity.py's dense field (3,600 triangles a mesh,
    streamed), built by the JAX package and carried over, once a worker."""
    j_state, j_scene = _dense_field_scene(seed=seed, two_instances=two_instances)
    return (j_state, j_scene), carry_over(j_state, j_scene)


@functools.cache
def _demo():
    """The demo scene (resident), built by the JAX package and carried over."""
    cfg = demo_config(2, tm.RenderMode.Raytracer, 16, 16, dynamic=True)
    j_state, j_scene = spec_from_config(cfg).build_jax()
    return (j_state, j_scene), carry_over(j_state, j_scene)


def _spy(monkeypatch):
    """Record the dmxu / rowskip each call of the JAX kernel factory gets."""
    seen = []
    real = jrp._render_kernel

    def factory(*a, **k):
        seen.append((bool(k.get("dmxu")), bool(k.get("rowskip"))))
        return real(*a, **k)

    monkeypatch.setattr(jrp, "_render_kernel", factory)
    return seen


def _jax_dmxu(monkeypatch, fn, *args, **kw):
    """``fn`` traced afresh under MRT_DEFERRED_MXU=1, the spy asserting that
    dmxu=True reached the kernel factory."""
    seen = _spy(monkeypatch)
    monkeypatch.setenv("MRT_DEFERRED_MXU", "1")
    jax.clear_caches()
    out = fn(*args, **kw)
    assert seen and all(d for d, _ in seen), seen
    return out, seen


# ---------------------------------------------------------------- route ----
ROUTE_CASES = {
    # name: (scene, height, width, accel, shadows, watertight)
    "streamed_binned": ("dense41", 16, 16, "binned", False, False),
    "streamed_ordered": ("dense47", 16, 16, "clusters", False, False),
    "resident": ("demo", 16, 16, "auto", False, False),
    "none": ("demo", 16, 16, "none", False, False),
    "mxu": ("dense41", 16, 16, "mxu", False, False),
    "shadows": ("dense41", 16, 16, "binned", True, False),
    "watertight": ("dense41", 16, 16, "binned", False, True),
    "binned_128": ("dense59", 128, 128, "binned", False, False),
    "binned_64x256": ("dense59", 64, 256, "binned", False, False),
}


def _scene(name):
    if name == "demo":
        return _demo()
    seed = int(name[len("dense"):])
    return _dense(seed, two_instances=seed != 47)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_is_jax_render_core(case, monkeypatch):
    """dmxu_route gives the dmxu and rowskip that the JAX render_core hands
    its kernel factory under MRT_DEFERRED_MXU=1 (none at all where it takes
    another kernel: accel="mxu"); the trace stops at the pallas_call."""
    scene, h, w, accel, shadows, watertight = ROUTE_CASES[case]
    (j_state, j_scene), (t_state, t_scene) = _scene(scene)
    seen = _spy(monkeypatch)
    monkeypatch.setenv("MRT_DEFERRED_MXU", "1")

    class KernelReached(Exception):
        pass

    def stop(*a, **k):
        raise KernelReached

    monkeypatch.setattr(jrp, "pl", types.SimpleNamespace(**dict(vars(jrp.pl),
                                                                pallas_call=stop)))
    with pytest.raises(KernelReached):
        jax.eval_shape(lambda s: jrp.render_core(s, j_scene, height=h, width=w, near=0.1,
                                                 far=1000.0, fov_y_degrees=90.0,
                                                 interpret=True, accel=accel,
                                                 shadows=shadows, watertight=watertight),
                       j_state)
    jax_flags = seen[0] if seen else (False, False)
    port = trc.dmxu_route(t_state, t_scene, h, w, accel=accel, shadows=shadows,
                          watertight=watertight, deferred_mxu=True)
    assert port == jax_flags
    kw = trc.pack_inputs(t_state, t_scene, height=h, width=w, accel=accel, shadows=shadows,
                         watertight=watertight, deferred_mxu=True)
    assert (kw.get("dmxu", False), kw.get("rowskip", False)) == jax_flags
    if jax_flags[0]:
        assert kw["ranges"] is None and kw["spans"] is not None  # unsorted rows
        assert trc.dmxu_route(t_state, t_scene, h, w, accel=accel,
                              deferred_mxu=False) == (False, False)
    expect = {"streamed_binned": (True, False), "streamed_ordered": (True, False),
              "binned_128": (True, False), "binned_64x256": (True, True)}
    assert jax_flags == expect.get(case, (False, False))


# --------------------------------------------------------------- frames ----
@pytest.mark.parametrize("case", [("binned", 41, 16, 16), ("ordered", 47, 16, 16),
                                  ("rowskip", 59, 64, 256)], ids=lambda c: c[0])
def test_frames_match_jax(case, monkeypatch):
    """K11's frames (its plain version) against the jnp reference and the
    JAX Pallas kernel in interpret mode under MRT_DEFERRED_MXU=1."""
    name, seed, h, w = case
    accel = "clusters" if name == "ordered" else "binned"
    (j_state, j_scene), (t_state, t_scene) = _dense(seed, two_instances=name != "ordered")
    kw = trc.pack_inputs(t_state, t_scene, height=h, width=w, accel=accel,
                         deferred_mxu=True)
    assert kw["dmxu"] and kw["rowskip"] == (name == "rowskip")
    port = trc.raytrace(t_state, t_scene, height=h, width=w, accel=accel, deferred_mxu=True)
    assert_frames_close(j_ref(j_state, j_scene, height=h, width=w), port)
    pal, seen = _jax_dmxu(monkeypatch, j_pallas, j_state, j_scene, height=h, width=w,
                          interpret=True, accel=accel)
    assert seen[0][1] == (name == "rowskip")
    assert_frames_close(pal, port)
    assert (port.segmask >= 0).any()


def test_streamed_raster_matches_jax(monkeypatch):
    """The raster conventions at 32² on the binned terrain with
    deferred_mxu: against the jnp raster reference, against the JAX Pallas
    rasterizer under MRT_DEFERRED_MXU=1 in rgb and segmask, and bitwise the
    frames without it. (The JAX Pallas rasterizer, with or without dmxu,
    strays 1.7e-5 relative from its jnp reference in depth at one grazing
    pixel here, where the port is within 1.7e-6 of the jnp reference:
    ROADMAP Queue 3.)"""
    (j_state, j_scene), (t_state, t_scene) = _both(terrain_spec(rotated=True))
    kw = dict(height=32, width=32, accel="binned")
    port = raster_cuda.rasterize(t_state, t_scene, deferred_mxu=True, **kw)
    assert trc.pack_inputs(t_state, t_scene, raster=True, near=0.001, deferred_mxu=True,
                           **kw)["dmxu"]
    assert_frames_close(j_raster_ref(j_state, j_scene, height=32, width=32), port)
    pal, _ = _jax_dmxu(monkeypatch, j_raster_pallas, j_state, j_scene, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(pal.segmask), port.segmask.numpy())
    rgb_diff = np.abs(np.asarray(pal.rgb).astype(np.int16) - port.rgb.numpy().astype(np.int16))
    assert rgb_diff.max() <= 1
    plain = raster_cuda.rasterize(t_state, t_scene, **kw)
    for a, b in zip((port.rgb, port.depth, port.segmask), (plain.rgb, plain.depth,
                                                           plain.segmask)):
        assert torch.equal(a, b)


def test_paged_mips_match_jax(tmp_path, monkeypatch):
    """tests/test_mips.py:647-667: a streamed 3,600-triangle cloud in front
    of the mip-mapped floor, with deferred_mxu (the mip hand-off after K11's
    sweep), at test_torch_bigmesh.py's streamed-mips bar against the jnp
    reference and the JAX Pallas kernel under MRT_DEFERRED_MXU=1."""
    rng = np.random.default_rng(31)
    centers = rng.uniform(-30, 30, size=(3600, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(4, 50, size=3600)
    tris = np.repeat(centers, 3, axis=0)
    tris[1::3] += rng.normal(size=(3600, 3)).astype(np.float32)
    tris[2::3] += rng.normal(size=(3600, 3)).astype(np.float32)
    path = str(tmp_path / "gradient.png")
    write_png(path, gradient_image(256))
    (j_state, j_scene), (t_state, t_scene) = _both(mip_spec(path, extra_mesh=tris))
    assert trc.has_mips(t_scene)
    kw = trc.pack_inputs(t_state, t_scene, height=16, width=16, accel="clusters",
                         deferred_mxu=True)
    assert kw["dmxu"] and kw["fb_rows"] is not None
    port = trc.raytrace(t_state, t_scene, height=16, width=16, accel="clusters",
                        deferred_mxu=True)
    assert_frames_close(j_ref(j_state, j_scene, height=16, width=16), port)
    pal, _ = _jax_dmxu(monkeypatch, j_pallas, j_state, j_scene, height=16, width=16,
                       interpret=True, accel="clusters")
    assert_frames_close(pal, port)


# ---------------------------------------------------------------- walks ----
@pytest.mark.parametrize("case", ["ordered_prep", "binned_prep_256", "ordered_raw_two_cams",
                                  "binned_raw_two_cams_seeded"])
def test_walk_is_the_plain_sweep(case):
    """dmxu_walk (the order or the bin, the gates, every slot, the row gate,
    the first minimum merged) renders render_resident_plain's depth and
    segmask bitwise, seeded too; with the row gate it makes fewer (triangle,
    pixel) tests than without, and rowskip=False changes no frame."""
    two = "two_cams" in case
    t_state, t_scene = terrain_spec(rotated=True, num_cams=2 if two else 1,
                                    grid=30).build_torch()  # S = 3,624: streamed
    h, w = (32, 256) if case.endswith("_256") else (32, 32)
    accel = "binned" if case.startswith("binned") else "clusters"
    kw = trc.pack_inputs(t_state, t_scene, height=h, width=w, accel=accel,
                         deferred_mxu=True)
    assert kw["dmxu"] and kw["geo"] == ("raw" if two else "prep")
    assert kw["rowskip"] == (w == 256)
    if case.endswith("seeded"):
        depth = trc.render_resident_plain(**kw)[0]
        kw = dict(kw, seed=torch.where(depth > 0, depth * 1.0001, 1000.0).contiguous())
    plain = trc.render_resident_plain(**kw)
    with one_thread():
        walk = walk_replay.dmxu_walk(**kw)
        ungated = walk_replay.dmxu_walk(**dict(kw, rowskip=False))
    assert torch.equal(walk["depth"], plain[0]) and torch.equal(walk["segmask"], plain[1])
    assert torch.equal(ungated["depth"], plain[0])
    assert torch.equal(ungated["segmask"], plain[1])
    views, blocks = kw["cams"].shape[0], -(-h // 16) * -(-w // 16)
    assert walk["triangle_visits"] == walk["cluster_visits"] * (kw["rows"].shape[2]
                                                               // kw["clusters"].shape[2])
    assert 0 < walk["pixel_tests"] <= ungated["pixel_tests"] \
        < views * blocks * 256 * kw["rows"].shape[2]
    if kw["rowskip"]:
        assert walk["pixel_tests"] < ungated["pixel_tests"]
    off = trc.pack_inputs(t_state, t_scene, height=h, width=w, accel=accel,
                          deferred_mxu=True, rowskip=False)
    assert off["dmxu"] and not off["rowskip"]
    if two:
        # The raw sweep of each view's D, A, Q, t_num: the winners of the
        # pvec sweep, the depth within rounding.
        pvec = trc.render_resident_plain(**dict(kw, dmxu=False, rowskip=False))
        assert torch.equal(plain[1], pvec[1])
        torch.testing.assert_close(plain[0], pvec[0], rtol=1e-5, atol=1e-5)
    else:
        cold = trc.render_resident_plain(**dict(kw, dmxu=False, rowskip=False))
        assert all(torch.equal(a, b) for a, b in zip(plain, cold))


def test_exact_ties_take_the_lower_index():
    """Every quad pixel ties between instances 0 and 1; instance 1's
    cluster is visited first. K11's first minimum merged with the port's
    tie rule gives instance 0, as the index-order sweep does, and so does
    its replayed walk."""
    (j_state, j_scene), (t_state, t_scene) = _both(_tie_spec())
    port = trc.raytrace(t_state, t_scene, height=32, width=32, deferred_mxu=True)
    assert_frames_close(j_ref(j_state, j_scene, height=32, width=32), port)
    seg = port.segmask
    assert (seg == 0).sum() > 100 and (seg == 1).any()
    kw = trc.pack_inputs(t_state, t_scene, height=32, width=32, deferred_mxu=True)
    assert kw["dmxu"] and kw["order"] is not None
    with one_thread():
        replay = walk_replay.dmxu_walk(**kw)
    assert torch.equal(replay["segmask"].reshape(seg.shape), seg)


def test_manager_steps_with_deferred_mxu(monkeypatch):
    """Manager(deferred_mxu=True) passes the switch to every render; its
    frames are those of the Manager without it, step after step."""
    seen = []
    real = trc.render_resident

    def spy(*a, **k):
        seen.append((k.get("dmxu"), k.get("rowskip")))
        return real(*a, **k)

    monkeypatch.setattr(trc, "render_resident", spy)
    cfg = dict(grid=40, accel="binned", device="cpu")
    dq = torch.tensor([0.995, 0.0, 0.0, 0.0998])
    managers = []
    for on in (True, False):
        seen.clear()
        r = tm.Manager(binned_terrain_config(2, 256, 32, deferred_mxu=on, **cfg))
        rot = r.instance_rotation_tensor().to_torch()
        rot.copy_(quat_normalize(quat_multiply(dq, rot)))
        r.step()
        rowskip = trc.dmxu_route(r.state, r.scene, 32, 256, accel="binned",
                                 deferred_mxu=on)[1]
        assert seen == [(on, rowskip)] * 2 and rowskip == on
        managers.append(r)
    a, b = managers
    for get in ("rgb_tensor", "depth_tensor", "segmask_tensor"):
        assert torch.equal(getattr(a, get)().to_torch(), getattr(b, get)().to_torch())
