"""PyTorch port: the index visit's tile teams for K1-none and K10.

K10 (raw rows, the watertight decision, raytraced, cold) and K1-none (no
cluster table, every slot swept; on prep rows and on K10's rows) run on the
index visit's tile teams where ``raytrace_cuda.index_plan`` takes them: one
block a view, each triangle's record of three float4 filled once a view
(prep: D with t_num, A, Q; K10: a = v0 - o with the validity, b, c), 4
pixels a thread. K10's blocks hold the cluster table and the gate terms
too, K1-none's neither. Held here: the plan's shared memory for both at
64x64 and 128x128, untextured, nearest and bilinear, and at the resident
budget's 3,072 slots; the route per mode (shadows, raster, seeded, the
9-output mode and few views keep the parent design); forced plans refused
before any sweep; and frames through the Manager on the CPU (the plain
versions the new entries are held to on the card) against the JAX
package's jnp reference: rgb within 1 LSB, depth rtol = atol = 1e-5,
segmask exact (watertight at tests/test_torch_watertight.py's knife-edge
bar).
"""

import functools

import numpy as np
import pytest
import torch

import madrona_renderer_tpu as jm
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.runners.scenes import demo_config as j_demo
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo

from tests.test_torch_watertight import _assert_frames_equal_knife_edge

# The resident budget in slots: 384 KB of the JAX kernel's 32 rows of f32
# (raytrace_cuda._streamed_slots).
BUDGET_SLOTS = 3072
# name: the pack's switches on the demo scene (2 worlds on the CPU)
KINDS = {
    "none": dict(accel="none"),
    "none_wt": dict(accel="none", watertight=True),
    "wt": dict(watertight=True),
}


@functools.cache
def _manager(textured):
    return tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 32, 32, dynamic=True, device="cpu",
                             textured=textured, tex_size=32))


def _inputs(kind, filt=None, res=64, **switches):
    r = _manager(filt is not None)
    return rc.pack_inputs(r.state, r.scene, height=res, width=res,
                          texture_filter=filt or "nearest", **KINDS[kind], **switches)


def _plan(kw, views=4096, **force):
    """check_index_plan on these inputs, for ``views`` views of them."""
    culled = kw["clusters"] is not None
    return rc.index_plan(kw["geo"], int(kw["rows"].shape[2]),
                         int(kw["clusters"].shape[2]) if culled else 0, kw["n_lights"], views,
                         kw["height"], kw["width"], kw["texture"], raster=kw["raster"],
                         culled=culled, **force)


@pytest.mark.parametrize("filt", [None, "nearest", "bilinear"])
@pytest.mark.parametrize("res", [64, 128])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_team_blocks_fit_and_sum(kind, res, filt):
    kw = _inputs(kind, filt, res)
    assert kw["geo"] == ("prep" if kind == "none" else "raw_wt") and kw["texture"] == filt
    assert (kw["clusters"] is None) == kind.startswith("none")
    S = int(kw["rows"].shape[2])
    CC = 0 if kw["clusters"] is None else int(kw["clusters"].shape[2])
    cols = int(kw["cams"].shape[1])
    plan = _plan(kw)
    assert plan.groups == (1 if res == 64 else 2)
    # The head, 12 floats a triangle, the cluster table and gate terms
    # (K10; none for K1-none), the camera row.
    assert plan.smem_bytes == 128 + 4 * (12 * S + 15 * CC + cols) <= 227 * 1024
    assert plan == rc.check_index_plan(kw["rows"], CC, kw["n_lights"], kw["geo"], 4096, res,
                                       res, filt, culled=CC > 0)
    # The resident budget's 3,072 slots (clusters of 8 for K10) fit too.
    assert not rc._streamed_slots(BUDGET_SLOTS) and rc._streamed_slots(BUDGET_SLOTS + 1)
    big_cc = BUDGET_SLOTS // 8 if CC else 0
    big = rc.index_plan(kw["geo"], BUDGET_SLOTS, big_cc, 1, 4096, res, res, filt, culled=CC > 0)
    assert big.groups > 0
    want = 128 + 4 * (12 * BUDGET_SLOTS + 15 * big_cc + rc._n_cam_cols(1))
    assert big.smem_bytes == want <= 227 * 1024


def test_route_per_mode():
    teams = {f"{k} {f}": _inputs(k, f) for k in KINDS for f in (None, "nearest", "bilinear")}
    for what, kw in teams.items():
        culled = kw["clusters"] is not None
        route = rc.route_of(kw["order"], kw["spans"], kw["bins"], culled)
        assert route == (rc.INDEX if culled else rc.NONE), what
        assert _plan(kw).groups > 0, what
        assert _plan(kw, views=2).groups == 0, what  # fewer views than the card's blocks
        assert _plan(dict(kw), seeded=True).groups == 0, what  # K9: the parent
        # Each keeps its variant's name (its launches are counted there) and library.
        assert rc.library_of(route, False, kw["texture"], geo=kw["geo"]) == (
            "render_resident" if culled else "render_none")
    assert rc.index_entry_key("prep", False) == "none"
    assert rc.index_entry_key("raw_wt", False) == "none_raw_wt"
    assert rc.index_entry_key("raw_wt") == "raw_wt"
    assert {"none", "none_raw_wt", "raw_wt"} <= set(rc._INDEX_REGS)
    parents = {
        "K1-none, shadows": _inputs("none", shadows=True),
        "K10, shadows": _inputs("wt", shadows=True),
        "K1-none, K10 shadows": _inputs("none_wt", shadows=True),
        "K1-none, raster": _inputs("none", raster=True, near=0.001),
        "K10, raster": _inputs("wt", raster=True, near=0.001),
        "K1-none, raw rows": dict(_inputs("none", shadows=True), geo="raw"),
        "K1-none, 9-output": dict(_inputs("none"), texture="nine"),
        "K10, 9-output": dict(_inputs("wt"), texture="nine"),
        "K1-none, mip hand-off": dict(_inputs("none"), texture="mip"),
    }
    assert parents["K10, shadows"]["geo"] == "raw_wt_shadows"
    assert parents["K1-none, shadows"]["geo"] == "raw_shadows"
    for what, kw in parents.items():
        assert _plan(kw).groups == 0, what
        assert _plan(kw, groups=2).groups == 0, what  # forced: still the parent


def _no_sweep(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the plain sweep ran")
    for name in ("render_resident_plain", "plain_hits"):
        monkeypatch.setattr(rc, name, fail)


@pytest.mark.parametrize("kind", ["none", "wt"])
def test_forced_plans_refused_before_any_sweep(monkeypatch, kind):
    kw = _inputs(kind)
    W, _, S = kw["rows"].shape
    CC = 0 if kw["clusters"] is None else int(kw["clusters"].shape[2])
    real = rc.index_plan
    _no_sweep(monkeypatch)
    for groups in (3, -1):
        with pytest.raises(rc.LaunchPlanError, match="tile groups"):
            real(kw["geo"], S, CC, 1, 4096, 64, 64, culled=CC > 0, groups=groups)
    # A block past 227 KB, forced: a camera row of 10,000 lights; for K10
    # one-slot clusters of 3,072 slots (the cluster table and gate terms).
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        real(kw["geo"], S, CC, 10000, 4096, 64, 64, culled=CC > 0, groups=1)
    assert real(kw["geo"], S, CC, 10000, 4096, 64, 64, culled=CC > 0).groups == 0
    monkeypatch.setattr(rc, "index_plan", functools.partial(real, groups=2))
    if CC:
        big = dict(kw, rows=torch.zeros(W, 40, 3072), clusters=torch.zeros(W, 8, 3072))
    else:
        lights = 10000
        big = dict(kw, cams=torch.zeros(W, rc._n_cam_cols(lights)), n_lights=lights)
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        rc.render_resident(**big)


# name: the demo config's switches (accel the port's alone)
FRAMES = {
    "none_nearest": dict(accel="none", textured=True, texture_filter="nearest"),
    "none_bilinear": dict(accel="none", textured=True, texture_filter="bilinear"),
    "watertight": dict(watertight=True),
    "watertight_bilinear": dict(watertight=True, textured=True, texture_filter="bilinear"),
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_manager_frames_match_jax(case):
    """The Manager's frames on the CPU against the JAX package's jnp
    reference on the same steps (2 worlds at 32x32)."""
    switches = dict(FRAMES[case])
    accel = switches.pop("accel", "auto")
    t = tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 32, 32, dynamic=True, device="cpu",
                          tex_size=32, accel=accel, **switches))
    j = jm.Manager(j_demo(2, jm.RenderMode.Raytracer, 32, 32, dynamic=True, impl="jnp",
                          tex_size=32, **switches))
    for r in (t, j):
        r.instance_position_tensor().to_torch()[0][1] += 0.5
        r.step()
    assert int((t.frames.depth > 0).sum()) > 0
    if switches.get("watertight"):
        plane = rc.raytrace(t.state, t.scene, height=32, width=32,
                            watertight=True).segmask.numpy() == 1
        _assert_frames_equal_knife_edge(j.frames, t.frames, far=plane)
        return
    rgb_j, rgb_t = np.asarray(j.frames.rgb).astype(np.int16), t.frames.rgb.numpy().astype(np.int16)
    assert np.abs(rgb_j - rgb_t).max() <= 1
    np.testing.assert_allclose(np.asarray(j.frames.depth), t.frames.depth.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(j.frames.segmask), t.frames.segmask.numpy())
