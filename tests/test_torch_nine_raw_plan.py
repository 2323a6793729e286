"""PyTorch port: the index visit's tile teams for K1's 9-output mode and K1-raw.

K1's 9-output mode on prep rows (textured pools past the in-kernel route,
baked without mips) and K1-raw (raw rows without shadows: more than one
camera a world) run on the index visit's tile teams where
``raytrace_cuda.index_plan`` takes them: one block a view, the records
filled once a view (the 9-output mode: K1's three float4 of D with t_num,
A, Q; K1-raw: K8's four float4 of e1 with t_num, e2, tv and q with v0, each
view's own tv, q and t_num), the cluster table and the gate terms. Held
here: the plan's shared memory for both at 64x64 and 128x128 (K1-raw
untextured, nearest and bilinear) and at the resident budget's 3,072 slots;
the route per mode (the 9-output mode on raw and K10 rows and K1-none's,
K9's seed, raster and few views keep the parent design); forced plans
refused before any sweep; and frames through the Manager on the CPU (the
plain versions the new entries are held to on the card) against the JAX
package's jnp reference: rgb within 1 LSB, depth rtol = atol = 1e-5,
segmask exact.
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

# The resident budget in slots: 384 KB of the JAX kernel's 32 rows of f32
# (raytrace_cuda._streamed_slots).
BUDGET_SLOTS = 3072
# name: the demo config's switches (2 worlds on the CPU)
SCENES = {
    "multicam": dict(num_cams=4),
    "multicam_tex32": dict(num_cams=4, textured=True, tex_size=32),
    # A 144x144 checker (20,736 texels, past the in-kernel route's 16,384)
    # baked without mips: the 9-output route.
    "nine": dict(textured=True, tex_size=144, mipmaps=False),
}
# kind: (scene, texture filter)
KINDS = {
    "raw": ("multicam", None),
    "raw_nearest": ("multicam_tex32", "nearest"),
    "raw_bilinear": ("multicam_tex32", "bilinear"),
    "nine": ("nine", None),
}


@functools.cache
def _manager(scene):
    return tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 32, 32, dynamic=True, device="cpu",
                             **SCENES[scene]))


def _inputs(kind, res=64, **switches):
    scene, filt = KINDS[kind]
    r = _manager(scene)
    return rc.pack_inputs(r.state, r.scene, height=res, width=res,
                          texture_filter=filt or "nearest", **switches)


def _plan(kw, views=4096, **force):
    """index_plan on these inputs, for ``views`` views of them."""
    culled = kw["clusters"] is not None
    return rc.index_plan(kw["geo"], int(kw["rows"].shape[2]),
                         int(kw["clusters"].shape[2]) if culled else 0, kw["n_lights"], views,
                         kw["height"], kw["width"], kw["texture"], raster=kw["raster"],
                         seeded=kw.get("seed") is not None, culled=culled, **force)


@pytest.mark.parametrize("res", [64, 128])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_team_blocks_fit_and_sum(kind, res):
    kw = _inputs(kind, res)
    nine = kind == "nine"
    assert (kw["geo"], kw["texture"]) == (("prep", "nine") if nine else ("raw", KINDS[kind][1]))
    assert kw["num_cams"] == (1 if nine else 4)
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    cols = int(kw["cams"].shape[1])
    rec = 12 if nine else 16  # K1's records of three float4; K8's four, no shadow terms
    plan = _plan(kw)
    assert plan.groups == (1 if res == 64 else 2)
    assert _plan(kw, views=2).groups == 0  # fewer views than the card's blocks: the parent
    # The head, the records, the cluster table and gate terms, the camera row.
    assert plan.smem_bytes == 128 + 4 * (rec * S + 15 * CC + cols) <= 227 * 1024
    assert plan == rc.check_index_plan(kw["rows"], CC, kw["n_lights"], kw["geo"], 4096, res, res,
                                       kw["texture"])
    # The resident budget's 3,072 slots in clusters of 8 fit too.
    assert not rc._streamed_slots(BUDGET_SLOTS) and rc._streamed_slots(BUDGET_SLOTS + 1)
    big_cc = BUDGET_SLOTS // 8
    big = rc.index_plan(kw["geo"], BUDGET_SLOTS, big_cc, 1, 4096, res, res, kw["texture"])
    assert big.groups == plan.groups
    want = 128 + 4 * (rec * BUDGET_SLOTS + 15 * big_cc + rc._n_cam_cols(1))
    assert big.smem_bytes == want == rc.index_block_bytes(BUDGET_SLOTS, big_cc, 1, kw["geo"])
    assert want <= 227 * 1024


def test_route_per_mode():
    for kind in KINDS:
        kw = _inputs(kind)
        route = rc.route_of(kw["order"], kw["spans"], kw["bins"])
        assert route == rc.INDEX, kind
        assert rc.index_takes(kw["geo"], kw["texture"]), kind
        assert _plan(kw).groups > 0, kind
        key = rc.index_entry_key(kw["geo"], True, kw["texture"])
        assert key == ("nine" if kind == "nine" else "raw") and key in rc._INDEX_REGS, kind
        # Each keeps its variant's name (its launches are counted there) and library.
        assert rc.library_of(route, False, kw["texture"], geo=kw["geo"]) == (
            "render_none" if kind == "nine" else "render_resident")
    raw, nine = _inputs("raw"), _inputs("nine")
    stub_seed = torch.zeros(1)
    parents = {
        "9-output, raw rows": _inputs("nine", shadows=True) | {"geo": "raw"},
        "9-output, K10 rows": _inputs("nine", watertight=True),
        "9-output, K1-none": _inputs("nine", accel="none"),
        "9-output, seeded": nine | {"seed": stub_seed},
        "9-output, raster": _inputs("nine", raster=True, near=0.001),
        "K1-raw, seeded": raw | {"seed": stub_seed},
        "K1-raw, raster": _inputs("raw", raster=True, near=0.001),
        "K1-raw, mip hand-off": raw | {"texture": "mip"},
    }
    assert parents["9-output, K10 rows"]["geo"] == "raw_wt"
    assert parents["9-output, K1-none"]["clusters"] is None
    for what, kw in parents.items():
        assert kw["texture"] in ("nine", None, "mip"), what
        assert _plan(kw).groups == 0, what
        assert _plan(kw, groups=2).groups == 0, what  # forced: still the parent


def _no_sweep(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the plain sweep ran")
    for name in ("render_resident_plain", "plain_hits"):
        monkeypatch.setattr(rc, name, fail)


@pytest.mark.parametrize("kind", ["raw", "nine"])
def test_forced_plans_refused_before_any_sweep(monkeypatch, kind):
    kw = _inputs(kind)
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    real = rc.index_plan
    _no_sweep(monkeypatch)
    for groups in (3, -1):
        with pytest.raises(rc.LaunchPlanError, match="tile groups"):
            real(kw["geo"], S, CC, 1, 4096, 64, 64, kw["texture"], groups=groups)
    # A block past 227 KB, forced: a camera row of 10,000 lights, or
    # one-slot clusters of 3,072 slots (the cluster table and gate terms).
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        real(kw["geo"], S, CC, 10000, 4096, 64, 64, kw["texture"], groups=1)
    assert real(kw["geo"], S, CC, 10000, 4096, 64, 64, kw["texture"]).groups == 0
    assert rc.index_block_bytes(BUDGET_SLOTS, BUDGET_SLOTS, 1, kw["geo"]) > 227 * 1024
    monkeypatch.setattr(rc, "index_plan", functools.partial(real, groups=2))
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        rc.render_resident(**dict(kw, rows=torch.zeros(W, 40, BUDGET_SLOTS),
                                  clusters=torch.zeros(W, 8, BUDGET_SLOTS)))


# name: the demo config's switches
FRAMES = {
    "multicam": SCENES["multicam"],
    "nine": SCENES["nine"],
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_manager_frames_match_jax(case):
    """The Manager's frames on the CPU (K1-raw's plain version on four
    cameras a world; the 9-output route's plain version and the planar
    epilogue) against the JAX package's jnp reference on the same steps (2
    worlds at 32x32)."""
    switches = FRAMES[case]
    t = tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 32, 32, dynamic=True, device="cpu",
                          **switches))
    j = jm.Manager(j_demo(2, jm.RenderMode.Raytracer, 32, 32, dynamic=True, impl="jnp",
                          **switches))
    kw = rc.pack_inputs(t.state, t.scene, height=32, width=32)
    assert (kw["geo"], kw["texture"]) == (("prep", "nine") if case == "nine" else ("raw", None))
    for r in (t, j):
        r.instance_position_tensor().to_torch()[0][1] += 0.5
        r.step()
    assert int((t.frames.depth > 0).sum()) > 0
    rgb_j, rgb_t = np.asarray(j.frames.rgb).astype(np.int16), t.frames.rgb.numpy().astype(np.int16)
    assert np.abs(rgb_j - rgb_t).max() <= 1
    np.testing.assert_allclose(np.asarray(j.frames.depth), t.frames.depth.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(j.frames.segmask), t.frames.segmask.numpy())
