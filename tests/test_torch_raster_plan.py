"""PyTorch port: K2 and K2+K6 (the raster conventions) on the index visit's tile teams.

K1's resident index order in the raster conventions on prep rows
(untextured: K2; nearest or bilinear: K2+K6) runs on the index visit's
tile teams where ``raytrace_cuda.index_plan`` takes it: K1's records,
cluster table and gate terms filled once a block, each pixel's t-space near
bound in the sweep's test, a block a view, of two groups where the views
are few. Held here: the plan's shared memory at 64x64 and 128x128 and at
the resident budget's 3,072 slots; that every pixel is written once at
every count of groups (``raster_cover``, the kernel's index arithmetic); the route per mode (raster on raw, shadow and K10 rows, with
mips, seeded, without a cluster table and in the 9-output mode keep the
parent design); forced plans refused before any sweep; the default plan on
raster_256w_png's shape (plan arithmetic only); and frames through
``Manager(RenderMode.Rasterizer)`` on the CPU (the plain version the
kernel is held to on the card) against the JAX package's rasterizer: rgb
within 1 LSB, depth rtol = atol = 1e-5, segmask -1 everywhere.
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
RASTER_NEAR = 0.001  # ManagerConfig.raster_near_plane
RASTER_PIXELS = 2  # csrc/render_resident.cu's kRasterPixels
# name: the demo config's switches (2 worlds on the CPU, rasterized)
SCENES = {
    "demo": dict(),
    "tex32": dict(textured=True, tex_size=32),
    "tex256_mips": dict(textured=True, tex_size=256),
    "two_cams": dict(num_cams=2),
}


@functools.cache
def _manager(scene):
    return tm.Manager(t_demo(2, tm.RenderMode.Rasterizer, 32, 32, dynamic=True, device="cpu",
                             **SCENES[scene]))


def _inputs(scene, res=64, filt="nearest", **switches):
    r = _manager(scene)
    return rc.pack_inputs(r.state, r.scene, height=res, width=res, raster=True,
                          near=RASTER_NEAR, texture_filter=filt, **switches)


def _plan(kw, views=4096, **force):
    """index_plan on these inputs, for ``views`` views of them."""
    culled = kw["clusters"] is not None
    texture = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    return rc.index_plan(kw["geo"], int(kw["rows"].shape[2]),
                         int(kw["clusters"].shape[2]) if culled else 0, kw["n_lights"], views,
                         kw["height"], kw["width"], texture, raster=kw["raster"],
                         seeded=kw.get("seed") is not None, culled=culled, **force)


def raster_cover(height, width, groups, pixels=RASTER_PIXELS):
    """How many times one view's block writes each pixel of a ``height`` x
    ``width`` view, by the kernel's index arithmetic (visit_body and
    index_tile in ``csrc/render_resident.cu``): the block's counter hands
    the tiles 0, 1, ... out once each, in whatever order and to whichever
    of its ``groups`` x ``pixels`` teams; a team of 256 / pixels threads
    walks a tile, thread ``tt`` the pixels of column
    ``tt % 16`` in rows ``tt // 16 + (16 // pixels) q``."""
    tiles_x = -(-width // 16)
    n_tiles = tiles_x * -(-height // 16)
    cover = torch.zeros((height, width), dtype=torch.int32)
    tt = torch.arange(256 // pixels)
    teams = groups * pixels
    for team in range(teams):  # a deal of the tiles over the teams
        tile = torch.tensor(list(range(team, n_tiles, teams)), dtype=torch.long)[:, None]
        for q in range(pixels):
            px = tile % tiles_x * 16 + tt % 16
            py = tile // tiles_x * 16 + tt // 16 + (16 // pixels) * q
            inside = (px < width) & (py < height)
            cover.index_put_((py[inside], px[inside]),
                             torch.ones(int(inside.sum()), dtype=torch.int32), accumulate=True)
    return cover


@pytest.mark.parametrize("res", [64, 128])
@pytest.mark.parametrize("filt", [None, "nearest", "bilinear"])
def test_raster_plan_fits_one_block(filt, res):
    kw = _inputs("demo" if filt is None else "tex32", res, filt or "nearest")
    assert rc.route_of(kw["order"], kw["spans"], kw["bins"]) == rc.INDEX
    assert (kw["geo"], kw["texture"], kw["raster"]) == ("prep", filt, True)
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    cols = int(kw["cams"].shape[1])
    plan = _plan(kw)
    # K1's records of three float4, the cluster table and gate terms, the
    # camera row: one group at 64x64 (16 tiles a view), two at 128x128.
    assert plan.groups == (1 if res == 64 else 2)
    assert plan.smem_bytes == 128 + 4 * (12 * S + 15 * CC + cols) <= 227 * 1024
    assert plan == rc.check_index_plan(kw["rows"], CC, kw["n_lights"], "prep", 4096, res, res,
                                       filt, raster=True)
    assert rc.index_entry_key("prep", True, filt, raster=True) == "raster"
    # The resident budget's 3,072 slots in clusters of 8 fit too.
    big_cc = BUDGET_SLOTS // 8
    big = rc.index_plan("prep", BUDGET_SLOTS, big_cc, 1, 4096, res, res, filt, raster=True)
    want = 128 + 4 * (12 * BUDGET_SLOTS + 15 * big_cc + rc._n_cam_cols(1))
    assert big == (plan.groups, want) and want <= 227 * 1024


@pytest.mark.parametrize("groups", rc._INDEX_GROUP_CHOICES)
def test_every_pixel_written_once_at_every_plan(groups):
    for h, w in ((64, 64), (128, 128), (40, 24), (17, 33), (16, 80), (48, 48)):
        plan = rc.index_plan("prep", 32, 2, 1, 4, h, w, raster=True, groups=groups)
        assert plan.groups == groups
        for pixels in (RASTER_PIXELS, 4):  # the build's, and index_plan_ab's raster_px4
            assert bool((raster_cover(h, w, groups, pixels) == 1).all()), (h, w, pixels)


def test_route_per_mode():
    """Raster on prep rows (K2, K2+K6) takes the teams; every other raster
    mode keeps the parent design, forced or not."""
    for scene, filt in (("demo", None), ("tex32", "nearest"), ("tex32", "bilinear")):
        kw = _inputs(scene, filt=filt or "nearest")
        assert rc.index_takes("prep", filt, raster=True)
        assert _plan(kw).groups > 0, filt
        assert rc.library_of(rc.INDEX, False, filt, geo="prep") == "render_resident"
        assert rc.variant_name(True, filt) == "render_resident_raster" + (
            f"_tex_{filt}" if filt else "")
    stub_seed = torch.zeros(1)
    demo = _inputs("demo")
    parents = {
        "raw rows (two cameras)": _inputs("two_cams"),
        "raw rows with shadows": _inputs("demo", shadows=True),
        "K10 rows": _inputs("tex32", watertight=True),
        "mips": _inputs("tex256_mips"),
        "seeded": demo | {"seed": stub_seed},
        "no cluster table": _inputs("demo", accel="none"),
        "9-output": demo | {"texture": "nine"},
    }
    assert parents["raw rows (two cameras)"]["geo"] == "raw"
    assert parents["raw rows with shadows"]["geo"] == "raw_shadows"
    assert parents["K10 rows"]["geo"] == "raw_wt"
    assert parents["mips"]["fb_rows"] is not None
    assert parents["no cluster table"]["clusters"] is None
    for what, kw in parents.items():
        assert kw["raster"], what
        assert _plan(kw).groups == 0, what
        assert _plan(kw, groups=2).groups == 0, what  # forced: still the parent


def _no_sweep(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the plain sweep ran")
    for name in ("render_resident_plain", "plain_hits"):
        monkeypatch.setattr(rc, name, fail)


def test_forced_plans_refused_before_any_sweep(monkeypatch):
    kw = _inputs("tex32")
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    real = rc.index_plan
    _no_sweep(monkeypatch)
    for groups in (3, -1, 4):
        with pytest.raises(rc.LaunchPlanError, match="tile groups"):
            real("prep", S, CC, 1, 4096, 64, 64, "nearest", raster=True, groups=groups)
    # A forced plan on few views: the teams, as forced (the default there is
    # the parent design).
    assert real("prep", S, CC, 1, 2, 64, 64, "nearest", raster=True, groups=2).groups == 2
    # A block past 227 KB, forced: a camera row of 10,000 lights; by default
    # the parent design.
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        real("prep", S, CC, 10000, 4096, 64, 64, raster=True, groups=1)
    assert real("prep", S, CC, 10000, 4096, 64, 64, raster=True).groups == 0
    # Through the wrapper: refused before any sweep, on the CPU too.
    monkeypatch.setattr(rc, "index_plan", functools.partial(real, groups=3))
    with pytest.raises(rc.LaunchPlanError, match="tile groups"):
        rc.render_resident(**kw)
    monkeypatch.setattr(rc, "index_plan", functools.partial(real, groups=2))
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        rc.render_resident(**dict(kw, rows=torch.zeros(W, 40, BUDGET_SLOTS),
                                  clusters=torch.zeros(W, 8, BUDGET_SLOTS)))


def test_default_plan_on_raster_256w_png_shape():
    """raster_256w_png: 256 views of the textured demo cube at 64x64, fewer
    than the card's 528 blocks of one group (an H100's 132
    multiprocessors, 4 such blocks of 64 registers a thread each). The
    plan takes a block a view of two groups (4 teams of 128 threads each, 2
    pixels a thread: one fill for 4 teams), the plan that ran fastest on
    every pass on an H100; from 528 views (4096: main's) a block of one
    group; below _RASTER_MIN_VIEWS views (128: 64 worlds and fewer, the
    CPU's 2) the parent design, which ran faster there."""
    kw = _inputs("tex32")
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    slots = {g: rc._H100_SMS * (rc._SM_REGS // (256 * g * rc._INDEX_REGS["raster"]))
             for g in (1, 2)}
    assert slots == {1: 528, 2: 264}
    assert rc._RASTER_MIN_VIEWS == 128
    plan = _plan(kw, views=256)
    assert plan == (2, rc.index_block_bytes(S, CC, 1))
    assert _plan(kw, views=128) == plan
    assert _plan(kw, views=slots[1] - 1) == plan
    for views in (2, 32, 64, rc._RASTER_MIN_VIEWS - 1):
        assert _plan(kw, views=views).groups == 0, views
    for views in (slots[1], 4096):  # the views fill the card
        assert _plan(kw, views=views) == (1, plan.smem_bytes), views


@pytest.mark.parametrize("filt", ["nearest", "bilinear"])
def test_manager_frames_match_jax(filt):
    """The Manager's frames on the CPU (the raster entry's plain version)
    against the JAX package's rasterizer (its jnp reference) on the same
    steps: the textured cube, 2 worlds at 32x32."""
    switches = dict(textured=True, tex_size=32, texture_filter=filt)
    t = tm.Manager(t_demo(2, tm.RenderMode.Rasterizer, 32, 32, dynamic=True, device="cpu",
                          **switches))
    j = jm.Manager(j_demo(2, jm.RenderMode.Rasterizer, 32, 32, dynamic=True, impl="jnp",
                          **switches))
    kw = rc.pack_inputs(t.state, t.scene, height=32, width=32, raster=True, near=RASTER_NEAR,
                        texture_filter=filt)
    assert (kw["geo"], kw["texture"], kw["raster"]) == ("prep", filt, True)
    assert rc.index_takes(kw["geo"], kw["texture"], kw["raster"])
    for r in (t, j):
        r.instance_position_tensor().to_torch()[0][1] += 0.5
        r.step()
    assert int((t.frames.depth > 0).sum()) > 0
    rgb_j, rgb_t = np.asarray(j.frames.rgb).astype(np.int16), t.frames.rgb.numpy().astype(np.int16)
    assert np.abs(rgb_j - rgb_t).max() <= 1
    np.testing.assert_allclose(np.asarray(j.frames.depth), t.frames.depth.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (t.frames.segmask.numpy() == -1).all()
    np.testing.assert_array_equal(np.asarray(j.frames.segmask), t.frames.segmask.numpy())
