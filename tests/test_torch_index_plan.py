"""PyTorch port: K1's launch plan, the resident index order on tile groups.

K1 and K6 (the resident index order on prep rows, raytraced, untextured or
with the nearest or bilinear filter) take ``raytrace_cuda.index_plan``:
blocks of 1 or 2 groups of 4 tile teams, each team taking a view's 16x16
tiles one at a time, 4 pixels a thread, one block a view, with each
triangle's prep rows as records, the cluster table, the gate terms and the
camera row in shared memory; so do K7 folded and K8
(tests/test_torch_mip_shadow_plan.py), K10 and K1-none
(tests/test_torch_none_wt_plan.py), and K1-raw and K1's 9-output mode
(tests/test_torch_nine_raw_plan.py), and K2 and K2+K6, the raster
conventions on prep rows (tests/test_torch_raster_plan.py). The parent
design (a plan of 0 groups: render_body's 16x16 blocks) takes every other
mode of K1 (K10 with shadows), K9 on K1, views fewer than the blocks the
card holds at once, and blocks the teams' records would push past 227 KB.
``check_index_plan`` is its rule, which the wrapper applies on every
device. Held here on the port's packs: the plan fits one block (at most
227 KB) on the demo scene, untextured and with its 32x32 texture, at 64²
and 128², under one and three lights; a view's pixels are each written
once at every count of groups (``index_cover``, the kernel's index
arithmetic); the plan takes the tile groups for prep rows untextured,
nearest and bilinear (and, since K7 folded and K8 joined them, the
mip-mapped render and raw rows with shadows, K10's rows, raw rows
without shadows, and raster on prep rows), and the parent for K10 with
shadows, seeded inputs and one-slot clusters; and forced plans that
cannot hold raise ``LaunchPlanError`` before any sweep, never taking the
plain version.
"""

import functools

import pytest
import torch

from madrona_renderer_tpu_torch import Manager, RenderMode
from madrona_renderer_tpu_torch.core.scene import configure_lighting
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
from madrona_renderer_tpu_torch.runners.scenes import demo_config

THREE_LIGHTS = [((1.0, -1.0, -0.05), (0.5, 0.5, 0.5)), ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2)),
                ((0.5, 1.0, -1.0), (0.2, 0.2, 0.2))]
# name: the demo scene's config switches (2 worlds on the CPU)
SCENES = {
    "demo": dict(),
    "demo_tex32": dict(textured=True, tex_size=32),
    "demo_tex256_mips": dict(textured=True, tex_size=256),
    "demo_raster": dict(),
}


@functools.cache
def _manager(name):
    mode = RenderMode.Rasterizer if name == "demo_raster" else RenderMode.Raytracer
    return Manager(demo_config(2, mode, 64, 64, dynamic=True, device="cpu", **SCENES[name]))


def _inputs(name, res=64, lights=1, **switches):
    r = _manager(name)
    scene = r.scene if lights == 1 else configure_lighting(r.scene, lights=THREE_LIGHTS)
    return rc.pack_inputs(r.state, scene, height=res, width=res, **switches)


def _plan(kw, seeded=False, views=4096):
    """check_index_plan on these inputs, for ``views`` views of them."""
    texture = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    return rc.check_index_plan(kw["rows"], int(kw["clusters"].shape[2]), kw["n_lights"],
                               kw["geo"], views, kw["height"], kw["width"], texture,
                               raster=kw["raster"], seeded=seeded)


def _one_slot_clusters(kw, S=3072, height=16, width=16):
    """``kw``'s worlds with S slots in S clusters of one slot each, all of
    them empty (no valid cluster), at ``height`` x ``width``: the parent's
    block fits (10 rows and 8 cluster rows a slot), the teams' (12 floats a
    record and 15 cluster rows a slot) does not."""
    W = int(kw["rows"].shape[0])
    return dict(kw, rows=torch.zeros(W, 40, S), clusters=torch.zeros(W, 8, S), height=height,
                width=width)


def index_cover(height, width, groups, pixels=4):
    """How many times the threads of one view's block write each pixel of a
    ``height`` x ``width`` view, by the kernel's index arithmetic
    (``index_tile`` in ``csrc/render_resident.cu``, 4 pixels a thread;
    ``groups`` 0: the parent's 16x16 blocks, one pixel a thread): the teams
    take the tiles the block's counter hands out, 0, 1, ..., in whatever
    order, a tile walked by a team of 256 / pixels threads, thread ``tt``
    the pixels of column ``tt % 16`` in rows ``tt // 16 + (16 // pixels) q``."""
    pix = pixels if groups else 1
    tiles_x = -(-width // 16)
    n_tiles = tiles_x * -(-height // 16)
    cover = torch.zeros((height, width), dtype=torch.int32)
    tt = torch.arange(256 // pix)
    tile = torch.arange(n_tiles)[:, None]
    for q in range(pix):
        px = tile % tiles_x * 16 + tt % 16
        py = tile // tiles_x * 16 + tt // 16 + (16 // pix) * q
        inside = (px < width) & (py < height)
        cover.index_put_((py[inside], px[inside]),
                         torch.ones(int(inside.sum()), dtype=torch.int32), accumulate=True)
    return cover


@pytest.mark.parametrize("lights", [1, 3])
@pytest.mark.parametrize("res", [64, 128])
@pytest.mark.parametrize("filt", [None, "nearest", "bilinear"])
def test_index_plan_fits_one_block(filt, res, lights):
    kw = _inputs("demo" if filt is None else "demo_tex32", res, lights,
                 texture_filter=filt or "nearest")
    assert rc.route_of(kw["order"], kw["spans"], kw["bins"]) == rc.INDEX
    assert kw["geo"] == "prep" and kw["texture"] == filt and kw["n_lights"] == lights
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    plan = _plan(kw)
    assert _plan(kw, views=2).groups == 0  # fewer views than the card's blocks: the parent
    # One group at 64x64 (16 tiles a view), two at 128x128 (64).
    assert plan.groups == (1 if res == 64 else 2)
    assert plan.smem_bytes <= 227 * 1024
    assert plan.smem_bytes == 128 + 4 * (12 * S + 15 * CC + kw["cams"].shape[1])


@pytest.mark.parametrize("groups", rc._INDEX_GROUP_CHOICES)
def test_every_pixel_written_once(groups):
    for h, w in ((64, 64), (128, 128), (40, 24), (17, 33), (16, 80), (48, 48)):
        plan = rc.index_plan("prep", 32, 2, 1, 4, h, w, groups=groups)
        assert plan.groups == groups
        assert bool((index_cover(h, w, plan.groups) == 1).all()), (h, w)
    assert bool((index_cover(40, 24, 0) == 1).all())


def test_route_takes_the_tile_groups_for_k1_and_k6_only():
    """K1 and K6 take the tile groups; since K7 folded and K8 joined them,
    so do the mip-mapped render and raw rows with shadows (their own file,
    tests/test_torch_mip_shadow_plan.py, holds them), since K10 joined
    them the watertight sweep without shadows (tests/test_torch_none_wt_plan.py),
    since K1-raw joined them raw rows without shadows
    (tests/test_torch_nine_raw_plan.py), and since K2 joined them raster on
    prep rows (tests/test_torch_raster_plan.py); the other modes keep the
    parent."""
    for filt in (None, "nearest", "bilinear"):
        plan = _plan(_inputs("demo" if filt is None else "demo_tex32",
                             texture_filter=filt or "nearest"))
        assert plan.groups > 0
    teams = {"raw rows (shadows)": _inputs("demo", shadows=True),
             "mip, folded": _inputs("demo_tex256_mips"),
             "watertight": _inputs("demo_tex32", watertight=True),
             "raw rows (no shadows)": dict(_inputs("demo", shadows=True), geo="raw"),
             "raster": _inputs("demo_raster", raster=True, near=0.001)}
    assert teams["mip, folded"]["fb_rows"] is not None
    assert teams["raw rows (shadows)"]["geo"] == "raw_shadows"
    assert teams["watertight"]["geo"] == "raw_wt"
    for what, kw in teams.items():
        assert _plan(kw).groups > 0, what
    parents = {
        "watertight shadows": _inputs("demo", shadows=True, watertight=True),
    }
    assert parents["watertight shadows"]["geo"] == "raw_wt_shadows"
    for what, kw in parents.items():
        assert rc.route_of(kw["order"], kw["spans"], kw["bins"]) == rc.INDEX, what
        assert _plan(kw).groups == 0, what
    seeded = _plan(_inputs("demo"), seeded=True)
    assert seeded.groups == 0
    # K9 on K1 builds in its own library, whatever the plan.
    assert rc.library_of(rc.INDEX, True) == "render_seeded"
    assert rc.library_of(rc.INDEX, False) == "render_resident"


def _no_sweep(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the plain sweep ran")
    for name in ("render_resident_plain", "plain_hits"):
        monkeypatch.setattr(rc, name, fail)


def test_plan_refusals_raise_before_any_sweep(monkeypatch):
    kw = _inputs("demo_tex32")
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    real = rc.index_plan
    _no_sweep(monkeypatch)
    # Forced to the teams, a block past 227 KB: one-slot clusters, or a
    # camera row of 10,000 lights.
    monkeypatch.setattr(rc, "index_plan", functools.partial(real, groups=2))
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        rc.render_resident(**_one_slot_clusters(kw))
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        real("prep", S, CC, 10000, 4096, 64, 64, groups=1)
    for groups in (3, 4, -1):
        with pytest.raises(rc.LaunchPlanError, match="tile groups"):
            real("prep", S, CC, 1, 4096, 64, 64, groups=groups)
    # Forced or not, the modes the teams do not take are the parent's; the
    # mip-mapped render (K7 folded), K8 and K1-raw take the teams forced too.
    assert real("prep", S, CC, 1, 4096, 64, 64, "mip", groups=2).groups == 2
    assert real("raw_shadows", S, CC, 1, 4096, 64, 64, groups=2).groups == 2
    assert real("raw", S, CC, 1, 4096, 64, 64, groups=2).groups == 2
    assert real("raw_wt_shadows", S, CC, 1, 4096, 64, 64, groups=2).groups == 0
    assert issubclass(rc.LaunchPlanError, ValueError)


def test_default_plan_takes_the_parent_where_the_teams_do_not_fit():
    """Inputs whose teams' block passes 227 KB, where the parent's fits,
    render on the parent design (no refusal): one-slot clusters of 3,072
    slots, on the CPU's plain version."""
    kw = _one_slot_clusters(_inputs("demo"))
    S = CC = 3072
    assert rc.index_block_bytes(S, CC, 1) > 227 * 1024
    plan = rc.index_plan("prep", S, CC, 1, 4096, 64, 64)
    assert plan.groups == 0 and plan.smem_bytes <= 227 * 1024
    assert _plan(kw).groups == 0
    depth, seg, rgb = rc.render_resident(**kw)
    assert depth.shape == seg.shape == rgb.shape == (kw["cams"].shape[0], 16, 16)
    assert bool((depth == 0).all()) and bool((seg == -1).all())  # no valid cluster
