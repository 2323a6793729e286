"""PyTorch port: the index visit's tile teams for K7 (folded) and K8.

K7 on the resident index order (prep rows, raytraced, cold) runs as one
launch where ``raytrace_cuda.index_plan`` takes the teams
(``csrc/render_mip.cu``): the view's teams hold each pixel's winner, then
the block lowers each TPU tile's two window keys and, once they are final,
samples every pixel. K8 (raw rows with shadows) walks the same teams with
each (light, triangle)'s shadow terms hoisted once a view. Held here: the
plan's shared memory for both blocks at 64x64 and 128x128 under one and
three lights; the TPU tile the kernel's arithmetic (``tpu_tile`` in
``csrc/mip_sample.cuh``) gives each pixel, against ``mips.tile_ids``; the
route per mode; forced plans refused before any sweep; and frames through
the Manager on the CPU (the plain versions) against the JAX package's jnp
reference on the paged-mips and shadow scenes: rgb within 1 LSB, depth rtol
= atol = 1e-5, segmask exact.
"""

import functools

import numpy as np
import pytest
import torch

import madrona_renderer_tpu as jm
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.runners.scenes import demo_config as j_demo
from madrona_renderer_tpu_torch.core.scene import configure_lighting
from madrona_renderer_tpu_torch.ops import mips
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo

THREE_LIGHTS = [((1.0, -1.0, -0.05), (0.5, 0.5, 0.5)), ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2)),
                ((0.5, 1.0, -1.0), (0.2, 0.2, 0.2))]
# name: the demo scene's config switches (2 worlds on the CPU)
SCENES = {
    "mips": dict(textured=True, tex_size=256),
    "shadows": dict(shadows=True),
    "shadows_tex32": dict(shadows=True, textured=True, tex_size=32),
    "raster": dict(),
}


@functools.cache
def _manager(name):
    mode = tm.RenderMode.Rasterizer if name == "raster" else tm.RenderMode.Raytracer
    return tm.Manager(t_demo(2, mode, 32, 32, dynamic=True, device="cpu", **SCENES[name]))


def _inputs(name, res=64, lights=1, **switches):
    r = _manager(name)
    scene = r.scene if lights == 1 else configure_lighting(r.scene, lights=THREE_LIGHTS)
    if name.startswith("shadows"):
        switches.setdefault("shadows", True)
    return rc.pack_inputs(r.state, scene, height=res, width=res, **switches)


def _plan(kw, views=4096, seeded=False):
    """check_index_plan on these inputs, for ``views`` views of them."""
    texture = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    return rc.check_index_plan(kw["rows"], int(kw["clusters"].shape[2]), kw["n_lights"],
                               kw["geo"], views, kw["height"], kw["width"], texture,
                               raster=kw["raster"], seeded=seeded)


def tpu_tile_model(height, width):
    """Each pixel's TPU tile by the kernel's arithmetic (``tpu_tile`` in
    ``csrc/mip_sample.cuh``, integer division of non-negative ints), i32
    [H·W]: tile_sub-row x 128-column rectangles when tiles_x > 1, else
    bands of tile_sub · 128 flattened pixels."""
    tile_sub, tiles_x, _ = mips.tile_geometry(height, width)
    p = torch.arange(height * width, dtype=torch.int64)
    x, y = p % width, p // width
    if tiles_x > 1:
        t = torch.div(y, tile_sub, rounding_mode="trunc") * tiles_x + torch.div(
            x, 128, rounding_mode="trunc")
    else:
        t = torch.div(y * width + x, tile_sub * 128, rounding_mode="trunc")
    return t.to(torch.int32)


@pytest.mark.parametrize("lights", [1, 3])
@pytest.mark.parametrize("res", [64, 128])
@pytest.mark.parametrize("mode", ["mips", "shadows"])
def test_team_blocks_fit_and_sum(mode, res, lights):
    kw = _inputs(mode, res, lights, texture_filter="trilinear" if mode == "mips" else "nearest")
    assert kw["geo"] == ("prep" if mode == "mips" else "raw_shadows")
    assert (kw["fb_rows"] is not None) == (mode == "mips")
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    cols = int(kw["cams"].shape[1])
    plan = _plan(kw)
    assert plan.groups == (1 if res == 64 else 2)
    assert _plan(kw, views=2).groups == 0  # fewer views than the card's blocks: the parent
    if mode == "mips":
        # Records of 12 floats, the TPU tiles' two keys, each pixel's winner.
        n_tiles = mips.tile_geometry(res, res)[2]
        assert n_tiles == (1 if res == 64 else 4)
        want = 128 + 4 * (12 * S + 15 * CC + cols) + 4 * (2 * n_tiles + 2 * res * res)
    else:
        # Records of 16 floats a triangle and 4 a light and triangle.
        want = 128 + 4 * ((16 + 4 * lights) * S + 15 * CC + cols)
    assert plan.smem_bytes == want <= 227 * 1024


@pytest.mark.parametrize("hw", [(64, 64), (128, 128), (256, 256), (48, 48), (40, 24),
                                (17, 33), (64, 256), (96, 384), (72, 512)])
def test_kernel_tpu_tile_is_mips_tile_ids(hw):
    h, w = hw
    tile_sub, tiles_x, n_tiles = mips.tile_geometry(h, w)
    ids = mips.tile_ids(h, w, tile_sub, tiles_x)
    model = tpu_tile_model(h, w)
    assert torch.equal(model, ids)
    assert int(model.min()) == 0 and int(model.max()) < n_tiles
    # Every TPU tile lies in one view: the block holds its keys whole.
    assert int(torch.unique(model).numel()) <= n_tiles


def test_route_per_mode():
    teams = {
        "K7 folded, nearest": _inputs("mips", texture_filter="nearest"),
        "K7 folded, trilinear": _inputs("mips", texture_filter="trilinear"),
        "K8": _inputs("shadows"),
        "K8, bilinear": _inputs("shadows_tex32", texture_filter="bilinear"),
        # K1-raw: K8's records and tile without the shadow sweep.
        "K1-raw": dict(_inputs("shadows"), geo="raw"),
        # K2: K1's tile in the raster conventions (tests/test_torch_raster_plan.py).
        "raster": _inputs("raster", raster=True, near=0.001),
    }
    for what, kw in teams.items():
        assert rc.route_of(kw["order"], kw["spans"], kw["bins"]) == rc.INDEX, what
        assert _plan(kw).groups > 0, what
    parents = {
        "K10": _inputs("mips", watertight=True),
        "K10 shadows": _inputs("shadows", watertight=True),
        "K8 on the mip chains": _inputs("mips", shadows=True),
    }
    assert parents["K10"]["geo"] == "raw_wt" and parents["K10 shadows"]["geo"] == "raw_wt_shadows"
    assert parents["K8 on the mip chains"]["geo"] == "raw_shadows"
    for what, kw in parents.items():
        assert _plan(kw).groups == 0, what
    assert _plan(teams["K7 folded, nearest"], seeded=True).groups == 0  # K9 on K1
    assert _plan(teams["K8"], seeded=True).groups == 0
    # K7's launch: folded on the index order, the two launches on the
    # resident and streamed ordered and binned visits and the K9 seed.
    kw = teams["K7 folded, trilinear"]
    assert rc.mip_plan(**kw).groups == 0  # 2 views: fewer than the card's blocks
    kw = dict(kw, rows=kw["rows"].repeat(300, 1, 1), clusters=kw["clusters"].repeat(300, 1, 1),
              cams=kw["cams"].repeat(300, 1))
    assert rc.mip_plan(**kw) == _plan(kw, views=600) and rc.mip_plan(**kw).groups == 1
    stub = torch.zeros(1, dtype=torch.int32)
    for visit in (dict(order=stub), dict(bins=stub), dict(order=stub, spans=stub),
                  dict(bins=stub, spans=stub), dict(seed=torch.zeros(1))):
        assert rc.mip_plan(**dict(kw, **visit)).groups == 0, visit
    assert rc.mip_plan(**dict(kw, raster=True)).groups == 0
    # The folded entry's names, counted beside the render variants.
    assert rc.MIP_VARIANTS == ("render_mip_nearest", "render_mip_bilinear",
                               "render_mip_trilinear")
    assert set(rc.MIP_VARIANTS) <= set(rc.render_resident.variant_launches)
    assert not set(rc.MIP_VARIANTS) & set(rc.RENDER_VARIANTS)


def _no_sweep(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the plain sweep ran")
    for name in ("render_resident_plain", "render_handoff_plain", "plain_hits"):
        monkeypatch.setattr(rc, name, fail)


@pytest.mark.parametrize("mode", ["mips", "shadows"])
def test_forced_plans_refused_before_any_sweep(monkeypatch, mode):
    kw = _inputs(mode, texture_filter="nearest")
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    real = rc.index_plan
    _no_sweep(monkeypatch)
    geo, texture = ("prep", "mip") if mode == "mips" else ("raw_shadows", None)
    for groups in (3, -1):
        with pytest.raises(rc.LaunchPlanError, match="tile groups"):
            real(geo, S, CC, 1, 4096, 64, 64, texture, groups=groups)
    # A block past 227 KB, forced: a 256x256 view holds 512 KB of winners;
    # 10,000 lights a camera row (K8: and a hoisted term a light).
    big = (256, 256) if mode == "mips" else (64, 64)
    lights = 1 if mode == "mips" else 10000
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        real(geo, S, CC, lights, 4096, *big, texture, groups=1)
    assert real(geo, S, CC, lights, 4096, *big, texture).groups == 0  # by default the parent
    monkeypatch.setattr(rc, "index_plan", functools.partial(real, groups=2))
    with pytest.raises(rc.LaunchPlanError, match="at most"):
        rc.render_resident(**dict(kw, height=256, width=256) if mode == "mips" else
                           dict(kw, rows=torch.zeros(W, 40, 3072),
                                clusters=torch.zeros(W, 8, 3072)))


# name: (config switches, filter)
FRAMES = {
    "mips_nearest": (dict(textured=True, tex_size=256), "nearest"),
    "shadows": (dict(shadows=True), "nearest"),
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_manager_frames_match_jax(case):
    """The Manager's frames on the CPU (the plain versions the new entries
    are held to on the card) against the JAX package's jnp reference, on
    the same steps."""
    switches, filt = FRAMES[case]
    kw = dict(dynamic=True, texture_filter=filt, **switches)
    t = tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 32, 32, device="cpu", **kw))
    j = jm.Manager(j_demo(2, jm.RenderMode.Raytracer, 32, 32, impl="jnp", **kw))
    assert rc.has_mips(t.scene) == (switches.get("tex_size") == 256)
    for r in (t, j):
        r.instance_position_tensor().to_torch()[0][1] += 0.5
        r.step()
    rgb_j, rgb_t = np.asarray(j.frames.rgb).astype(np.int16), t.frames.rgb.numpy().astype(np.int16)
    assert np.abs(rgb_j - rgb_t).max() <= 1
    np.testing.assert_allclose(np.asarray(j.frames.depth), t.frames.depth.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(j.frames.segmask), t.frames.segmask.numpy())
    assert int((t.frames.depth > 0).sum()) > 0
