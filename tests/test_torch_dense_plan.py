"""PyTorch port: the launch plans of the dense prepass sweeps' designs for
the card, K11 on the streamed ordered walk's tile groups and K12's records.

K11 (``deferred_mxu=True``) on the streamed ordered visit takes
``raytrace_cuda.streamed_plan(..., dmxu=True)``: tile groups of 256 threads
over a share of one view's tiles, each block holding the view's positions (10
words a cluster), each group's two stage buffers of K11's 10 rows (D, A, Q,
t_num; on raw rows formed in place of the staged v0, e1, e2) and the camera
row; ``check_streamed_plan(..., dmxu=True)`` its rules, which the wrapper
applies on every device. K12 (``accel="mxu"``) takes ``batched_plan``:
pixels a thread of a 32 x 8 block on the prepass records (0: the parent's
16x16 blocks); ``batched_cover`` counts the pixels the kernel's index
arithmetic writes. Held here on the port's packs at 16x16: K11's ordered
plan fits one block on the 40-grid terrain, bench.py's 72-grid big mesh and
tools/tpu_binned_bench.py's 224-grid terrain (under accel="clusters"), on
prep and raw rows, under one and three lights; a view's blocks take each of
its tiles once; rows the stage copies cannot move and more clusters than a
position word holds raise ``LaunchPlanError`` before any sweep, never taking
the plain version; K12's plans cover every pixel once, and the counts and
sizes it cannot take raise.
"""

import functools

import pytest
import torch

from madrona_renderer_tpu_torch import Manager, RenderMode
from madrona_renderer_tpu_torch.core.scene import configure_lighting
from madrona_renderer_tpu_torch.ops import pack_cuda
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
from madrona_renderer_tpu_torch.runners.scenes import (bigmesh_config, binned_terrain_config,
                                                       demo_config)

THREE_LIGHTS = [((1.0, -1.0, -0.05), (0.5, 0.5, 0.5)), ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2)),
                ((0.5, 1.0, -1.0), (0.2, 0.2, 0.2))]
# name: (the scene's config at 16x16 under deferred_mxu, the accel that
# orders it)
SCENES = {
    "terrain40": (lambda: bigmesh_config(2, 16, 16, grid=40, deferred_mxu=True, device="cpu"),
                  "auto"),
    "bigmesh72": (lambda: bigmesh_config(2, 16, 16, deferred_mxu=True, device="cpu"), "auto"),
    "terrain224": (lambda: binned_terrain_config(1, 16, 16, accel="clusters", deferred_mxu=True,
                                                 device="cpu"), "clusters"),
}


@functools.cache
def _manager(name):
    return Manager(SCENES[name][0]())


@functools.cache
def _packed(name, geo, lights):
    """K11's inputs on the ordered walk for ``geo`` (raw: K13's raw rows)."""
    r = _manager(name)
    scene = r.scene if lights == 1 else configure_lighting(r.scene, lights=THREE_LIGHTS)
    kw = rc.pack_inputs(r.state, scene, height=16, width=16, accel=SCENES[name][1],
                        deferred_mxu=True)
    if geo == "raw":
        kw = dict(kw, rows=pack_cuda.pack_rows(r.state, scene), geo="raw")
    return kw


@pytest.mark.parametrize("lights", [1, 3])
@pytest.mark.parametrize("geo", ["prep", "raw"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_k11_ordered_plan_fits_one_block(name, geo, lights):
    kw = _packed(name, geo, lights)
    assert kw["dmxu"] and kw["geo"] == geo and kw["n_lights"] == lights
    route = rc.route_of(kw["order"], kw["spans"], kw["bins"])
    assert route == rc.Route(True, "ordered")
    assert rc.library_of(route, False, dmxu=True) == "render_dmxu"
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    size = S // CC
    views = int(kw["cams"].shape[0])
    plan = rc.check_streamed_plan(kw["rows"], CC, lights, geo, views, 16, 16, dmxu=True)
    # A 16x16 view is one tile: one group, one block a view.
    assert (plan.groups, plan.parts) == (1, 1)
    for groups in range(1, rc._STREAM_GROUPS + 1):
        smem = rc.streamed_block_bytes(geo, CC, size, lights, groups, dmxu=True)
        assert smem == 384 + 4 * (groups * 2 * 10 * size + 10 * CC + rc._n_cam_cols(lights))
        assert smem <= 227 * 1024
    big = rc.streamed_plan(geo, CC, size, lights, views, 512, 512, dmxu=True)
    assert big.groups == rc._STREAM_GROUPS
    assert big.smem_bytes == rc.streamed_block_bytes(geo, CC, size, lights, 4, dmxu=True)
    # K11's stage rows are fewer than K5's on raw rows (16: v0, e1, e2 and
    # the hoisted tv, q, t_num), the same on prep rows.
    k5 = rc.streamed_block_bytes(geo, CC, size, lights, 4)
    assert big.smem_bytes == k5 if geo == "prep" else big.smem_bytes < k5
    # The parent design (0 groups) is render_body's block: the byte rule's
    # bytes on raw rows, fewer stage rows on prep rows.
    parent = rc.streamed_block_bytes(geo, CC, size, lights, 0)
    assert parent <= rc.streamed_rule_bytes(CC, size, lights) <= 227 * 1024
    assert S % 4 == 0 and size % 4 == 0 and kw["rows"].data_ptr() % 16 == 0


@pytest.mark.parametrize("views", [32, 64, 512])
def test_a_views_k11_blocks_take_each_tile_once(views):
    for res in (16, 64, 128, 512):
        n_tiles = (res // 16) ** 2
        for geo, CC in (("prep", 648), ("raw", 648), ("prep", 3136), ("raw", 3136)):
            plan = rc.streamed_plan(geo, CC, 32, 1, views, res, res, dmxu=True)
            assert plan.groups == min(rc._STREAM_GROUPS, n_tiles)
            shares = rc.stream_tiles(n_tiles, plan.parts)
            assert sorted(t for share in shares for t in share) == list(range(n_tiles))
            assert all(len(share) >= plan.groups for share in shares)
            per_sm = max(1, min(65536 // (256 * plan.groups * 64),
                                228 * 1024 // (plan.smem_bytes + 1024)))
            if views >= 132 * per_sm:
                assert plan.parts == 1
            else:
                assert plan.parts == max(1, min(132 * per_sm // views, n_tiles // plan.groups))


def test_k11_takes_the_tile_groups_where_k5_takes_the_blocks():
    """K11 on prep and raw rows takes the tile groups at every view size;
    its parent design (render_body's blocks, 0 groups) is the block the
    shadow sweeps take, the byte rule's on raw rows."""
    for res in (16, 64, 256, 512):
        for geo in ("prep", "raw"):
            plan = rc.streamed_plan(geo, 648, 32, 1, 512, res, res, dmxu=True)
            assert 1 <= plan.groups <= rc._STREAM_GROUPS
        assert rc.streamed_plan("raw_shadows", 648, 32, 1, 512, res, res).groups == 0
    assert rc.streamed_block_bytes("raw", 648, 32, 1, 0) == rc.streamed_rule_bytes(648, 32, 1)
    assert (rc.streamed_block_bytes("raw_shadows", 648, 32, 1, 0)
            == rc.streamed_plan("raw_shadows", 648, 32, 1, 512, 64, 64).smem_bytes)


def _no_sweep(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("the plain sweep ran")
    for name in ("render_resident_plain", "plain_hits", "render_batched_plain"):
        monkeypatch.setattr(rc, name, fail)


def test_misaligned_rows_raise_before_any_sweep(monkeypatch):
    kw = _packed("terrain40", "prep", 1)
    rows = kw["rows"]
    flat = torch.zeros(rows.numel() + 1, dtype=rows.dtype)
    shifted = flat[1:].view(rows.shape)  # 4 bytes past a 16-byte boundary
    shifted.copy_(rows)
    assert shifted.data_ptr() % 16 == 4
    _no_sweep(monkeypatch)
    with pytest.raises(rc.LaunchPlanError, match="16-byte"):
        rc.render_resident(**dict(kw, rows=shifted))
    raw = _packed("terrain40", "raw", 1)
    flat = torch.zeros(raw["rows"].numel() + 1, dtype=rows.dtype)
    shifted = flat[1:].view(raw["rows"].shape)
    shifted.copy_(raw["rows"])
    with pytest.raises(rc.LaunchPlanError, match="16-byte"):
        rc.render_resident(**dict(raw, rows=shifted))


def test_slots_not_a_multiple_of_four_raise_before_any_sweep(monkeypatch):
    kw = _packed("terrain40", "prep", 1)
    W, R, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    # Clusters of size - 2 slots: S and the cluster size no longer multiples
    # of 4 (the padding slots cut, the clusters' counts left as they are).
    size = S // CC
    cut = kw["rows"].reshape(W, R, CC, size)[..., :size - 2].reshape(W, R, CC * (size - 2))
    _no_sweep(monkeypatch)
    with pytest.raises(rc.LaunchPlanError, match="multiples of 4"):
        rc.render_resident(**dict(kw, rows=cut.contiguous()))
    with pytest.raises(rc.LaunchPlanError, match="multiples of 4"):
        rc.check_streamed_plan(cut.contiguous(), CC, 1, "raw", 2, 16, 16, dmxu=True)


def test_too_many_clusters_raise():
    CC = rc._STREAM_MAX_CLUSTERS + 1
    rows = torch.zeros((1, 40, 4 * CC), dtype=torch.float32)
    for geo in ("prep", "raw"):
        with pytest.raises(rc.LaunchPlanError, match="at most"):
            rc.check_streamed_plan(rows, CC, 1, geo, 1, 16, 16, dmxu=True)


@pytest.mark.parametrize("pixels", [0, 4])
def test_k12_plan_covers_every_pixel_once(pixels):
    for height, width in ((64, 64), (128, 128), (24, 40), (16, 16), (33, 17)):
        plan = rc.batched_plan(height, width, pixels)
        assert plan.pixels == pixels
        if pixels == 0:
            assert plan.block == (16, 16)
            assert plan.blocks == -(-height // 16) * -(-width // 16)
        else:
            assert plan.block == (32, 8)
            assert plan.blocks == -(-width // 32) * -(-height // (8 * pixels))
        cover = rc.batched_cover(height, width, plan)
        assert cover.shape == (height, width) and bool((cover == 1).all())


def test_k12_plan_refusals_raise_before_any_sweep(monkeypatch):
    assert rc._BATCHED_PIXEL_CHOICES == (0, rc._BATCHED_PIXELS) == (0, 4)
    for pixels in (1, 2, 3, 5, 8, -1):
        with pytest.raises(rc.LaunchPlanError, match="pixels a thread"):
            rc.batched_plan(64, 64, pixels)
    with pytest.raises(rc.LaunchPlanError, match="65535"):
        rc.batched_plan(4096, 8192, 0)
    assert rc.batched_plan(4096, 8192, 4).blocks <= 65535
    r = Manager(demo_config(1, RenderMode.Raytracer, 16, 16, device="cpu"))
    kw = rc.pack_inputs(r.state, r.scene, height=16, width=16, accel="mxu")
    assert rc.batched_plan(16, 16) == rc.BatchedPlan(rc._BATCHED_PIXELS, (32, 8), 1)
    _no_sweep(monkeypatch)
    with pytest.raises(rc.LaunchPlanError, match="65535"):
        rc.render_batched(**dict(kw, height=16384, width=16384))

    def refuse(height, width):
        raise rc.LaunchPlanError("refused")

    monkeypatch.setattr(rc, "batched_plan", refuse)
    with pytest.raises(rc.LaunchPlanError, match="refused"):
        rc.render_batched(**kw)
