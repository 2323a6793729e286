"""PyTorch port: the streamed ordered walk's launch plan (K3 + K5).

The kernel (csrc/render_streamed.cu) takes blocks of tile groups over a
share of one view's tiles, each block holding the view's positions (10 words
a cluster), each group's two stage buffers and the camera row.
``raytrace_cuda.streamed_block_bytes`` is a block's shared memory,
``streamed_plan`` the groups a block and the blocks a view, and
``check_streamed_plan`` its rules, which the wrapper applies on every
device. Held here on the port's packs: every scene ``visit_route`` sends to
the streamed ordered walk fits one block (at most 227 KB) on the 40-grid
terrain, bench.py's 72-grid big mesh and tools/tpu_binned_bench.py's
224-grid terrain under accel="clusters", on prep, raw (with shadows) and
watertight rows, under one and three lights; ``visit_route`` decides by the
ordered walk's byte rule (its routes written out below), and wherever that
rule sends a cluster table to the ordered walk a block fits; a view's blocks take each of
its tiles once; and inputs that break the stage copies' layout raise
``LaunchPlanError`` before anything runs, never taking the plain version.
"""

import functools

import pytest
import torch

from madrona_renderer_tpu_torch import Manager
from madrona_renderer_tpu_torch.core.scene import configure_lighting
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config, binned_terrain_config

THREE_LIGHTS = [((1.0, -1.0, -0.05), (0.5, 0.5, 0.5)), ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2)),
                ((0.5, 1.0, -1.0), (0.2, 0.2, 0.2))]
# name: (the scene's config at 16x16, two worlds (the 224-grid terrain one), the
# accel that orders it)
SCENES = {
    "terrain40": (lambda: bigmesh_config(2, 16, 16, grid=40, device="cpu"), "auto"),
    "bigmesh72": (lambda: bigmesh_config(2, 16, 16, device="cpu"), "auto"),
    "terrain224": (lambda: binned_terrain_config(1, 16, 16, device="cpu"), "clusters"),
}
# geo: pack_inputs' switches for it (one camera a world: prep without them)
GEOS = {"prep": {}, "raw_shadows": dict(shadows=True), "raw_wt": dict(watertight=True)}
# The byte rule's routes on these scenes (the same for one and three lights):
# (accel, view size) → visit, every scene streamed.
RULE_ROUTES = {
    ("auto", 16): "ordered", ("auto", 64): "ordered", ("auto", 128): "binned",
    ("auto", 512): "binned",
    ("clusters", 16): "ordered", ("clusters", 64): "ordered", ("clusters", 128): "ordered",
    ("clusters", 512): "ordered",
    ("binned", 16): "binned", ("binned", 64): "binned", ("binned", 128): "binned",
    ("binned", 512): "binned",
}


@functools.cache
def _manager(name):
    return Manager(SCENES[name][0]())


def _scene(name, lights):
    r = _manager(name)
    return r.state, (r.scene if lights == 1 else configure_lighting(r.scene, lights=THREE_LIGHTS))


@functools.cache
def _packed(name, geo):
    """pack_inputs' tensors for ``geo`` (one light: the lights change the
    camera rows' width only, which the plan takes from ``n_lights``)."""
    state, scene = _scene(name, 1)
    return rc.pack_inputs(state, scene, height=16, width=16, accel=SCENES[name][1], **GEOS[geo])


@pytest.mark.parametrize("lights", [1, 3])
@pytest.mark.parametrize("geo", sorted(GEOS))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_streamed_ordered_walk_fits_one_block(name, geo, lights):
    state, scene = _scene(name, lights)
    accel = SCENES[name][1]
    assert rc.visit_route(state, scene, 16, 16, accel) == rc.Route(True, "ordered")
    kw = _packed(name, geo)
    assert kw["geo"] == geo
    route = rc.route_of(kw["order"], kw["spans"], kw["bins"])
    assert route == rc.Route(True, "ordered")
    assert rc.library_of(route, False) == rc.library_of(route, True) == "render_streamed"
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    views = int(kw["cams"].shape[0])
    plan = rc.check_streamed_plan(kw["rows"], CC, lights, geo, views, 16, 16)
    big = rc.streamed_plan(geo, CC, S // CC, lights, views, 512, 512)
    if geo == "raw_shadows":
        # The shadow sweep walks one 16x16 block a tile (render_body's): the
        # rule's bytes.
        bytes_ = 4 * (2 * 16 * (S // CC) + 11 * CC + rc._n_cam_cols(lights))
        assert plan == big == rc.StreamPlan(0, 1, bytes_)
        assert bytes_ == rc.streamed_rule_bytes(CC, S // CC, lights) <= 227 * 1024
        return
    # A 16x16 view is one tile: one group, one block a view.
    assert (plan.groups, plan.parts) == (1, 1)
    for groups in range(1, rc._STREAM_GROUPS + 1):
        smem = rc.streamed_block_bytes(geo, CC, S // CC, lights, groups)
        assert smem <= 227 * 1024
        assert smem == 384 + 4 * (groups * 2 * rc._VISIT_GEO_ROWS[geo] * (S // CC) + 10 * CC
                                  + rc._n_cam_cols(lights))
    # At the paths' view sizes every group fits.
    assert big.groups == rc._STREAM_GROUPS and big.smem_bytes <= 227 * 1024
    assert big.smem_bytes == rc.streamed_block_bytes(geo, CC, S // CC, lights, big.groups)
    assert S % 4 == 0 and (S // CC) % 4 == 0 and kw["rows"].data_ptr() % 16 == 0


@pytest.mark.parametrize("lights", [1, 3])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_visit_route_keeps_the_byte_rule(name, lights):
    state, scene = _scene(name, lights)
    assert rc.is_streamed(state, scene)
    for (accel, res), visit in RULE_ROUTES.items():
        assert rc.visit_route(state, scene, res, res, accel) == rc.Route(True, visit), \
            (accel, res)


def test_every_table_the_rule_orders_fits_a_block():
    """The rule's bytes (two stage buffers of 16 rows, the cluster table,
    order and spans, the camera row: render_body's streamed block); wherever
    it admits a cluster table, the tile groups' block fits, with fewer groups
    if need be."""
    assert rc.streamed_rule_bytes(648, 32, 1) == 4 * (2 * 16 * 32 + 11 * 648 + 24) == 32704
    for size in (4, 8, 32, 128):
        for lights in (1, 3):
            most = max(cc for cc in range(1, 8000)
                       if rc.streamed_rule_bytes(cc, size, lights) <= 227 * 1024)
            assert rc.streamed_rule_bytes(most + 1, size, lights) > 227 * 1024
            for geo in rc._GEO_CODES:
                for cc in (most, most // 2, 64):
                    plan = rc.streamed_plan(geo, cc, size, lights, 32, 128, 128)
                    shadows = geo in rc._SHADOW_GEOS
                    assert (plan.groups == 0) == shadows
                    assert plan.groups <= rc._STREAM_GROUPS
                    assert plan.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("views", [32, 64, 512])
def test_a_views_blocks_take_each_tile_once(views):
    for res in (16, 64, 128, 512):
        n_tiles = (res // 16) ** 2
        for geo, CC in (("prep", 648), ("raw_shadows", 648), ("prep", 3136)):
            plan = rc.streamed_plan(geo, CC, 32, 1, views, res, res)
            shares = rc.stream_tiles(n_tiles, plan.parts)
            assert sorted(t for share in shares for t in share) == list(range(n_tiles))
            assert all(len(share) >= plan.groups for share in shares)
            # Block b of a view takes its tiles by turns: b, b + parts, ...
            assert all(share == list(range(b, n_tiles, plan.parts))
                       for b, share in enumerate(shares))
            if geo == "raw_shadows":  # one 16x16 block a tile
                assert (plan.groups, plan.parts) == (0, 1)
                continue
            assert plan.groups == min(rc._STREAM_GROUPS, n_tiles)
            # The blocks the card holds at once: 64 registers a thread, the
            # block's shared memory (1 KB reserved a block).
            per_sm = max(1, min(65536 // (256 * plan.groups * 64),
                                228 * 1024 // (plan.smem_bytes + 1024)))
            slots = 132 * per_sm
            if views >= slots:
                assert plan.parts == 1
            else:  # as many as the slots take, each block keeping a tile a group
                assert views * plan.parts <= slots or plan.parts == 1
                assert (views * (plan.parts + 1) > slots
                        or plan.parts == n_tiles // plan.groups)


def _tiny(S, CC, misaligned=False):
    """One world's streamed ordered inputs at S slots in CC clusters, 16x16."""
    n = 40 * S
    flat = torch.zeros(n + 1)[1:] if misaligned else torch.zeros(n)
    return dict(rows=flat.view(1, 40, S), clusters=torch.zeros(1, 8, CC),
                cams=torch.zeros(1, rc._n_cam_cols(1)), num_cams=1, n_lights=1, height=16,
                width=16, seg_div=1, geo="prep",
                order=torch.arange(CC, dtype=torch.int32).view(1, CC),
                spans=torch.zeros(1, 2, CC, dtype=torch.int32))


# case: (S, CC, misaligned, the rule the message names)
REFUSED = {
    "rows_misaligned": (32, 4, True, "16-byte aligned"),
    "slots_not_a_multiple_of_4": (6, 2, False, "multiples of 4"),
    "cluster_size_not_a_multiple_of_4": (24, 4, False, "multiples of 4"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_layout_refusals_raise_before_any_sweep(case, monkeypatch):
    S, CC, misaligned, words = REFUSED[case]
    kw = _tiny(S, CC, misaligned)
    if misaligned:
        assert kw["rows"].data_ptr() % 16 == 4
    called = []
    monkeypatch.setattr(rc, "render_resident_plain", lambda *a, **k: called.append(1))
    with pytest.raises(rc.LaunchPlanError, match=words):
        rc.render_resident(**kw)
    assert not called  # no fallback: nothing ran
    # The same rows on a layout the copies take run the plain version.
    rc.render_resident(**_tiny(32, 4))
    assert called == [1]
