"""PyTorch port: the streamed binned walk's launch plan (K4, and K11 on the
binned visit).

The kernel (csrc/render_binned.cu, bin_body in csrc/render_resident.cu)
takes, on prep rows, blocks of tile groups over a share of one view's bin
tiles, each block holding its groups' stage buffers, each group's records of
256 positions of its tile's bin (10 words each) and the camera row; raw and
K10 rows and the shadow sweeps keep render_body's 16x16 blocks
(csrc/render_binned_blocks.cu, render_seeded.cu, render_dmxu.cu).
``raytrace_cuda.binned_block_bytes`` is a block's shared memory,
``binned_plan`` the groups a block and the blocks a view, ``binned_tiles``
the tiles each block takes, and ``check_binned_plan`` its rules, which the
wrapper applies on every device. Held here on the port's packs: every scene
``visit_route`` sends to the streamed binned visit (the 40-grid terrain and
tools/tpu_binned_bench.py's 224-grid terrain at 128x128 and 512x512) fits a
block on prep, raw and K10 rows, under K4 and K11, each in its library; a
view's blocks take each
tile once, a bin tile's tiles in one block; misaligned rows raise
``LaunchPlanError`` before anything runs, never taking the plain version;
and ``binned_occupancy`` needs the card.
"""

import functools

import pytest
import torch

from madrona_renderer_tpu_torch.assets.importer import load_render_assets
from madrona_renderer_tpu_torch.core.scene import bake_scene
from madrona_renderer_tpu_torch.core.state import init_state
from madrona_renderer_tpu_torch.ops import pack_cuda
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config, binned_terrain_config

# name: (the scene's config, the view size it is packed at)
SCENES = {
    "terrain40_64": (lambda: bigmesh_config(1, 64, 64, grid=40, device="cpu"), 64),
    "terrain224_128": (lambda: binned_terrain_config(1, 128, 128, device="cpu"), 128),
    # 12 views: past 2^25 dense bin entries at 16 px, so a 32-px bin tile.
    "terrain224_512": (lambda: binned_terrain_config(12, 512, 512, device="cpu"), 512),
}
# geo: pack_inputs' switches for it (one camera a world: prep without them)
GEOS = {"prep": {}, "raw_wt": dict(watertight=True), "raw_shadows": dict(shadows=True)}


class _Scene:
    """A config's state and scene, baked as the Manager bakes them, with no
    frame rendered (the 12-world 512x512 frame would take minutes here)."""

    def __init__(self, cfg):
        rcfg = cfg.rcfg
        self.scene = bake_scene(load_render_assets(rcfg.geo_cfg, rcfg.asset_paths,
                                                   rcfg.additional_mats,
                                                   list(rcfg.additional_textures)), "cpu")
        self.state = init_state(rcfg.instances, rcfg.cameras, rcfg.worlds, "cpu")


@functools.cache
def _manager(name):
    return _Scene(SCENES[name][0]())


@functools.cache
def _packed(name, geo, dmxu=False):
    r = _manager(name)
    res = SCENES[name][1]
    return rc.pack_inputs(r.state, r.scene, height=res, width=res, accel="binned",
                          deferred_mxu=dmxu, **GEOS[geo])


def _variants(name):
    """(geo, dmxu, kw) of every sweep the binned visit takes on the scene:
    K4 on prep, raw (K13's raw rows), K10 and the shadow sweep's rows, K11
    on prep and raw rows."""
    r = _manager(name)
    raw_rows = pack_cuda.pack_rows(r.state, r.scene)
    for geo in GEOS:
        kw = _packed(name, geo)
        yield geo, False, kw
        if geo == "prep":
            yield "raw", False, dict(kw, rows=raw_rows, geo="raw", ranges=None)
    kw_m = _packed(name, "prep", True)
    yield "prep", True, kw_m
    yield "raw", True, dict(kw_m, rows=raw_rows, geo="raw")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_binned_plan_fits_every_binned_scene(name):
    r = _manager(name)
    res = SCENES[name][1]
    assert rc.visit_route(r.state, r.scene, res, res, "binned") == rc.Route(True, "binned")
    for geo, dmxu, kw in _variants(name):
        assert kw["geo"] == geo and bool(kw["dmxu"]) == dmxu
        route = rc.route_of(kw["order"], kw["spans"], kw["bins"])
        assert route == rc.Route(True, "binned")
        W, _, S = kw["rows"].shape
        CC = int(kw["clusters"].shape[2])
        views = int(kw["cams"].shape[0])
        plan = rc.check_binned_plan(kw["rows"], CC, kw["n_lights"], geo, views, res, res,
                                    kw["bin_tile"], dmxu)
        assert plan.smem_bytes <= 227 * 1024
        library = rc.library_of(route, False, kw["texture"], dmxu, geo)
        if geo != "prep":
            # render_body's 16x16 blocks: two stage buffers and the camera row.
            rows = {"raw": 16, "raw_shadows": 16, "raw_wt": 10}[geo]
            assert plan == rc.StreamPlan(0, 1, 4 * (2 * rows * (S // CC)
                                                    + rc._n_cam_cols(kw["n_lights"])))
            assert library == ("render_dmxu" if dmxu else "render_binned_blocks")
            assert rc.library_of(route, True, kw["texture"], dmxu, geo) == \
                ("render_dmxu" if dmxu else "render_seeded")
            continue
        assert library == rc.library_of(route, True, kw["texture"], dmxu) == "render_binned"
        # Four groups fit whatever the cluster count: 384 bytes of head,
        # each group's two stage buffers and its 256 records, the camera row.
        rows = 10 if dmxu else 11
        assert plan.groups == rc._STREAM_GROUPS
        assert plan.smem_bytes == 384 + 4 * (4 * 2 * rows * (S // CC) + 4 * 10 * 256
                                             + rc._n_cam_cols(kw["n_lights"]))
        n_bins = int(kw["bins"].shape[1])
        assert 1 <= plan.parts <= n_bins
        # Fewer views than the card's 132 slots: as many blocks a view as
        # the slots take, each keeping a tile a group.
        n_tiles = (-(-res // 16)) ** 2
        assert plan.parts == min(132 // views, n_tiles // plan.groups, n_bins)
        assert kw["bin_tile"] == (32 if name == "terrain224_512" else 16)
        assert S % 4 == 0 and (S // CC) % 4 == 0 and kw["rows"].data_ptr() % 16 == 0


@pytest.mark.parametrize("views", [32, 64, 512])
def test_a_views_blocks_take_each_tile_once(views):
    for res, bin_tile in ((64, 16), (128, 16), (512, 32), (72, 32), (100, 64)):
        n_tiles = (-(-res // 16)) ** 2
        plan = rc.binned_plan("prep", 32, 1, views, res, res, bin_tile)
        for parts in {1, 3, plan.parts}:
            shares = rc.binned_tiles(res, res, bin_tile, parts)
            assert len(shares) == parts
            assert sorted(t for share in shares for t in share) == list(range(n_tiles))
            # A bin tile's tiles land in one block, one after another.
            tiles_x = -(-res // 16)
            sub = bin_tile // 16
            owner = {}
            for b, share in enumerate(shares):
                bts = [(t // tiles_x // sub, t % tiles_x // sub) for t in share]
                for bt in bts:
                    assert owner.setdefault(bt, b) == b
                runs = [bt for i, bt in enumerate(bts) if i == 0 or bts[i - 1] != bt]
                assert len(runs) == len(set(runs))
        # The blocks the card holds at once: 64 registers a thread, the
        # block's shared memory (1 KB reserved a block).
        per_sm = max(1, min(65536 // (256 * plan.groups * 64),
                            228 * 1024 // (plan.smem_bytes + 1024)))
        slots = 132 * per_sm
        n_bins = (-(-res // bin_tile)) ** 2
        assert plan.parts <= n_bins
        if views >= slots:
            assert plan.parts == 1
        else:
            assert views * plan.parts <= slots or plan.parts == 1


def _tiny(S, CC, misaligned=False):
    """One world's streamed binned inputs at S slots in CC clusters, 16x16."""
    n = 40 * S
    flat = torch.zeros(n + 1)[1:] if misaligned else torch.zeros(n)
    bins = torch.zeros(1, 1, 1 + CC, dtype=torch.int32)
    return dict(rows=flat.view(1, 40, S), clusters=torch.zeros(1, 8, CC),
                cams=torch.zeros(1, rc._n_cam_cols(1)), num_cams=1, n_lights=1, height=16,
                width=16, seg_div=1, geo="prep", bins=bins, bin_tile=16,
                spans=torch.zeros(1, 2, CC, dtype=torch.int32),
                ranges=torch.zeros(1, CC, 2, 2, dtype=torch.int32))


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


def test_occupancy_needs_the_card():
    kw = _packed("terrain40_64", "prep")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the query runs (chip_smoke.py's binned_occupancy lines)")
    with pytest.raises(RuntimeError, match="needs the card"):
        rc.binned_occupancy(kw)
    # Not the binned walk: refused before any query.
    with pytest.raises(ValueError, match="not the streamed binned walk"):
        rc.binned_occupancy(dict(kw, bins=None, order=torch.zeros(1, 1, dtype=torch.int32)))
