"""PyTorch port: the resident visits' launch plan (K3 and K4 on resident rows).

The kernels take one block a view: the view's geometry rows, cluster table,
gate terms, camera row and (ordered) order in shared memory, the rows filled by one
bulk copy in 16-byte pieces. ``raytrace_cuda.resident_smem_bytes`` is the
block's shared memory and ``check_resident_plan`` its two rules, which the
wrapper applies on every device. Held here on the port's packs: every scene
``visit_route`` sends to a resident ordered or binned visit fits one block
(at most 227 KB) and meets the fill's alignment, on the demo scene, the
resident terrain at a 27 grid (ordered at 64², binned at 128²) and the
40-grid terrain textured by a 144² checker without mips (streamed: past the
resident budget), on prep, raw (with shadows) and watertight rows, under one
and three lights; and inputs built to break either rule raise
``LaunchPlanError`` before anything runs, never taking the plain version.
"""

import functools

import pytest
import torch

from madrona_renderer_tpu_torch import Manager, RenderMode
from madrona_renderer_tpu_torch.assets.png import write_png
from madrona_renderer_tpu_torch.core.scene import configure_lighting
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config, demo_config

from tests.fixtures import make_checker_png

THREE_LIGHTS = [((1.0, -1.0, -0.05), (0.5, 0.5, 0.5)), ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2)),
                ((0.5, 1.0, -1.0), (0.2, 0.2, 0.2))]
# name: (the scene's config, view size, accel, the route visit_route takes)
SCENES = {
    "demo_binned_64": (lambda path: demo_config(2, RenderMode.Raytracer, 64, 64, device="cpu"),
                       64, "binned", rc.Route(False, "binned")),
    "terrain27_64": (lambda path: bigmesh_config(2, 64, 64, grid=27, device="cpu"),
                     64, "auto", rc.Route(False, "ordered")),
    "terrain27_128": (lambda path: bigmesh_config(2, 128, 128, grid=27, device="cpu"),
                      128, "auto", rc.Route(False, "binned")),
    "tex40_16": (lambda path: bigmesh_config(2, 16, 16, grid=40, texture=path, mipmaps=False,
                                             device="cpu"),
                 16, "auto", rc.Route(True, "ordered")),
}
# geo: pack_inputs' switches for it (one camera a world: prep without them)
GEOS = {"prep": {}, "raw_shadows": dict(shadows=True), "raw_wt": dict(watertight=True),
        "raw_wt_shadows": dict(shadows=True, watertight=True)}


@pytest.fixture(scope="module")
def checker_png(tmp_path_factory):
    """tests/test_torch_nine_culled.py's 144×144 checker (past the in-kernel
    route's 16,384 texels)."""
    path = str(tmp_path_factory.mktemp("plan") / "big.png")
    write_png(path, make_checker_png(144, 16))
    return path


@functools.cache
def _manager(name, path):
    return Manager(SCENES[name][0](path))


@pytest.mark.parametrize("lights", [1, 3])
@pytest.mark.parametrize("geo", sorted(GEOS))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_resident_visits_fit_one_block(name, geo, lights, checker_png):
    _, res, accel, route = SCENES[name]
    r = _manager(name, checker_png)
    scene = r.scene if lights == 1 else configure_lighting(r.scene, lights=THREE_LIGHTS)
    assert rc.visit_route(r.state, scene, res, res, accel) == route
    kw = rc.pack_inputs(r.state, scene, height=res, width=res, accel=accel, **GEOS[geo])
    assert kw["n_lights"] == lights
    assert rc.route_of(kw["order"], kw["spans"], kw["bins"]) == route
    W, _, S = kw["rows"].shape
    CC = int(kw["clusters"].shape[2])
    if route.streamed:
        # Past the resident budget: the streamed route, no resident plan
        # (the 9-output mode there leaves the shadows to the epilogue).
        assert rc.is_streamed(r.state, scene) and kw["texture"] == "nine"
        return
    assert kw["geo"] == geo
    smem = rc.resident_smem_bytes(geo, S, CC, lights, kw["order"] is not None)
    assert smem <= 227 * 1024
    assert smem == (128 + 4 * (rc._VISIT_GEO_ROWS[geo] * S + 15 * CC + kw["cams"].shape[1])
                    + 4 * CC * (kw["order"] is not None))
    assert S % 4 == 0 and kw["rows"].data_ptr() % 16 == 0
    rc.check_resident_plan(kw["rows"], CC, lights, geo, kw["order"] is not None)


def _tiny(S, CC, geo, visit, misaligned=False):
    """One world's inputs at S slots in CC clusters, built directly, for a
    resident visit (``visit`` "ordered" or "binned") at 16×16."""
    n = 40 * S
    flat = torch.zeros(n + 1)[1:] if misaligned else torch.zeros(n)
    rows = flat.view(1, 40, S)
    clusters = torch.zeros(1, 8, CC)
    cams = torch.zeros(1, rc._n_cam_cols(1))
    kw = dict(rows=rows, clusters=clusters, cams=cams, num_cams=1, n_lights=1, height=16,
              width=16, seg_div=1, geo=geo)
    if visit == "ordered":
        kw["order"] = torch.arange(CC, dtype=torch.int32).view(1, CC)
    else:
        kw.update(bins=torch.zeros(1, 1, 1 + CC, dtype=torch.int32), bin_tile=16)
    return kw


# case: (S, CC, geo, misaligned, the rule the message names)
REFUSED = {
    "rows_misaligned": (8, 2, "prep", True, "16-byte"),
    "slots_not_a_multiple_of_4": (6, 2, "prep", False, "multiple of 4"),
    "block_past_227_kb": (3072, 3072, "raw", False, "shared memory"),
}


@pytest.mark.parametrize("visit", ["ordered", "binned"])
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_plan_refusals_raise_before_any_sweep(case, visit, monkeypatch):
    S, CC, geo, misaligned, words = REFUSED[case]
    kw = _tiny(S, CC, geo, visit, misaligned)
    if misaligned:
        assert kw["rows"].data_ptr() % 16 == 4
    called = []
    monkeypatch.setattr(rc, "render_resident_plain", lambda *a, **k: called.append(1))
    with pytest.raises(rc.LaunchPlanError, match=words):
        rc.render_resident(**kw)
    assert not called  # no fallback: nothing ran
    assert issubclass(rc.LaunchPlanError, ValueError)
