"""PyTorch port: it stands alone.

The port (and chip_smoke.py and port_tools/) imports neither JAX nor any
module of the JAX package; it renders on the CPU (raytraced, textured,
mip-mapped, rasterized, a streamed big mesh with its walk replayed, the
binned terrain with its binned walk replayed, and with K11's, watertight and
supersampled; the ladder's probes' plain versions) in a process where both
are unimportable; a CPU render
launches no kernel; every kernel source under csrc/ has its launch
signature, so the build covers it.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "madrona_renderer_tpu_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "port_tools").glob("*.py")))


def _forbidden(module: str) -> bool:
    """jax / jax.* / jaxlib*, and the JAX package itself by its exact name
    (``madrona_renderer_tpu_torch`` shares its prefix and is allowed)."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "madrona_renderer_tpu"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_forbidden_matches_exact_package_name():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("madrona_renderer_tpu")
    assert _forbidden("madrona_renderer_tpu.ops.raytrace_ref")
    assert not _forbidden("madrona_renderer_tpu_torch")
    assert not _forbidden("madrona_renderer_tpu_torch.ops.raytrace_cuda")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["madrona_renderer_tpu"] = None
import madrona_renderer_tpu_torch as m
from madrona_renderer_tpu_torch.ops import pack_cuda, raytrace_cuda
from madrona_renderer_tpu_torch.runners.scenes import demo_config
r = m.Manager(demo_config(2, m.RenderMode.Raytracer, 32, 32, dynamic=True, device="cpu"))
seg = r.segmask_tensor().numpy()
assert seg.shape == (2, 32, 32) and set(seg.ravel().tolist()) == {-1, 0, 1}
t = m.Manager(demo_config(2, m.RenderMode.Raytracer, 32, 32, dynamic=True, textured=True,
                          tex_size=32, texture_filter="bilinear", device="cpu"))
assert t.rgb_tensor().numpy().shape == (2, 32, 32, 4)
ra = m.Manager(demo_config(2, m.RenderMode.Rasterizer, 32, 32, textured=True, tex_size=32,
                           device="cpu"))
assert ra.depth_tensor().numpy().shape == (2, 32, 32, 1)
mp = m.Manager(demo_config(2, m.RenderMode.Raytracer, 32, 32, textured=True, tex_size=256,
                           texture_filter="trilinear", device="cpu"))
assert raytrace_cuda.has_mips(mp.scene) and mp.rgb_tensor().numpy().shape == (2, 32, 32, 4)
from madrona_renderer_tpu_torch.ops import walk_replay
from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config
bm = m.Manager(bigmesh_config(2, 32, 32, grid=40, device="cpu"))
assert raytrace_cuda.is_streamed(bm.state, bm.scene)
assert set(bm.segmask_tensor().numpy().ravel().tolist()) == {-1, 0, 1}
kw = raytrace_cuda.pack_inputs(bm.state, bm.scene, height=32, width=32)
assert walk_replay.streamed_walk(**kw)["segmask"].equal(bm.segmask_tensor().to_torch())
from madrona_renderer_tpu_torch.ops.quat import quat_multiply, quat_normalize
from madrona_renderer_tpu_torch.runners.scenes import binned_terrain_config
bt = m.Manager(binned_terrain_config(2, 32, 32, grid=40, accel="binned", device="cpu"))
rot = bt.instance_rotation_tensor().to_torch()
rot.copy_(quat_normalize(quat_multiply(rot, rot)))
bt.step()
kw = raytrace_cuda.pack_inputs(bt.state, bt.scene, height=32, width=32, accel="binned")
assert kw["bins"] is not None and kw["ranges"] is not None
assert walk_replay.binned_walk(**kw)["segmask"].equal(bt.segmask_tensor().to_torch())
wt = m.Manager(demo_config(2, m.RenderMode.Raytracer, 32, 32, dynamic=True, watertight=True,
                           device="cpu"))
assert set(wt.segmask_tensor().numpy().ravel().tolist()) == {-1, 0, 1}
aa = m.Manager(demo_config(2, m.RenderMode.Rasterizer, 16, 16, ssaa=2, device="cpu"))
assert aa.rgb_tensor().numpy().shape == (2, 16, 16, 4)
from madrona_renderer_tpu_torch.ops import ssaa, watertight
mx = m.Manager(demo_config(2, m.RenderMode.Raytracer, 32, 32, dynamic=True, accel="mxu",
                           shadows=True, device="cpu"))
assert set(mx.segmask_tensor().numpy().ravel().tolist()) == {-1, 0, 1}
no = m.Manager(demo_config(2, m.RenderMode.Rasterizer, 32, 32, accel="none", device="cpu"))
assert no.depth_tensor().numpy().shape == (2, 32, 32, 1)
nine = m.Manager(demo_config(2, m.RenderMode.Raytracer, 32, 32, textured=True, tex_size=144,
                             mipmaps=False, shadows=True, device="cpu"))
assert raytrace_cuda.pack_inputs(nine.state, nine.scene, height=32, width=32)["texture"] == "nine"
dm = m.Manager(binned_terrain_config(2, 32, 32, grid=40, accel="binned", deferred_mxu=True,
                                     device="cpu"))
kw = raytrace_cuda.pack_inputs(dm.state, dm.scene, height=32, width=32, accel="binned",
                               deferred_mxu=True)
assert kw["dmxu"] and kw["ranges"] is None
assert walk_replay.dmxu_walk(**kw)["segmask"].equal(dm.segmask_tensor().to_torch())
from madrona_renderer_tpu_torch import ladder
probes = ladder.probe_inputs("cpu")
assert float(ladder.fori_smem(*probes["ladder_fori_smem"])[0, 0, 0]) == 496.0
assert sum(f.launches for f in ladder.WRAPPERS.values()) == 0
assert raytrace_cuda.render_resident.launches == 0
assert raytrace_cuda.render_batched.launches == 0
assert raytrace_cuda.shade_mip.launches == 0
assert sum(pack_cuda.pack_rows.layout_launches.values()) == 0
loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "madrona_renderer_tpu") and sys.modules[k] is not None)
assert not loaded, loaded
print("OK")
"""


def test_renders_without_jax_in_a_fresh_process():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_cpu_render_launches_no_kernel():
    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import raytrace_cuda
    from madrona_renderer_tpu_torch.runners.scenes import demo_config

    before = raytrace_cuda.render_resident.launches
    r = m.Manager(demo_config(2, m.RenderMode.Raytracer, 16, 16, device="cpu"))
    r.step()
    assert raytrace_cuda.render_resident.launches == before == 0
    assert (r.segmask_tensor().numpy() >= 0).any()


def test_pack_rows_never_falls_back():
    """K13's wrapper takes its plain version only for CPU tensors (here: a
    state and scene moved to the 'meta' device raise)."""
    import dataclasses

    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch.ops import pack_cuda
    from madrona_renderer_tpu_torch.runners.scenes import demo_config

    r = m.Manager(demo_config(1, m.RenderMode.Raytracer, 16, 16, device="cpu"))

    def to_meta(x):
        return dataclasses.replace(x, **{
            f.name: getattr(x, f.name).to("meta") for f in dataclasses.fields(x)
            if hasattr(getattr(x, f.name), "to")})

    state, scene = to_meta(r.state), to_meta(r.scene)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pack_cuda.pack_rows(state, scene, state.camera_pos[:, 0, :])


def test_cuda_tensor_never_falls_back():
    """A tensor on a device other than the CPU never takes the plain path:
    the wrapper launches K1 there or raises (here: a 'meta' tensor)."""
    import torch

    from madrona_renderer_tpu_torch.ops import raytrace_cuda

    rows = torch.empty((1, 40, 16), device="meta")
    clusters = torch.empty((1, 8, 2), device="meta")
    cams = torch.empty((1, 24), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        raytrace_cuda.render_resident(rows, clusters, cams, num_cams=1, n_lights=1,
                                      height=8, width=8, seg_div=8)
    # The streamed route too.
    order = torch.empty((1, 2), dtype=torch.int32, device="meta")
    spans = torch.empty((1, 2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        raytrace_cuda.render_resident(rows, clusters, cams, num_cams=1, n_lights=1,
                                      height=8, width=8, seg_div=8, order=order,
                                      spans=spans)
    # K1-none (no cluster table), the 9-output mode, and K12.
    with pytest.raises(ValueError, match="cuda or cpu"):
        raytrace_cuda.render_resident(rows, None, cams, num_cams=1, n_lights=1,
                                      height=8, width=8, seg_div=8, texture="nine")
    for nine in (False, True):
        with pytest.raises(ValueError, match="cuda or cpu"):
            raytrace_cuda.render_batched(rows, cams, num_cams=1, n_lights=1, height=8,
                                         width=8, nine=nine)
    # K11 on either streamed visit; the 9-output mode on the culled visits.
    for texture in (None, "nine"):
        with pytest.raises(ValueError, match="cuda or cpu"):
            raytrace_cuda.render_resident(rows, clusters, cams, num_cams=1, n_lights=1,
                                          height=8, width=8, seg_div=8, order=order,
                                          spans=spans, dmxu=True, texture=texture)
    with pytest.raises(ValueError, match="cuda or cpu"):
        raytrace_cuda.render_resident(rows, clusters, cams, num_cams=1, n_lights=1,
                                      height=8, width=8, seg_div=8, order=order,
                                      texture="nine")


def test_every_kernel_source_has_a_signature():
    """Each csrc/*.cu builds into a library whose launch function _build
    binds: none is left out of build_all or of load."""
    from madrona_renderer_tpu_torch import _build

    assert set(_build.sources()) == set(_build.SIGNATURES)
    assert "shade_mip" in _build.sources() and "ladder" in _build.sources()
    assert len(_build.symbols("ladder")) == 3
    for name in _build.sources():
        for symbol in _build.symbols(name):
            assert f"int {symbol}(" in (_build.CSRC / f"{name}.cu").read_text()


def test_shade_mip_never_falls_back():
    """K7's second launch takes its plain version only for CPU tensors (here:
    'meta' tensors raise)."""
    import torch

    from madrona_renderer_tpu_torch.ops import raytrace_cuda

    code = torch.empty((1, 8, 8), dtype=torch.int32, device="meta")
    handoff = torch.empty((6, 1, 8, 8), device="meta")
    cams = torch.empty((1, 24), device="meta")
    table = torch.empty((4 + 3 * 4, 2), device="meta")
    pool = torch.empty((2048,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        raytrace_cuda.shade_mip(code, handoff, cams, table, pool, fb_rows=16,
                                texture="trilinear", n_lights=1)
