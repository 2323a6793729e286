"""The streamed render kernel's launch order, measured: the committed grid
(views, tiles), a tile's views next to each other, against a 1D grid that
keeps each view's 16 tiles together (so they could share the view's
clusters in L2), on bench.py's bigmesh_512w inputs (512 worlds x 64x64),
in turns, each a CUDA graph of 50 launches:

    python3 port_tools/stream_grid_ab.py

The second build is the committed source with three lines rewritten (see
TILE_MAJOR); both must give the same frames. Prints one JSON line. Needs
one card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from madrona_renderer_tpu_torch import _build  # noqa: E402
from madrona_renderer_tpu_torch.assets.importer import load_render_assets  # noqa: E402
from madrona_renderer_tpu_torch.core.scene import bake_scene  # noqa: E402
from madrona_renderer_tpu_torch.core.state import init_state  # noqa: E402
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc  # noqa: E402
from madrona_renderer_tpu_torch.runners import scenes  # noqa: E402

# The tile-major order: one 1D grid, block b = view · tiles + tile. (The mip
# hand-off's plane stride would need the same change; it is not timed here.)
TILE_MAJOR = {
    "  const int view = blockIdx.x;\n":
        "  const int tiles_ = a.tiles_x * ((a.height + kTileY - 1) / kTileY);\n"
        "  const int view = STREAM ? (int)blockIdx.x / tiles_ : (int)blockIdx.x;\n",
    "  const int tile = blockIdx.y;\n":
        "  const int tile = STREAM ? (int)blockIdx.x - view * tiles_ : (int)blockIdx.y;\n",
    "render_streamed_kernel<GEO, RASTER, TEX><<<grid, block, smem, stream>>>(a, s);":
        "render_streamed_kernel<GEO, RASTER, TEX>"
        "<<<dim3(grid.x * grid.y), block, smem, stream>>>(a, s);",
}


def build_tile_major(tmp: Path):
    src = (_build.CSRC / "render_resident.cu").read_text()
    for old, new in TILE_MAJOR.items():
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old.strip()!r}")
        src = src.replace(old, new)
    cu, so = tmp / "tile_major.cu", tmp / "libtile_major.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.mrt_render_resident
    fn.argtypes, fn.restype = _build.SIGNATURES["render_resident"][1], ctypes.c_int
    err = lib.mrt_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    fn.error_string = lambda code: err(code).decode()
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_grid_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = scenes.bigmesh_config(512).rcfg
    scene = bake_scene(load_render_assets(cfg.geo_cfg, [], cfg.additional_mats, []), dev)
    state = init_state(cfg.instances, cfg.cameras, cfg.worlds, dev)
    kw = rc.pack_inputs(state, scene, height=64, width=64)
    load = _build.load
    committed = load("render_resident")
    with tempfile.TemporaryDirectory() as tmp:
        launches = {"views_tiles": committed, "tile_major": build_tile_major(Path(tmp))}
        ref = rc.render_resident(**kw)
        out = {"phase": "stream_grid_ab", "nvidia_smi": cs.nvidia_smi()}
        for turn in range(2):
            for name, fn in launches.items():
                _build.load = lambda _name, fn=fn: fn
                got = rc.render_resident(**kw)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{name}: other frames")
                out[f"{name}_ms_{turn}"] = cs.graph_ms(lambda: rc.render_resident(**kw),
                                                       cs.KERNEL_REPS)
        _build.load = load
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
