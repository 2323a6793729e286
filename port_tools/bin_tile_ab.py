"""K4's bin tile, measured: the binned render kernel and the binning at bin
tiles of 16, 32 and 64 pixels, on tools/tpu_binned_bench.py's scene (32
worlds of the 224-grid terrain, runners/scenes.binned_terrain_config) at
128x128, 256x256 and 512x512:

    python3 port_tools/bin_tile_ab.py [WORLDS]

At each size the renderer's own inputs (pack_inputs, accel="binned", whose
bin tile is raytrace_cuda.bin_tile_for's) are rebinned at each tile with
raytrace_cuda.band_cluster_bins; every tile must give the frames of the
renderer's tile. Each tile's kernel time is a CUDA graph of 50 launches;
its binning (the view's order, the 8-row spans, the bins: torch ops) is
timed by CUDA events over 5 calls (host-bound: the events take in the
launches' host time) and, once, by the profiler's kernel time
(chip_smoke.device_ms); the tiles timed in turns 16, 32, 64, 64, 32, 16.
Prints one JSON line per size, with the card's name and power limit. Needs
one card and nvcc.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from madrona_renderer_tpu_torch.assets.importer import load_render_assets  # noqa: E402
from madrona_renderer_tpu_torch.core.scene import bake_scene  # noqa: E402
from madrona_renderer_tpu_torch.core.state import init_state  # noqa: E402
from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc  # noqa: E402
from madrona_renderer_tpu_torch.runners import scenes  # noqa: E402

SIZES = (128, 256, 512)
TILES = (16, 32, 64)


def main() -> int:
    if not torch.cuda.is_available():
        print("bin_tile_ab: no CUDA device", file=sys.stderr)
        return 2
    worlds = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    for res in SIZES:
        cfg = scenes.binned_terrain_config(worlds, res, res)
        rcfg = cfg.rcfg
        scene = bake_scene(load_render_assets(rcfg.geo_cfg, [], rcfg.additional_mats, []),
                           dev)
        state = init_state(rcfg.instances, rcfg.cameras, rcfg.worlds, dev)
        kw = rc.pack_inputs(state, scene, height=res, width=res, accel="binned")
        ref = rc.render_resident(**kw)
        eff_fov = torch.where(state.camera_fov > 0, state.camera_fov, cfg.fov_y_degrees)
        cl_lo, cl_hi, cl_valid, _ = rc.world_clusters(state, scene)

        def binning(tile):
            tx = -(-res // tile)
            order = rc.camera_cluster_order(cl_lo, cl_hi, cl_valid, state.camera_pos)
            rc.camera_cluster_rowspans(cl_lo, cl_hi, cl_valid, state, eff_fov, res, g_rows=8)
            return rc.band_cluster_bins(cl_lo, cl_hi, cl_valid, state, eff_fov, res, res,
                                        tx * tx, tx, tile, tile, order=order)

        out = {"phase": "bin_tile_ab", "size": res, "worlds": worlds, "nvidia_smi": smi,
               "rule_tile": kw["bin_tile"]}
        for turn, tiles in enumerate((TILES, TILES[::-1])):
            for tile in tiles:
                kw_t = dict(kw, bins=binning(tile).contiguous(), bin_tile=tile)
                got = rc.render_resident(**kw_t)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{res}x{res}: bin tile {tile} gives other frames")
                out[f"k4_ms_{tile}_{turn}"] = cs.graph_ms(
                    lambda: rc.render_resident(**kw_t), cs.KERNEL_REPS)
                out[f"bins_ms_{tile}_{turn}"] = cs.cuda_ms(lambda: binning(tile), 5)
                if turn == 0:
                    out[f"bins_device_ms_{tile}"] = cs.device_ms(lambda: binning(tile))
                    out[f"bins_bytes_{tile}"] = kw_t["bins"].numel() * 4
                del kw_t, got
        print(json.dumps(out), flush=True)
        del kw, ref, scene, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
