"""The SSAA rgb box filter in three forms of torch ops, on one card:

    python3 port_tools/ssaa_filter_ab.py [WORLDS] [SIZE] [S]

On WORLDS views (4096) rendered at S x SIZE (2 x 64: bench.py's
textured_4096w_ssaa2) of random packed RGBA8 with opaque alpha, it holds
three forms of the filter bitwise equal and prints one JSON line with each
one's device time (CUDA events, 20 calls, after one warm-up; the forms
timed in turns a, b, c, c, b, a) and the card's name and power limit:
  a  per channel: shift, mask, a reshape sum in int32, round, shift, or;
  b  ops/ssaa.downsample_frames: the u8 subsamples summed in one int32
     reduction, rounded, cast to u8;
  c  two channels per 32-bit word (masks 0x00FF00FF) summed over the s*s
     strided subsample slices, rounded per 16-bit lane.
Needs one CUDA card.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from madrona_renderer_tpu_torch.core.frames import Frames  # noqa: E402
from madrona_renderer_tpu_torch.ops import ssaa  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ssaa_filter_ab: no CUDA device", file=sys.stderr)
        return 2
    worlds, size, s = ([int(a) for a in sys.argv[1:4]] + [4096, 64, 2][len(sys.argv[1:4]):])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (worlds, 1, size * s, size * s)
    packed = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, device=dev,
                           generator=gen) | -16777216  # alpha 255, as rendered
    frames = Frames(rgb=packed.view(torch.uint8).reshape(*shape, 4),
                    depth=torch.zeros(shape, device=dev),
                    segmask=torch.zeros(shape, dtype=torch.int32, device=dev))
    n = s * s

    def per_channel():
        out = torch.zeros((worlds, 1, size, size), dtype=torch.int32, device=dev)
        for ch in range(4):
            acc = ((packed >> (8 * ch)) & 255).reshape(worlds, 1, size, s, size, s).sum(
                dim=(3, 5), dtype=torch.int32)
            out |= ((acc + n // 2) // n) << (8 * ch)
        return out

    def reduction():
        return ssaa.downsample_frames(frames, s).rgb.view(torch.int32)[..., 0]

    def two_lanes():
        view = packed.reshape(worlds, 1, size, s, size, s)
        lo = hi = 0
        for i, j in itertools.product(range(s), range(s)):
            sub = view[:, :, :, i, :, j]
            lo = lo + (sub & 0x00FF00FF)
            hi = hi + ((sub >> 8) & 0x00FF00FF)

        def rnd(x):
            return (x + n // 2) // n

        return (rnd(lo & 0xFFFF) | (rnd(hi & 0xFFFF) << 8)
                | (rnd((lo >> 16) & 0xFFFF) << 16) | (rnd((hi >> 16) & 0xFFFF) << 24))

    forms = {"a": per_channel, "b": reduction, "c": two_lanes}
    want = forms["b"]()
    out = {"worlds": worlds, "size": size, "s": s,
           "bitwise": {k: bool(torch.equal(f(), want)) for k, f in forms.items()}}
    times = {k: [] for k in forms}
    for k in "abccba":
        fn = forms[k]
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[k].append(start.elapsed_time(end) / 20)
    out["ms"] = times
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0 if all(out["bitwise"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
