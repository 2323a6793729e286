"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries land in ``build/torch_kernels/`` at the
root of a source checkout, or in a per-user cache directory for an
installed package (``cache_root``), named by a hash of the source, the
sources it includes (``csrc/render_binned.cu``,
``csrc/render_binned_blocks.cu``, ``csrc/render_resident_ordered.cu``,
``csrc/render_resident_binned.cu``, ``csrc/render_seeded.cu``,
``csrc/render_none.cu``, ``csrc/render_dmxu.cu``, ``csrc/render_mip.cu``
and ``csrc/render_streamed.cu`` include ``csrc/render_resident.cu``, which
with ``csrc/shade_mip.cu`` includes ``csrc/mip_sample.cuh``) and the
flags, so an edited source or flag rebuilds and an unchanged one loads at
once. Nothing is built when this module is imported: the first call that
launches a kernel builds it. The sources ship in the package
(``pyproject.toml``'s package data).

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` without fast
math, so every kernel rounds each multiply and add on its own, as its
plain PyTorch version does (IEEE divide and square root are nvcc's
defaults).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

PACKAGE = Path(__file__).resolve().parent
CSRC = PACKAGE / "csrc"


def cache_root(package: Path = PACKAGE) -> Path:
    """Where the port writes what it builds and generates (kernel
    libraries, demo textures): ``build/`` at the root of a source checkout
    (the package's parent holds ``pyproject.toml``; ``.gitignore`` lists
    ``build/``), else ``madrona_renderer_tpu_torch/`` in the user's cache
    directory (``$XDG_CACHE_HOME``, else ``~/.cache``), never inside an
    installed package."""
    if (package.parent / "pyproject.toml").is_file():
        return package.parent / "build"
    xdg = os.environ.get("XDG_CACHE_HOME", "")
    base = Path(xdg) if os.path.isabs(xdg) else Path.home() / ".cache"
    return base / "madrona_renderer_tpu_torch"


BUILD_DIR = cache_root() / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each kernel's launch function: (symbol, argtypes), or for a
# library of several entries with one signature (the ladder's probes) the
# tuple of their symbols and the argtypes.
SIGNATURES = {
    "render_resident": (
        "mrt_render_resident",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off)
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I,  # the index visit's groups a block (0: the parent's 16x16 blocks)
         _P],  # stream
    ),
    "render_streamed": (
        "mrt_render_streamed",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off, the 9-output mode)
         _P, _P,  # order spans
         _P,  # seed (K9) or null
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I, _I,  # groups (tile groups a block; 0: 16x16 blocks) parts (blocks a view)
         _P],  # stream
    ),
    "render_binned": (
        "mrt_render_binned",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off, the 9-output mode)
         _P, _P, _P,  # bins spans ranges (or null: K11, raw rows)
         _P,  # seed (K9) or null
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I, _I, _I, _I,  # bins_x bin_shift n_bins n_bands
         _I, _I,  # dmxu (K11) rowskip
         _I, _I,  # groups (tile groups a block) parts (blocks a view)
         _P],  # stream
    ),
    "render_binned_blocks": (
        "mrt_render_binned_blocks",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off)
         _P, _P, _P,  # bins spans ranges
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I, _I, _I, _I,  # bins_x bin_shift n_bins n_bands
         _P],  # stream
    ),
    "render_seeded": (
        "mrt_render_seeded",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off)
         _P, _P, _P,  # spans bins ranges (each or null)
         _P,  # seed
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I, _I, _I, _I,  # bins_x bin_shift n_bins n_bands
         _P],  # stream
    ),
    "render_resident_ordered": (
        "mrt_render_resident_ordered",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off)
         _P,  # order
         _P,  # seed
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _P],  # stream
    ),
    "render_resident_binned": (
        "mrt_render_resident_binned",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off)
         _P,  # bins
         _P,  # seed
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I, _I, _I,  # bins_x bin_shift n_bins
         _P],  # stream
    ),
    "render_none": (
        "mrt_render_none",
        [_P, _P, _P, _P, _P,  # rows clusters (null: K1-none) cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off, the 9-output mode)
         _P,  # seed
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I,  # culled (K1's 9-output entries) or not (K1-none)
         _I,  # K1-none's tile-team groups a block (0: the parent's 16x16 blocks)
         _P],  # stream
    ),
    "render_dmxu": (
        "mrt_render_dmxu",
        [_P, _P, _P, _P, _P,  # rows clusters cams mats pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _P, _P,  # code handoff (the mip hand-off)
         _P, _P, _P, _P,  # order spans bins seed (order or bins; seed or null)
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I, _I,  # raster tex_filter geo
         _I, _I, _I,  # bins_x bin_shift n_bins
         _I,  # rowskip
         _I, _I,  # groups (the ordered walk's tile groups a block; 0: 16x16 blocks) parts
         _P],  # stream
    ),
    "ladder": (
        ("mrt_ladder_copy", "mrt_ladder_grid_smem", "mrt_ladder_fori_smem"),
        [_P, _P, _P,  # x s out
         _I, _I,  # blocks n
         _P],  # stream
    ),
    "render_batched": (
        "mrt_render_batched",
        [_P] * 6  # rows cams t idx planes ints
        + [_I] * 7  # num_views num_cams S n_cols n_lights height width
        + [_F, _F,  # two_over_w two_over_h
           _I, _I,  # raster nine
           _I,  # pixels a thread (0: the parent design's 16x16 blocks)
           _P],  # stream
    ),
    "render_mip": (
        "mrt_render_mip",
        [_P, _P, _P, _P, _P,  # rows clusters cams table pool
         _I,  # n_mats
         _P, _P, _P,  # depth seg rgb
         _I, _I, _I, _I, _I, _I, _I, _I, _I,  # num_views S CC cluster_size .. seg_div
         _F, _F,  # two_over_w two_over_h
         _I, _I,  # n_levels fb_rows
         _I, _I, _I,  # the TPU tiling: tile_sub tiles_x n_tiles
         _I, _I,  # filter, the index visit's groups a block
         _P],  # stream
    ),
    "shade_mip": (
        "mrt_shade_mip",
        [_P] * 6  # code handoff cams table pool rgb
        + [_I] * 12  # num_views .. filter
        + [_P],  # stream
    ),
    "pack_rows": (
        "mrt_pack_rows",
        [_P] * 22  # instance, camera and scene tables, then out
        + [_I, _I, _I,  # W I T
           _P],  # stream
    ),
}


def sources() -> list:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's kernels build with the CUDA toolkit "
        "(PATH or /usr/local/cuda/bin)"
    )


def _source_bytes(src: Path) -> bytes:
    """The source and, in order, the ``csrc`` files it includes."""
    data = src.read_bytes()
    for inc in re.findall(rb'^#include "([^"]+)"', data, flags=re.M):
        data += b"\0" + _source_bytes(CSRC / inc.decode())
    return data


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        _source_bytes(src) + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; returns
    the library path. Concurrent builders each write a private temporary
    file and publish it with an atomic rename."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}_", suffix=".so")
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> Dict[str, Path]:
    """Build every kernel under ``csrc/``: one ``nvcc`` per source, all
    started together."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def symbols(name: str) -> tuple:
    """The C entries of ``csrc/<name>.cu``'s library."""
    symbol = SIGNATURES[name][0]
    return (symbol,) if isinstance(symbol, str) else symbol


@functools.cache
def load(name: str, symbol: str | None = None):
    """The kernel's launch function (``symbol``, for a library of several
    entries), built on first use and bound with its ``argtypes``/``restype``
    (every pointer and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(str(build(name)))
    argtypes = SIGNATURES[name][1]
    fn = getattr(lib, symbol or symbols(name)[0])
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = lib.mrt_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    fn.error_string = lambda code: err(code).decode()
    return fn
