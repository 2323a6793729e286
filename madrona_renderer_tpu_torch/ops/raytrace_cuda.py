"""Batch raytracer: the render prologue, then kernel K1 (K1-raw, K8, K10,
K2, K6, K7) or K3 / K4 on resident rows, or on meshes past the resident
budget K3 + K5 or K4; each raytrace variant seeded by K9 on request; the
non-culled sweep K1-none (``accel="none"``, and tiny worlds) and the
batched kernel K12 (``accel="mxu"``); and the 9-output route with its
shading and shadow epilogue (``frames_from_core``).

The port of the main path of the JAX package's ``ops/raytrace_pallas.py``
(``render_core``, :3998) for what its flags resolve to on scenes that fit
the resident budget: the cluster-culled resident sweep, shaded in the
kernel, with the fused export (depth, segmask and RGBA8 written in their
final masked form). On one-camera scenes without shadows it sweeps
pack-time Möller–Trumbore rows (``prep``, ``uv_defer``: K1); with more than
one camera per world or with shadows, the raw v0 / e1 / e2 rows with each
view's own camera origin (K1-raw), plus a culled any-hit sweep per light
when ``shadows`` (K8), as ``render_core`` resolves them (:4342-4355). With
``watertight`` every scene takes the raw rows (the JAX package turns its
prep and deferred cuts off, :4425-4436) and the sweep decides each hit by
the Woop sheared edge-function test instead (K10, ``ops/watertight.py``;
the Möller–Trumbore (u, v) only interpolate the winner's attributes, the
shadow rays stay Möller–Trumbore). Each
is untextured (``shaded``), takes the in-kernel texture route
(``textured``, nearest or bilinear, K6) or, on scenes baked with mip chains,
the mip route (``tex_paged``, nearest, bilinear or trilinear, K7: the
render kernel hands each pixel's material, uv, footprint and lambert sums
to ``shade_mip``, which picks the level, clamps it to the tile's window and
samples), in the raytrace or the raster conventions (``raster_clip``, K2).

  1. The prologue packs the inputs: ``pack_cuda.pack_rows`` (kernel K13 on
     the card; on the CPU ``_pack_rows_planar``, the JAX split layout with
     camera-origin prep rows or raw rows, term for term), then as torch ops
     ``_pack_cams`` and ``world_clusters`` + ``_pack_clusters`` (the
     per-step TLAS refit), and for textured scenes the material table (with
     mips the mip table) and the packed texel pool
     (``shade.material_table`` / ``mip_table`` / ``texel_pool``).
  2. ``render_resident`` launches the kernel (``csrc/render_resident.cu``)
     for tensors on the card, or runs ``render_resident_plain`` — the
     same function in torch ops — for tensors on the CPU.
  3. The kernel writes ``[W·C, H, Wd]`` outputs directly, so ``raytrace``
     only reshapes them into ``Frames`` (the JAX ``unpack`` and supertile
     fold are TPU layout steps with no counterpart here).

Meshes past the resident budget (``is_streamed``: 32·S·4 bytes > 384 KB,
the JAX package's ``dma_tris``, :4265-4266, whatever the cluster count)
take the streamed route, with one of two visits (``visit_route``):
  * ordered (K3 + K5, ``csrc/render_streamed.cu``): the prologue adds each
    view's front-to-back cluster order (``camera_cluster_order``) and its
    clusters' pixel-row spans (``camera_cluster_rowspans`` at the kernel's
    16-row tiles); each tile's walk takes the order with the occlusion early
    exit, streaming each visited cluster's rows from device memory. A block
    fills the view's order once, in visit order with each position's gate
    terms, and its tile groups walk the view's tiles (``streamed_plan``:
    groups a block, blocks a view, shared memory); the shadow sweeps keep
    one 16x16 block a tile;
  * binned (K4, ``csrc/render_binned.cu``), where the JAX ``render_core``
    bins (``accel="binned"``, or ``"auto"`` with 64 or more clusters and 4
    or more TPU tiles: 128×128 views and up) and wherever the ordered
    walk's table would overflow a block's shared memory: the prologue adds
    per-tile bins (``band_cluster_bins``: the view's order with each bin
    tile's non-members taken out; the bin tile a square of 16·2^k pixels,
    ``bin_tile_for``) and spans at 8-row bands; each tile's walk takes its
    bin tile's bin with the ordered walk's gates. On prep rows tile groups
    of a block walk the tiles of the block's bin tiles, each group holding
    256 positions of its tile's bin with their gate terms in shared memory
    (``binned_plan``: groups a block, blocks a view, shared memory;
    ``binned_tiles``); raw and K10 rows and the shadow sweeps keep one
    16x16 block a tile (``csrc/render_binned_blocks.cu``). On prep rows each cluster's
    triangles are row-sorted (``cluster_row_sort``, ``row_sorted``: row 10
    holds the original index) and each 8-row band of a tile (warps 0-3,
    4-7) sweeps only its triangle range (``ranges``); exact ties go to the
    lower original index (``gi``), and the winner's attributes are read at
    it.
With ``deferred_mxu`` (the JAX package's ``MRT_DEFERRED_MXU=1``) the two
streamed visits take K11 instead (``csrc/render_dmxu.cu``: the ordered
walk's tile groups, ``streamed_plan(..., dmxu=True)``, and render_body's
16x16 blocks on the binned walk's raw rows; the binned walk's tile groups
on prep rows in ``csrc/render_binned.cu``; ``dmxu_route``):
the same walk, but each visited cluster's every slot swept (on raw rows its
D, A, Q and t_num formed in the kernel for the block's camera), its first
minimum taken and merged into the running best, and, where the TPU tiling
has more than one tile across (``rowskip``), each warp's two pixel rows
skipped outside the cluster's row span; the binned visit then streams
unsorted rows (no row sort, no ranges).
Resident scenes take one of three visits (``visit_route``, the JAX
``render_core``'s ``ordered`` and ``binned``, :4272-4292): index order (K1)
under 4 clusters a world; the front-to-back walk with the early exit (K3 on
resident rows, ``csrc/render_resident_ordered.cu``: ``camera_cluster_order``
in the prologue); or, where the JAX package bins, each tile's bin tile's
bin (K4 on resident rows, ``csrc/render_resident_binned.cu``:
``band_cluster_bins``). The rows stay in shared memory, filled once a view
(one block a view, several 16x16 tiles walking in it:
``resident_smem_bytes``, ``check_resident_plan``); there are no row spans,
row sort or triangle ranges on the resident route. K1 itself (and K6) on
prep rows, raytraced, untextured or nearest or bilinear, takes the same
shape on enough views (``index_plan``, ``check_index_plan``: one block a
view of 64-thread tile teams, 4 pixels a thread, each triangle's prep rows
as records), and so do K8, K10 (raw rows, the watertight decision:
records of each triangle's a, b, c and validity, 2 pixels a thread),
K1-none on prep and K10 rows (no cluster table: every team sweeps every
live slot) and K1's raster conventions on prep rows (K2, K2+K6: each
pixel's t-space near bound in the sweep, the raster export, blocks of two
groups where the views are few); their other modes, few views and blocks
past 227 KB keep one 16x16 block a tile.
Exact-t ties go to the lower triangle index on every route, so the visit
changes only the work: the frames are the index-order sweep's
(``render_resident_plain``, which puts row-sorted rows back in order
first). K9 (``seed``, ``render_core(seed_t=)``): each pixel's best t starts
at min(seed, far), a per-pixel bound that lets the walks stop sooner; the
warm start (``ops/warmstart.py``) is built on it.

The JAX package's other two routes (``render_core`` :4040-4073, :4655-4679,
:4880-4923): ``accel="none"``, and ``"auto"`` on worlds of fewer than 16
triangles or a single cluster, sweep every triangle without a cluster table
(K1-none, ``csrc/render_none.cu``: ``clusters`` None); ``accel="mxu"``
takes K12 (``render_batched``, ``csrc/render_batched.cu``) on K13's raw
rows, shaded on untextured scenes, else in the 9-output mode, several
pixels a thread on per-view prepass records (``batched_plan``). Where the JAX
package does not shade in the kernel (``output_mode``: textured pools past
the in-kernel route's 16,384 texels or 128 materials without mips, textured
scenes and shadows under ``accel="mxu"``), the kernel writes t, z, idx, the
material, uv and the normal (the 9-output mode, ``texture="nine"``, on every
visit: K1 and K1-none in ``csrc/render_none.cu``, K3 and K4 on resident rows,
K3 + K5, K4 and K11 in their routes' own sources, each seeded too), and
``frames_from_core`` shades them (``shade.shade_lambert_planar``), with
shadows through ``compute_lit``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..core.frames import Frames
from ..core.scene import SMEM_TRI_BUDGET, SceneData
from ..core.state import SimState
from . import mips, pack_cuda, shade
from . import watertight as wt
from .quat import quat_rotate
from .raytrace_ref import (_EPS_BARY, _EPS_DET, SHADOW_EPS, build_world_soup,
                           camera_ray_dirs, compute_lit, light_directions,
                           planar_soup_parts)
from .shade import AMBIENT, packed_to_rgba8

# Camera row: origin(3) right(3) fwd(3) up(3) tan_x tan_y near far_t far_z
# (cols 0-16), then L light blocks of [dir(3, normalized), color(3)] from
# col 17, then camera_valid, padded to a multiple of 8.
_CAM_LIGHT0 = 17
_N_GEO_ROWS = 16  # split pack: rows 0-9 prep constants, 10-15 padding
_N_PREP_ROWS = 10  # D(3) A(3) Q(3) t_num (raw: v0(3) e1(3) e2(3), valid)
_N_ATTR_ROWS = 24  # split pack: rows 16-35 attributes, 36-39 padding
_TRI_ROWS = 32  # the JAX kernel's resident row count (budget check)

# The f32 values of the JAX constants (Python floats there, rounded to f32
# where they meet an f32 array).
_F_EPS_DET = float(np.float32(_EPS_DET))
_F_EPS_BARY = float(np.float32(_EPS_BARY))
_F_ONE_PLUS_EPS = float(np.float32(1.0 + _EPS_BARY))
_F_AMBIENT = float(np.float32(AMBIENT))
_F_DIFFUSE = float(np.float32(1.0 - AMBIENT))
_F_TINY = float(np.float32(1e-20))
_F_COS_FLOOR = float(np.float32(1e-6))
_F_SHADOW_EPS = float(np.float32(SHADOW_EPS))
_F_EPS_BEHIND = float(np.float32(1e-6))  # the row spans' camera-plane floor
_ALPHA = int(np.uint32(0xFF000000).view(np.int32))
_CAM_FAR_Z = 16  # camera column of the z-space far clip (raster)
# The render kernel's texture switch: untextured, nearest, bilinear, the mip
# hand-off (K7's first launch), and the 9-output mode (t, z, idx, mat, uv,
# normal: the JAX kernel's unshaded outputs, shaded by the epilogue).
_TEX_CODES = {None: 0, "nearest": 1, "bilinear": 2, "mip": 3, "nine": 4}
_FUSED_TEX = (None, "nearest", "bilinear", "mip")
# shade_mip's filter switch.
_MIP_FILTER_CODES = {"nearest": 0, "bilinear": 1, "trilinear": 2}
_MIP_FB_ROWS = (16, 32, 64, 128)  # the bake's fallback-region sizes
_HANDOFF_PLANES = 6  # u, v, footprint, lambert r, g, b
_FOUND_BIT = 1 << 16
_SHADED_BIT = 1 << 17
# The kernel's geometry switch: prep rows, raw rows, raw rows with shadows,
# and the two raw sweeps with the watertight decision (K10).
_GEO_CODES = {"prep": 0, "raw": 1, "raw_shadows": 2, "raw_wt": 3, "raw_wt_shadows": 4}
_SHADOW_GEOS = ("raw_shadows", "raw_wt_shadows")
_WATERTIGHT_GEOS = ("raw_wt", "raw_wt_shadows")
# The 9-output mode's sweeps: its shadows are the epilogue's.
_NINE_GEOS = ("prep", "raw", "raw_wt")
_NINE_PLANES = 6  # the 9-output mode's f32 planes: z, uv x, uv y, normal x, y, z
_MAX_SHADOW_LIGHTS = 32  # one occlusion bit per light in the kernel
_TILE = 16  # the kernel's block: 16×16 pixels; the row spans' band height
# The streamed ordered walk's rule (visit_route): its table fits when two
# staged clusters of up to 16 rows, the cluster table, order and spans and
# the camera row do (an H100 block's dynamic shared memory ends at 227 KB).
_STAGE_ROWS = 16
_MAX_SMEM = 227 * 1024
# The streamed ordered walk's block (K3 + K5, csrc/render_streamed.cu): a
# 384-byte head (the tile counter, each tile group's tile slots, stage
# mbarriers and vote rows), each group's two stage buffers of [rows, cluster
# size] (the geometry rows a geo sweeps, _VISIT_GEO_ROWS), the view's
# positions (10 words a cluster of its order: the exit threshold, the row
# span, the cluster id with its count, the AABB less the camera origin)
# and the camera row. Four tile groups of 256 threads a block, fewer where a
# block would not fit; a view's tiles are shared over several blocks where
# there are fewer views than blocks the card holds at once. The shadow
# sweeps (_SHADOW_GEOS) take render_body's 16x16 blocks instead.
_STREAM_HEAD_BYTES = 384
_STREAM_WORDS = 10
_STREAM_GROUPS = 4
_STREAM_MAX_CLUSTERS = (1 << 16) - 1  # the cluster id's bits in its position word
# The streamed binned walk's block on prep rows (K4 and K11,
# csrc/render_binned.cu): the same head, each group's two stage buffers (K4's
# prep rows with row 10, K11's prep rows) and its records of _BIN_CHUNK
# positions of its tile's bin (10 words each), and the camera row. Raw and
# K10 rows and the shadow sweeps take render_body's 16x16 blocks (two stage
# buffers of _BIN_STAGE_ROWS and the camera row), as a plan of 0 groups
# does: the tile groups were slower there.
_BIN_CHUNK = 256
_BIN_STAGE_ROWS = {"prep": 11, "raw": 16, "raw_shadows": 16, "raw_wt": 10,
                   "raw_wt_shadows": 10}
_DMXU_STAGE_ROWS = 10
_H100_SMS = 132
_SM_SMEM = 228 * 1024  # an SM's shared memory, 1 KB of it reserved a block
_SM_REGS = 65536  # an SM's registers; the walk's entries take at most 64 a thread
# The resident visits' block (K3 and K4 on resident rows, one a view): a
# 128-byte head (the geometry fill's mbarrier, the tile counter, the tile
# groups' slots and votes), then the geometry rows a geo keeps in shared
# memory (prep D, A, Q, t_num; raw v0, e1, e2 and the view's tv, q, t_num;
# K10's a, b, c and the validity), the cluster table, the view's 7 rows of
# gate terms (each AABB less the camera origin, the early-exit threshold),
# the camera row and, ordered, the view's order. The fill copies the rows
# in 16-byte pieces.
_VISIT_HEAD_BYTES = 128
_VISIT_CLUSTER_ROWS = 8 + 7
_VISIT_GEO_ROWS = {"prep": 10, "raw": 16, "raw_shadows": 16, "raw_wt": 10,
                   "raw_wt_shadows": 10}
_FILL_ALIGN = 16
# K1's index visit on tile teams (csrc/render_resident.cu's
# render_index_kernel, visit_body with PIX > 0), the resident index order on
# prep rows, raytraced, untextured or nearest or bilinear: blocks of 1 or 2
# groups of 256 threads, each group 4 teams of 64 threads that take the
# view's 16x16 tiles one at a time, 4 pixels a thread (of 1, 2 and 4, 4 ran
# fastest on every input: port_tools/index_plan_ab.py), one block a view;
# where there are fewer views than blocks the card holds at once, the parent
# design (on 64 views at 64x64 it ran 9-16% faster than 4 blocks a view of
# the teams), and where the teams' block does not fit. Its shared memory:
# the 128-byte head, each triangle's prep rows as a record of 12 floats (D,
# t_num, A, Q: three float4), the cluster table and the view's gate terms
# (8 + 7 rows) and the camera row. Groups: 1 where a view has fewer than
# _INDEX_TILES_FOR_TWO tiles (64x64: 16), else 2 (128x128: 64). The teams
# take more modes: K7 folded (the mip sample in the same launch,
# csrc/render_mip.cu: the block also holds the TPU tiles' two window keys
# and each pixel's winner, _MIP_HOLD_WORDS words, between its tile and the
# view's sample pass) and K8 (raw rows with shadows: records of 16 floats a
# triangle, the raw sweep's e1, e2, tv, q, t_num and v0, and 4 a (light,
# triangle), the shadow test's hoisted pvec and 1/det, 2 pixels a thread),
# K1-raw (raw rows without shadows: K8's records of 16 floats a triangle
# with each view's own tv, q, t_num, no shadow sweep; 4 pixels a thread),
# K10 raytraced and cold (records of 12 floats: a = v0 - o with the
# validity, b and c; 2 pixels a thread), K1's 9-output mode on prep rows
# (csrc/render_none.cu: K1's records and gates, the resolve writing the
# nine outputs; 4 pixels a thread), K1-none on prep and K10 rows
# (csrc/render_none.cu: the same records, no cluster table or gate terms,
# every live slot swept; 4 and 2 pixels a thread) and K1's raster
# conventions on prep rows (K2, K2+K6: K1's records and gates, each pixel's
# t-space near bound in the sweep, the raster export; 2 pixels a thread,
# so 2 teams of 128 threads a group); the K1, K1-raw, 9-output,
# K10, K1-none and raster entries take at most 64 registers a thread, K8's
# 72. Where the views are fewer than the card's blocks of one group, the
# raster entry takes blocks of two groups (one fill for 4 teams; on
# raster_256w_png's 256 views 0.0333 ms against one group's 0.0395 and the
# parent's 0.0415, port_tools/index_plan_ab.py on an H100), and it takes
# the teams from _RASTER_MIN_VIEWS views (two groups beat the parent on
# every pass at 128 and 256 views and lost at 64). The other modes of K1
# (raster on raw and K10 rows, with mips or in the 9-output mode, K10 with
# shadows, the 9-output mode on raw and K10 rows), of K1-none (raw rows,
# shadows, raster, the 9-output mode) and K9 on either keep the parent
# design, render_body's 16x16 blocks: a plan of 0 groups. _INDEX_REGS: each
# team entry's registers a thread (index_entry_key; its most textured
# variant's, rounded up to the 8 the card allocates at a time), by which
# the plan counts the blocks a multiprocessor holds.
_INDEX_TILES_FOR_TWO = 64
_INDEX_GROUP_CHOICES = (1, 2)
_INDEX_RECORD_FLOATS = 12
_SHADOW_RECORD_FLOATS = 16
_MIP_HOLD_WORDS = 2
_INDEX_REGS = {"prep": 64, "raw": 64, "raw_shadows": 72, "raw_wt": 64, "nine": 64, "none": 64,
               "none_raw_wt": 64, "raster": 64}
_RASTER_MIN_VIEWS = 128
# The streamed walk's slack: the occlusion early exit's on squared distances
# (the JAX kernel's), the slab test's on t (a tie must not be culled).
_F_EXIT_SLACK = float(np.float32(0.998))
_F_SLAB_SLACK = float(np.float32(0.999))
# The binned route (K4): each 16x16 block sweeps two bands of 8 rows (warps
# 0-3 and 4-7), its row spans and triangle ranges at 8-row bands. Its bins
# are dense [W·C, bins, 1 + CC] i32, at most _BIN_ENTRIES entries (128 MB):
# the JAX package's dense-bin budget (render_core :4279), which also gates
# its auto-binning with at least 64 clusters a world and 4 TPU tiles.
_BAND = 8
_BIN_ENTRIES = 1 << 25
_AUTO_BIN_MIN_CLUSTERS = 64
_AUTO_BIN_MIN_TILES = 4
# The resident ordered visit (K3 on resident rows) from 4 clusters a world
# (the JAX package's MRT_ORDERED_MIN default, render_core :4291-4292); under
# accel="auto" culling needs 16 triangles and 2 clusters a world (:4042).
_ORDERED_MIN_CLUSTERS = 4
_AUTO_CULL_MIN_TRIS = 16
_AUTO_CULL_MIN_CLUSTERS = 2
# The JAX package's values: "none" sweeps every triangle (K1-none), "mxu"
# takes the batched kernel (K12).
ACCELS = ("auto", "none", "clusters", "binned", "mxu")


class Route(NamedTuple):
    """Where the world's rows live and how a block visits its clusters:
    ``streamed`` (rows past the resident budget, staged from device memory)
    or resident (in shared memory); ``visit`` ``"index"`` (every cluster in
    index order, K1), ``"ordered"`` (each view's front-to-back order with
    the occlusion early exit, K3), ``"binned"`` (the bin of the block's bin
    tile, K4), ``"none"`` (every triangle, no cluster table: K1-none) or
    ``"mxu"`` (the batched kernel K12, ``render_batched``)."""

    streamed: bool
    visit: str


def _cam_valid_col(n_lights: int) -> int:
    return _CAM_LIGHT0 + 6 * n_lights


def _n_cam_cols(n_lights: int) -> int:
    return -(-(_CAM_LIGHT0 + 6 * n_lights + 1) // 8) * 8


def is_textured(scene: SceneData) -> bool:
    """A texel pool beyond the 1×1 white texture (the JAX package's static
    ``shaded`` / ``tex_inkernel`` switch on the pool's shape)."""
    return int(scene.tex_data.shape[0]) > 1


def has_mips(scene: SceneData) -> bool:
    """Mip chains in the bake (the JAX package's ``mips_on``)."""
    return int(scene.tex_mip_offset.shape[1]) > 1


def is_streamed(state: SimState, scene: SceneData) -> bool:
    """The world's rows exceed the resident budget: the streamed route
    (``render_core``'s ``dma_tris``, :4265-4266)."""
    return _streamed_slots(state.max_instances * scene.tris_per_object)


def _streamed_slots(S: int) -> bool:
    return _TRI_ROWS * S * 4 > SMEM_TRI_BUDGET


def streamed_rule_bytes(n_clusters: int, cluster_size: int, n_lights: int) -> int:
    """The streamed ordered walk's rule in ``visit_route`` (a table past it
    takes the binned visit), and the shared memory of K11's ordered visit:
    two staged clusters of 16 rows, the cluster table, order and spans, the
    camera row. The ordered walk's own block is ``streamed_block_bytes``."""
    return 4 * (2 * _STAGE_ROWS * cluster_size + 11 * n_clusters
                + _n_cam_cols(n_lights))


class LaunchPlanError(ValueError):
    """Inputs a kernel's launch plan cannot take: a resident visit's or a
    streamed walk's (ordered or binned) block past the card's shared
    memory, or rows their copies cannot move in 16-byte pieces. Raised on
    every device: no route falls back."""


class StreamPlan(NamedTuple):
    """A streamed walk's launch (the ordered walk's ``streamed_plan``, the
    binned walk's ``binned_plan``): ``groups`` tile groups of 256 threads a
    block (0: one 16x16 block a tile, render_body's walk: the shadow
    sweeps'), ``parts`` blocks a view (each a share of the view's tiles,
    ``stream_tiles`` / ``binned_tiles``), ``smem_bytes`` of shared memory a
    block."""

    groups: int
    parts: int
    smem_bytes: int


def streamed_block_bytes(geo: str, n_clusters: int, cluster_size: int, n_lights: int,
                         groups: int, dmxu: bool = False) -> int:
    """Shared memory a block of the streamed ordered walk's tile groups
    takes (``stream_smem`` in ``csrc/render_streamed.cu``; K11's with
    ``dmxu``: its 10 stage rows, D, A, Q and t_num, on prep and raw rows);
    0 groups, render_body's 16x16 block (two stage buffers, the cluster
    table, the camera row, the order and the spans)."""
    if groups == 0:
        return 4 * (2 * _VISIT_GEO_ROWS[geo] * cluster_size + 11 * n_clusters
                    + _n_cam_cols(n_lights))
    rows = _DMXU_STAGE_ROWS if dmxu else _VISIT_GEO_ROWS[geo]
    return _STREAM_HEAD_BYTES + 4 * (groups * 2 * rows * cluster_size
                                     + _STREAM_WORDS * n_clusters + _n_cam_cols(n_lights))


def stream_parts(num_views: int, n_tiles: int, groups: int, slots: int) -> int:
    """Blocks a view: 1 where the views fill the ``slots`` (blocks the card
    holds at once), else as many as the slots take, as long as each block
    keeps ``groups`` tiles."""
    if num_views >= slots:
        return 1
    return max(1, min(slots // num_views, n_tiles // groups))


def stream_tiles(n_tiles: int, parts: int) -> list:
    """The tiles of each of a view's ``parts`` blocks, in the order the
    kernel takes them (``stream_body``: block b's are b, b + parts, ...)."""
    return [list(range(p, n_tiles, parts)) for p in range(parts)]


def streamed_plan(geo: str, n_clusters: int, cluster_size: int, n_lights: int,
                  num_views: int, height: int, width: int,
                  sm_count: int = _H100_SMS, *, dmxu: bool = False) -> StreamPlan:
    """The streamed ordered walk's launch on these inputs (K3 + K5, or K11
    with ``dmxu``; ``sm_count``: the card's multiprocessors, the H100's 132
    by default): four tile groups (no more than a view's tiles) or fewer,
    until the block fits 227 KB, and ``stream_parts``' blocks a view for the
    blocks the card holds at once (by registers, at most 64 a thread, and
    shared memory); the shadow sweeps one 16x16 block a tile (0 groups:
    render_body's walk, which is also K11's parent design). K11 takes the
    tile groups on prep and raw rows (its 10 stage rows: prep rows as
    packed, raw rows' D, A, Q, t_num formed in place of the staged v0, e1,
    e2), where both ran faster than on render_body's blocks
    (port_tools/dense_plan_ab.py). ``LaunchPlanError`` when even one group
    does not fit."""
    n_tiles = -(-height // _TILE) * -(-width // _TILE)
    if geo in _SHADOW_GEOS:
        # Two stage buffers, the cluster table, the camera row, the order and
        # the spans (render_resident.cu's streamed_smem; visit_route's rule
        # keeps them under 227 KB).
        groups = 0
        smem = streamed_block_bytes(geo, n_clusters, cluster_size, n_lights, 0)
    else:
        groups = min(_STREAM_GROUPS, n_tiles)
        while groups > 1 and streamed_block_bytes(geo, n_clusters, cluster_size, n_lights,
                                                  groups, dmxu) > _MAX_SMEM:
            groups -= 1
        smem = streamed_block_bytes(geo, n_clusters, cluster_size, n_lights, groups, dmxu)
    if smem > _MAX_SMEM:
        raise LaunchPlanError(f"the streamed ordered walk's block needs {smem} bytes of "
                              f"shared memory for {n_clusters} clusters of {cluster_size} "
                              f"{geo} slots (at most {_MAX_SMEM})")
    if groups == 0:
        return StreamPlan(0, 1, smem)
    per_sm = max(1, min(_SM_REGS // (_TILE ** 2 * groups * 64), _SM_SMEM // (smem + 1024)))
    return StreamPlan(groups, stream_parts(num_views, n_tiles, groups, sm_count * per_sm), smem)


def check_streamed_plan(rows: torch.Tensor, n_clusters: int, n_lights: int, geo: str,
                        num_views: int, height: int, width: int,
                        sm_count: int = _H100_SMS, *, dmxu: bool = False) -> StreamPlan:
    """The streamed ordered walk's launch plan for these rows (K11's with
    ``dmxu``; else ``LaunchPlanError``): its stage copies move whole cluster
    rows in 16-byte pieces (rows 16-byte aligned, S and the cluster size
    multiples of 4), a cluster's id fits its position word, and
    ``streamed_plan`` finds a block that fits."""
    S = int(rows.shape[2])
    size = S // n_clusters
    if S % 4 or size % 4 or rows.data_ptr() % _FILL_ALIGN:
        raise LaunchPlanError(f"the streamed ordered walk copies 16-byte pieces: S ({S}) and "
                              f"the cluster size ({size}) must be multiples of 4 and rows "
                              f"16-byte aligned (at {rows.data_ptr() % _FILL_ALIGN} past 16)")
    if n_clusters > _STREAM_MAX_CLUSTERS:
        raise LaunchPlanError(f"the streamed ordered walk takes at most "
                              f"{_STREAM_MAX_CLUSTERS} clusters a world, got {n_clusters}")
    return streamed_plan(geo, n_clusters, size, n_lights, num_views, height, width, sm_count,
                         dmxu=dmxu)


def binned_block_bytes(geo: str, cluster_size: int, n_lights: int, groups: int,
                       dmxu: bool = False) -> int:
    """Shared memory a block of the streamed binned walk takes: ``groups``
    tile groups on prep rows (``bin_smem`` in ``csrc/render_resident.cu``),
    K11's with ``dmxu``; 0 groups, render_body's 16x16 block (two stage
    buffers and the camera row)."""
    if groups == 0:
        return 4 * (2 * _BIN_STAGE_ROWS[geo] * cluster_size + _n_cam_cols(n_lights))
    rows = _DMXU_STAGE_ROWS if dmxu else _BIN_STAGE_ROWS[geo]
    return _STREAM_HEAD_BYTES + 4 * (groups * 2 * rows * cluster_size
                                     + groups * _STREAM_WORDS * _BIN_CHUNK
                                     + _n_cam_cols(n_lights))


def binned_tiles(height: int, width: int, bin_tile: int, parts: int) -> list:
    """The tiles (``ty · tiles_x + tx``) each of a view's ``parts`` blocks
    takes on the streamed binned walk, in the kernel's order (``bin_body``):
    block b's bin tiles are b, b + parts, ..., and each bin tile's 16x16
    tiles row-major within it, those past the image's edge left out."""
    tiles_x, tiles_y = -(-width // _TILE), -(-height // _TILE)
    sub = bin_tile // _TILE
    bins_x = -(-width // bin_tile)
    n_bins = bins_x * -(-height // bin_tile)
    shares = []
    for part in range(parts):
        share = []
        for bt in range(part, n_bins, parts):
            for s in range(sub * sub):
                tx = (bt % bins_x) * sub + s % sub
                ty = (bt // bins_x) * sub + s // sub
                if tx < tiles_x and ty < tiles_y:
                    share.append(ty * tiles_x + tx)
        shares.append(share)
    return shares


def binned_plan(geo: str, cluster_size: int, n_lights: int, num_views: int, height: int,
                width: int, bin_tile: int, dmxu: bool = False,
                sm_count: int = _H100_SMS) -> StreamPlan:
    """The streamed binned walk's launch on these inputs (K4, or K11 with
    ``dmxu``; ``sm_count``: the card's multiprocessors, the H100's 132 by
    default): on prep rows four tile groups (no more than a view's tiles)
    or fewer, until the block fits 227 KB, and ``stream_parts``' blocks a
    view for the blocks the card holds at once (by registers, at most 64 a
    thread, and shared memory), no more than the view's bin tiles; on raw
    and K10 rows, the shadow sweeps and prep rows whose clusters are too
    large for one group's buffers and records, render_body's 16x16 block a
    tile (0 groups: two stage buffers and the camera row)."""
    n_tiles = -(-height // _TILE) * -(-width // _TILE)
    n_bins = -(-height // bin_tile) * -(-width // bin_tile)
    blocks = StreamPlan(0, 1, binned_block_bytes(geo, cluster_size, n_lights, 0))
    if geo != "prep":
        return blocks
    groups = min(_STREAM_GROUPS, n_tiles)
    while groups > 1 and binned_block_bytes(geo, cluster_size, n_lights, groups,
                                            dmxu) > _MAX_SMEM:
        groups -= 1
    smem = binned_block_bytes(geo, cluster_size, n_lights, groups, dmxu)
    if smem > _MAX_SMEM:
        return blocks
    per_sm = max(1, min(_SM_REGS // (_TILE ** 2 * groups * 64), _SM_SMEM // (smem + 1024)))
    parts = min(stream_parts(num_views, n_tiles, groups, sm_count * per_sm), n_bins)
    return StreamPlan(groups, parts, smem)


def check_binned_plan(rows: torch.Tensor, n_clusters: int, n_lights: int, geo: str,
                      num_views: int, height: int, width: int, bin_tile: int,
                      dmxu: bool = False, sm_count: int = _H100_SMS) -> StreamPlan:
    """The streamed binned walk's launch plan for these rows (else
    ``LaunchPlanError``): its stage copies move whole cluster rows in
    16-byte pieces (rows 16-byte aligned, S and the cluster size multiples
    of 4) and a cluster's id fits its position word; ``binned_plan``'s
    plan."""
    S = int(rows.shape[2])
    size = S // n_clusters
    if S % 4 or size % 4 or rows.data_ptr() % _FILL_ALIGN:
        raise LaunchPlanError(f"the streamed binned walk copies 16-byte pieces: S ({S}) and "
                              f"the cluster size ({size}) must be multiples of 4 and rows "
                              f"16-byte aligned (at {rows.data_ptr() % _FILL_ALIGN} past 16)")
    if n_clusters > _STREAM_MAX_CLUSTERS:
        raise LaunchPlanError(f"the streamed binned walk takes at most "
                              f"{_STREAM_MAX_CLUSTERS} clusters a world, got {n_clusters}")
    return binned_plan(geo, size, n_lights, num_views, height, width, bin_tile, dmxu,
                       sm_count)


def resident_smem_bytes(geo: str, S: int, n_clusters: int, n_lights: int,
                        ordered: bool) -> int:
    """Shared memory a resident visit's block takes (K3, ``ordered``, or K4
    on resident rows; ``visit_smem`` in ``csrc/render_resident.cu``)."""
    return (_VISIT_HEAD_BYTES
            + 4 * (_VISIT_GEO_ROWS[geo] * S + _VISIT_CLUSTER_ROWS * n_clusters
                   + _n_cam_cols(n_lights))
            + (4 * n_clusters if ordered else 0))


def check_resident_plan(rows: torch.Tensor, n_clusters: int, n_lights: int, geo: str,
                        ordered: bool) -> None:
    """A resident visit's launch plan holds for these rows (else
    ``LaunchPlanError``): its block fits the card's 227 KB of shared
    memory, and its geometry fill's bulk copy finds rows 16-byte aligned and
    S a multiple of 4 (each row 16-byte aligned too)."""
    S = int(rows.shape[2])
    smem = resident_smem_bytes(geo, S, n_clusters, n_lights, ordered)
    if smem > _MAX_SMEM:
        raise LaunchPlanError(f"a resident visit's block needs {smem} bytes of shared memory "
                              f"for {S} {geo} slots and {n_clusters} clusters (at most "
                              f"{_MAX_SMEM})")
    if S % 4 or rows.data_ptr() % _FILL_ALIGN:
        raise LaunchPlanError(f"the resident visits' geometry fill copies 16-byte pieces: S "
                              f"({S}) must be a multiple of 4 and rows 16-byte aligned "
                              f"(at {rows.data_ptr() % _FILL_ALIGN} past 16)")


class IndexPlan(NamedTuple):
    """The index visit's launch (``index_plan``): ``groups`` groups of 4
    tile teams a block, a block a view, 4 pixels a thread (K8, K10 and
    K1-none on K10 rows: 2; 0 groups:
    the parent design, one 16x16 block a tile, one pixel a thread; K7 then
    takes two launches, the hand-off and ``shade_mip``), and ``smem_bytes``
    of shared memory a block."""

    groups: int
    smem_bytes: int


def index_block_bytes(S: int, n_clusters: int, n_lights: int, geo: str = "prep",
                      height: int = 0, width: int = 0, mip: bool = False) -> int:
    """Shared memory a block of the index visit's tile teams takes
    (``index_smem`` in ``csrc/render_resident.cu``): the head, the records
    (12 floats a triangle on prep and K10 rows; ``geo`` "raw", K1-raw: 16;
    "raw_shadows", K8: 16 floats a triangle and 4 a light and triangle),
    the cluster table and
    gate terms (none for K1-none: ``n_clusters`` 0), and the camera row;
    with ``mip`` (K7 folded, at ``height`` x ``width``) the TPU tiles'
    window keys (two words a tile of ``mips.tile_geometry``) and each
    pixel's held winner too."""
    rec = (_SHADOW_RECORD_FLOATS + 4 * n_lights if geo == "raw_shadows"
           else _SHADOW_RECORD_FLOATS if geo == "raw" else _INDEX_RECORD_FLOATS)
    smem = _VISIT_HEAD_BYTES + 4 * (rec * S + _VISIT_CLUSTER_ROWS * n_clusters
                                    + _n_cam_cols(n_lights))
    if mip:
        smem += 4 * (2 * mips.tile_geometry(height, width)[2] + _MIP_HOLD_WORDS * height * width)
    return smem


def index_takes(geo: str, texture=None, raster: bool = False, seeded: bool = False,
                culled: bool = True) -> bool:
    """Whether the index visit's tile teams take this mode: cold, and
    raytraced on prep rows untextured, with the ``"nearest"`` or
    ``"bilinear"`` filter (K1, K6), ``"mip"`` (K7 folded) or ``"nine"``
    (K1's 9-output mode), on raw rows with or without shadows (K8, K1-raw)
    or K10's rows untextured, nearest or bilinear; not ``culled``
    (K1-none), on prep and K10 rows untextured, nearest or bilinear;
    ``raster`` (K2, K2+K6), culled on prep rows untextured, nearest or
    bilinear."""
    if seeded:
        return False
    if raster:
        return geo == "prep" and culled and texture in (None,) + shade.FILTERS
    if geo == "prep":
        return texture in ((None, "mip", "nine") if culled else (None,)) + shade.FILTERS
    return ((geo == "raw_wt" or culled and geo in ("raw", "raw_shadows"))
            and texture in (None,) + shade.FILTERS)


def index_entry_key(geo: str, culled: bool = True, texture=None, raster: bool = False) -> str:
    """The team entry a mode of ``index_takes`` launches, as ``_INDEX_REGS``
    names it: the geo (K1, K1-raw, K8, K10), ``"nine"`` (K1's 9-output
    mode, ``csrc/render_none.cu``), ``"none"`` / ``"none_raw_wt"``
    (K1-none on prep or K10 rows, ``csrc/render_none.cu``) or ``"raster"``
    (K2 and K2+K6)."""
    if raster:
        return "raster"
    if culled:
        return "nine" if texture == "nine" else geo
    return "none" if geo == "prep" else f"none_{geo}"


def index_plan(geo: str, S: int, n_clusters: int, n_lights: int, num_views: int,
               height: int, width: int, texture=None, sm_count: int = _H100_SMS, *,
               raster: bool = False, seeded: bool = False, groups=None,
               culled: bool = True) -> IndexPlan:
    """The resident index order's launch on these inputs (``sm_count``: the
    card's multiprocessors, the H100's 132 by default; ``culled`` False:
    K1-none, no cluster table, ``n_clusters`` 0). The index visit's tile
    teams take the modes of ``index_takes`` (K1, K6, K7 folded as
    ``texture="mip"``, K1's 9-output mode as ``"nine"``, K1-raw, K8, K10;
    K1-none on prep and K10 rows; K2 and K2+K6, ``raster``): ``groups``
    of 4 teams a block (by default 1, or 2 where the view has at least
    _INDEX_TILES_FOR_TWO tiles; the raster entry's, 2 teams a group, also 2
    where the views are fewer than the card's blocks of one group), a block
    a view. By default the parent
    design (0 groups: its 16x16 block's rows, cluster table and camera row;
    K7's two launches) where the teams' block does not fit 227 KB, where
    the views are fewer than the blocks the card holds at once (by
    registers, _INDEX_REGS a thread, and shared memory; raster: fewer than
    _RASTER_MIN_VIEWS), and in every other
    mode (raster on raw and K10 rows, with mips or in the 9-output mode,
    K10 with shadows, the 9-output mode on raw and K10 rows
    and without a cluster table, K9's seed); with ``groups`` 0 too. A
    forced ``groups`` other than 0, 1 or 2, or one whose block does not
    fit, is ``LaunchPlanError``."""
    parent = IndexPlan(0, 4 * (_VISIT_GEO_ROWS[geo] * S + 8 * n_clusters
                               + _n_cam_cols(n_lights)))
    if not index_takes(geo, texture, raster, seeded, culled):
        return parent
    smem = index_block_bytes(S, n_clusters, n_lights, geo, height, width, texture == "mip")
    if groups is None:
        n_tiles = -(-height // _TILE) * -(-width // _TILE)
        regs = _INDEX_REGS[index_entry_key(geo, culled, texture, raster)]

        def slots(g):  # the blocks of g groups the card holds at once
            return sm_count * max(1, min(_SM_REGS // (_TILE ** 2 * g * regs),
                                         _SM_SMEM // (smem + 1024)))

        groups = 2 if n_tiles >= _INDEX_TILES_FOR_TWO or (
            raster and num_views < slots(1)) else 1
        few = num_views < (_RASTER_MIN_VIEWS if raster else slots(groups))
        return parent if smem > _MAX_SMEM or few else IndexPlan(groups, smem)
    if groups == 0:
        return parent
    if groups not in _INDEX_GROUP_CHOICES:
        raise LaunchPlanError(f"the index visit takes {_INDEX_GROUP_CHOICES} tile groups a "
                              f"block (0: the parent design), not {groups}")
    if smem > _MAX_SMEM:
        raise LaunchPlanError(f"the index visit ({geo}, {texture}) needs {smem} bytes of "
                              f"shared memory for {S} slots, {n_clusters} clusters and "
                              f"{n_lights} lights at {height}x{width} (at most {_MAX_SMEM})")
    return IndexPlan(groups, smem)


def check_index_plan(rows: torch.Tensor, n_clusters: int, n_lights: int, geo: str,
                     num_views: int, height: int, width: int, texture=None, *,
                     raster: bool = False, seeded: bool = False,
                     culled: bool = True) -> IndexPlan:
    """The index order's launch plan for these rows (``index_plan``, for the card that
    holds them, or an H100 for rows on the CPU; else ``LaunchPlanError``)."""
    sms = _sm_count(rows.device) if rows.is_cuda else _H100_SMS
    return index_plan(geo, int(rows.shape[2]), n_clusters, n_lights, num_views, height, width,
                      texture, sms, raster=raster, seeded=seeded, culled=culled)


def check_accel(accel: str) -> None:
    """``accel`` is one of ``ACCELS`` (else ``ValueError``)."""
    if accel not in ACCELS:
        raise ValueError(f"accel must be one of {ACCELS}, got {accel!r}")


def visit_route(state: SimState, scene: SceneData, height: int, width: int,
                accel: str = "auto") -> Route:
    """The kernel's route: ``render_core``'s ``use_clusters``, ``dma_tris``,
    ``binned`` and ``ordered`` (:4040-4044, :4265-4292), evaluated on the
    TPU tiling (``mips.tile_geometry``) so that the port visits as the JAX
    package does. ``accel="mxu"``: the batched kernel K12. ``"none"``, or
    ``"auto"`` with fewer than 16 triangles or 2 clusters a world: every
    triangle, no cluster table (K1-none; past the resident budget a
    ``ValueError``, :4882-4886). Binned: ``accel="binned"``, or ``"auto"``
    with at least 64 clusters a world, 4 TPU tiles and at most 2^25 dense
    bin entries; else ordered on the streamed route and on resident worlds
    of at least 4 clusters, else index order (K1). A streamed cluster table
    too large for the ordered walk's shared memory takes the binned visit
    too."""
    check_accel(accel)
    if accel == "mxu":
        return Route(False, "mxu")
    streamed = is_streamed(state, scene)
    S = state.max_instances * scene.tris_per_object
    n_cl = state.max_instances * int(scene.cl_valid.shape[1])
    culled = accel in ("clusters", "binned") or (
        accel == "auto" and S >= _AUTO_CULL_MIN_TRIS and n_cl >= _AUTO_CULL_MIN_CLUSTERS)
    if not culled:
        if streamed:
            raise ValueError(
                f"accel='none' with {S} triangles/world exceeds the SMEM budget; use "
                "accel='clusters' (streams triangles via DMA)")
        return Route(False, "none")
    size = scene.tris_per_object // int(scene.cl_valid.shape[1])
    views = int(state.camera_pos.shape[0]) * state.max_cameras
    n_tiles = mips.tile_geometry(height, width)[2]
    binned = accel == "binned" or (
        accel == "auto" and n_cl >= _AUTO_BIN_MIN_CLUSTERS
        and n_tiles >= _AUTO_BIN_MIN_TILES
        and views * n_tiles * (n_cl + 1) <= _BIN_ENTRIES)
    if streamed:
        if streamed_rule_bytes(n_cl, size, int(scene.light_dir.shape[0])) > _MAX_SMEM:
            binned = True
        return Route(True, "binned" if binned else "ordered")
    if binned:
        return Route(False, "binned")
    return Route(False, "ordered" if n_cl >= _ORDERED_MIN_CLUSTERS else "index")


def bin_tile_for(num_views: int, height: int, width: int, n_clusters: int) -> int:
    """The binned route's bin tile: the smallest square of 16·2^k pixels
    (blocks share the bin of the tile they lie in) whose dense bins
    ``[views, bins, 1 + CC]`` hold at most 2^25 entries (128 MB), the JAX
    package's dense-bin budget: 16 px for 32 views of the 3,136-cluster
    terrain at 128² and 256², 32 px at 512²."""
    tile = _TILE
    while (tile < max(height, width) and num_views * -(-height // tile)
           * -(-width // tile) * (1 + n_clusters) > _BIN_ENTRIES):
        tile *= 2
    return tile


def dmxu_route(state: SimState, scene: SceneData, height: int, width: int, *,
               accel: str = "auto", shadows: bool = False, watertight: bool = False,
               deferred_mxu: bool = False, rowskip: bool = True) -> tuple:
    """``(dmxu, rowskip)`` as the JAX ``render_core`` resolves them
    (:4296-4321, :4432): the deferred matmul sweep K11 only on the streamed
    route's deferred visits (binned, or ordered with 4 or more clusters a
    world), without shadows and without ``watertight``; elsewhere
    ``deferred_mxu`` is ignored, as the JAX package ignores
    ``MRT_DEFERRED_MXU`` there. The row skip where K11 runs and the TPU
    tiling has more than one tile across (``mips.tile_geometry``: 256 wide
    and up), unless ``rowskip`` is False (the JAX ``MRT_ROWSKIP=0``)."""
    if not deferred_mxu or shadows or watertight:
        return False, False
    route = visit_route(state, scene, height, width, accel)
    n_cl = state.max_instances * int(scene.cl_valid.shape[1])
    on = route.streamed and (route.visit == "binned" or n_cl >= _ORDERED_MIN_CLUSTERS)
    return on, on and rowskip and mips.tile_geometry(height, width)[1] > 1


def check_supported(state: SimState, scene: SceneData,
                    texture_filter: str = "nearest", accel: str = "auto") -> None:
    """Raise ``ValueError`` for a filter no route renders, and for the mip
    route's refusals (``render_core`` :4074-4096): mip-mapped pools with
    ``accel="mxu"`` or past 128 materials."""
    if is_textured(scene) and has_mips(scene):
        if texture_filter not in shade.MIP_FILTERS:
            raise ValueError(
                f"texture_filter must be one of {shade.MIP_FILTERS}, got "
                f"{texture_filter!r}"
            )
        if accel == "mxu" or int(scene.mat_color.shape[0]) > shade.TEX_MAX_MATERIALS:
            raise ValueError(
                "mip-mapped texture pools need the paged kernel path — "
                "accel='mxu' and >128 materials are unsupported with mipmaps "
                "(bake with mipmaps=False, or drop accel='mxu')"
            )
    elif is_textured(scene):
        if texture_filter == "trilinear":
            raise ValueError(
                "trilinear filtering needs mip chains — bake the scene with "
                "mipmaps=True (ManagerConfig.mipmaps)"
            )
        if texture_filter not in shade.FILTERS:
            raise ValueError(
                f"texture_filter must be one of {shade.FILTERS}, got "
                f"{texture_filter!r}"
            )


def output_mode(scene: SceneData, accel: str = "auto", shadows: bool = False) -> str:
    """What the kernel writes (``render_core``'s ``shaded``,
    ``shadows_epilogue``, ``tex_inkernel`` and ``tex_paged``, :4050-4096):
    ``"fused"`` (K1 and its variants shade in the kernel and write the
    final depth, segmask and rgb), ``"shaded"`` (K12 on an untextured
    scene: t, z, idx and rgb, masked by the epilogue) or ``"nine"`` (t, z,
    idx, mat, uv and the normal, shaded by the planar epilogue: textured
    pools past the in-kernel route's 16,384 texels or 128 materials without
    mip chains, textured scenes under ``accel="mxu"``, and shadows under
    ``accel="mxu"``, which K12 does not trace)."""
    shadows_epilogue = shadows and accel == "mxu"
    shaded = not is_textured(scene) and not shadows_epilogue
    if accel == "mxu":
        return "shaded" if shaded else "nine"
    if shaded or has_mips(scene):
        return "fused"
    fits = (int(scene.tex_data.shape[0]) <= shade.TEX_MAX_TEXELS
            and int(scene.mat_color.shape[0]) <= shade.TEX_MAX_MATERIALS)
    return "fused" if fits else "nine"


def check_seedable(accel: str) -> None:
    """K9's seed has no counterpart in the batched kernel (render_core
    :4154-4155)."""
    if accel == "mxu":
        raise ValueError("seed_t is not supported with accel='mxu'")


# --------------------------------------------------------------------- #
# Prologue (torch ops, the JAX expressions term for term)
# --------------------------------------------------------------------- #
def _pack_rows_planar(state: SimState, scene: SceneData,
                      cam_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Split-layout rows ``[W, 40, S]``
    (``raytrace_pallas._pack_rows_planar(split=True, cam_pos)``, :209).
    With the camera origin ``cam_pos [W, 3]`` (the prep layout), rows 0-9
    hold D = e2×e1, A = e2×tv, Q = tv×e1, t_num = e2·Q (tv = origin − v0);
    without it (the raw layout, :260-266), rows 0-8 hold v0, e1·valid and
    e2·valid, and row 9 the validity (the JAX 32-row pack's row 9,
    :281-286; the JAX split raw layout leaves it zero). Rows 16-35 hold
    the attributes (uv0, duv1, duv2, n0, dn1, dn2, material, premultiplied
    colour, texel density); the rest are zero. Invalid triangles have zero
    edges, so their determinant is 0 and the Möller–Trumbore sweeps reject
    them without the validity row; the watertight decision ANDs it in."""
    W, I = state.instance_obj.shape
    T = scene.tris_per_object
    S = I * T
    p = planar_soup_parts(state, scene)
    val = p["valid"]
    v0x, v0y, v0z = p["v0"]
    e1x, e1y, e1z = p["e1"]
    e2x, e2y, e2z = p["e2"]
    mat = p["mat"].long()
    col = [scene.mat_color[:, k][mat] for k in range(3)]
    zero = torch.zeros_like(val)

    if cam_pos is None:
        geo_rows = [
            v0x, v0y, v0z,
            e1x * val, e1y * val, e1z * val,
            e2x * val, e2y * val, e2z * val,
            val, zero, zero, zero, zero, zero, zero,
        ]
    else:
        ve1 = [e1x * val, e1y * val, e1z * val]
        ve2 = [e2x * val, e2y * val, e2z * val]
        o = [cam_pos[:, None, k:k + 1] for k in range(3)]  # [W, 1, 1]
        tvx = o[0] - v0x
        tvy = o[1] - v0y
        tvz = o[2] - v0z
        qx = tvy * ve1[2] - tvz * ve1[1]
        qy = tvz * ve1[0] - tvx * ve1[2]
        qz = tvx * ve1[1] - tvy * ve1[0]
        geo_rows = [
            ve2[1] * ve1[2] - ve2[2] * ve1[1],  # D
            ve2[2] * ve1[0] - ve2[0] * ve1[2],
            ve2[0] * ve1[1] - ve2[1] * ve1[0],
            ve2[1] * tvz - ve2[2] * tvy,  # A
            ve2[2] * tvx - ve2[0] * tvz,
            ve2[0] * tvy - ve2[1] * tvx,
            qx, qy, qz,  # Q
            ve2[0] * qx + ve2[1] * qy + ve2[2] * qz,  # t_num
            zero, zero, zero, zero, zero, zero,
        ]
    attr_rows = [
        p["uv0"][0], p["uv0"][1],
        p["duv1"][0], p["duv1"][1],
        p["duv2"][0], p["duv2"][1],
        p["n0"][0], p["n0"][1], p["n0"][2],
        p["dn1"][0], p["dn1"][1], p["dn1"][2],
        p["dn2"][0], p["dn2"][1], p["dn2"][2],
        p["mat"].to(torch.float32),
        col[0], col[1], col[2],
        p["density"],
    ]
    rows = geo_rows + attr_rows + [zero, zero, zero, zero]
    out = torch.stack([r.expand(val.shape) for r in rows], dim=1)
    return out.reshape(W, len(rows), S)


def _pack_cams(
    state: SimState,
    scene: SceneData,
    width: int,
    height: int,
    eff_fov: torch.Tensor,  # f32 [W, C] degrees
    eff_near: torch.Tensor,  # f32 [W, C]
    far_t: torch.Tensor,  # f32 [W, C] t-space search window upper bound
    far_z: torch.Tensor,  # f32 [W, C] z-space far clip (raster)
) -> torch.Tensor:
    """Camera basis + clip + light scalars ``[W·C, _n_cam_cols(L)]``
    (``raytrace_pallas._pack_cams``, :292)."""
    W, C = state.camera_pos.shape[:2]
    L = int(scene.light_dir.shape[0])
    dev = state.device
    rot = state.camera_rot
    basis = torch.eye(3, dtype=torch.float32, device=dev)
    right = quat_rotate(rot, basis[0])
    fwd = quat_rotate(rot, basis[1])
    up = quat_rotate(rot, basis[2])
    deg2rad = float(np.float32(np.pi / 180))
    tan_y = torch.tan(eff_fov * deg2rad * 0.5)[..., None]  # [W, C, 1]
    tan_x = tan_y * (width / height)
    clip = torch.stack([eff_near, far_t, far_z], dim=-1)  # [W, C, 3]
    lights_flat = torch.cat([light_directions(scene), scene.light_color],
                            dim=-1).reshape(-1)
    light = lights_flat.expand(W, C, 6 * L)
    n_cols = _n_cam_cols(L)
    camv = state.camera_valid[:, :, None].to(torch.float32)
    pad = torch.zeros(
        (W, C, n_cols - _CAM_LIGHT0 - 6 * L - 1), dtype=torch.float32, device=dev
    )
    cams = torch.cat(
        [state.camera_pos, right, fwd, up, tan_x, tan_y, clip, light, camv, pad],
        dim=-1,
    )
    return cams.reshape(W * C, n_cols)


def world_clusters(state: SimState, scene: SceneData):
    """Per-step TLAS refit (``raytrace_pallas.world_clusters``, :334):
    object-space cluster AABBs → world space, per instance. Returns
    (cl_lo [W, CC, 3], cl_hi [W, CC, 3], cl_valid [W, CC], cl_count
    [W, CC]) with CC = max_instances · clusters_per_object, in the rows'
    triangle order (instance-major, cluster-minor)."""
    O, NC, _ = scene.cl_min.shape
    W, I = state.instance_obj.shape
    obj = state.instance_obj.long()
    picks = torch.tensor(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=torch.float32, device=state.device,
    )  # [8, 3]
    lo = scene.cl_min[obj]  # [W, I, NC, 3]
    hi = scene.cl_max[obj]
    corners = lo[..., None, :] * (1 - picks) + hi[..., None, :] * picks
    pos = state.instance_pos[:, :, None, None, :]
    rot = state.instance_rot[:, :, None, None, :]
    scale = state.instance_scale[:, :, None, None, :]
    cw = quat_rotate(rot, scale * corners) + pos
    cl_lo = cw.amin(dim=3).reshape(W, I * NC, 3)
    cl_hi = cw.amax(dim=3).reshape(W, I * NC, 3)
    valid = (
        scene.cl_valid[obj] * state.instance_valid[:, :, None]
    ).reshape(W, I * NC)
    count = (
        scene.cl_count[obj].to(torch.float32) * state.instance_valid[:, :, None]
    ).reshape(W, I * NC)
    return cl_lo, cl_hi, valid, count


def _pack_clusters(cl_lo, cl_hi, cl_valid, cl_count) -> torch.Tensor:
    """→ ``[W, 8, CC]``: rows lo.xyz, hi.xyz, valid, count (:809)."""
    rows = [
        cl_lo[..., 0], cl_lo[..., 1], cl_lo[..., 2],
        cl_hi[..., 0], cl_hi[..., 1], cl_hi[..., 2],
        cl_valid,
        cl_count,
    ]
    return torch.stack(rows, dim=1)


def _cluster_approach_dist2(cl_lo, cl_hi, cam_pos) -> torch.Tensor:
    """Squared closest-approach distance camera → cluster AABB ``[W, C, CC]``
    (``raytrace_pallas._cluster_approach_dist2``, :363): a lower bound on
    any hit t inside the cluster (unit ray directions), summed x, y, z in
    that order."""
    o = cam_pos[:, :, None, :]  # [W, C, 1, 3]
    near = torch.minimum(torch.maximum(o, cl_lo[:, None]), cl_hi[:, None])
    d = near - o
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def camera_cluster_order(cl_lo, cl_hi, cl_valid, cam_pos) -> torch.Tensor:
    """Front-to-back cluster visit order per view, int32 ``[W·C, CC]``
    (``raytrace_pallas.camera_cluster_order``, :378): a stable ascending
    sort of the approach distance, invalid clusters keyed ``inf`` (last).
    The JAX package's ``win_div`` key (``MRT_WIN_SORT``, off by default)
    groups clusters by TPU DMA window and has no counterpart here."""
    dist = _cluster_approach_dist2(cl_lo, cl_hi, cam_pos)
    dist = torch.where(cl_valid[:, None, :] > 0, dist, torch.inf)
    order = torch.argsort(dist, dim=-1, stable=True).to(torch.int32)
    W, C, CC = order.shape
    return order.reshape(W * C, CC)


def _tan_half_fov(eff_fov):
    return torch.tan(eff_fov * float(np.float32(np.pi / 180)) * 0.5)


def _corner_dots(cl_lo, cl_hi, state: SimState, axes) -> list:
    """Each cluster AABB corner relative to each camera, dotted with the
    camera's local axes ``axes`` (0 right, 1 forward, 2 up): a list of
    ``[W, C, CC, 8]`` tensors, the three terms summed x, y, z in that order
    (the JAX einsums on the CPU)."""
    dev = cl_lo.device
    picks = torch.tensor(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=torch.float32, device=dev,
    )
    corners = cl_lo[:, :, None, :] * (1 - picks) + cl_hi[:, :, None, :] * picks
    rel = corners[:, None] - state.camera_pos[:, :, None, None, :]  # [W, C, CC, 8, 3]
    basis = torch.eye(3, dtype=torch.float32, device=dev)
    out = []
    for k in axes:
        a = quat_rotate(state.camera_rot, basis[k])[:, :, None, None, :]
        out.append((rel[..., 0] * a[..., 0] + rel[..., 1] * a[..., 1])
                   + rel[..., 2] * a[..., 2])
    return out


def _edge_slopes(edges, size: int, sign: float, dev):
    """The frustum slope factor of each pixel edge (row or column
    coordinate ``p``): ``sign · (1 - 2 (p + 0.5) / size)``, a Python double
    rounded once to f32, as the JAX package's weakly typed scalars are."""
    return torch.tensor([sign * (1.0 - 2.0 * (p + 0.5) / size) for p in edges],
                        dtype=torch.float32, device=dev)


def _plane_bands(d_up, y_f, tan, size: int, step: int, n: int):
    """Frustum-plane membership of the AABBs (corner dots ``d_up`` along the
    band axis and ``y_f`` along the view axis, ``[W, C, CC, 8]``) in ``n``
    bands of ``step`` pixels, padded by 2 px: ``[W, C, CC, n]``, False where
    every corner lies beyond the band's first edge (its first pixel - 2) or
    wholly past its last (its last pixel + 2); the test
    ``d - s·y_f`` against 0 of ``band_cluster_bins`` (:477-528)."""
    dev = y_f.device
    s_lo = _edge_slopes([k * step - 2.0 for k in range(n)], size, 1.0, dev) * tan[..., None]
    s_hi = _edge_slopes([(k + 1) * step + 1.0 for k in range(n)], size, 1.0, dev) * tan[..., None]
    before = (d_up[..., None] - s_lo * y_f[..., None]).amin(-2) > 0.0
    past = (d_up[..., None] - s_hi * y_f[..., None]).amax(-2) < 0.0
    return ~before & ~past


def camera_cluster_rowspans(cl_lo, cl_hi, cl_valid, state: SimState, eff_fov,
                            height: int, g_rows: int = 0) -> torch.Tensor:
    """Per-(view, cluster) conservative image pixel-row span, int32
    ``[W·C, 2, CC]`` (``raytrace_pallas.camera_cluster_rowspans``, :728):
    the AABB corners projected through the camera, padded by 2 px (the
    full height for a cluster with a corner behind the camera), and with
    ``g_rows`` > 0 intersected with the hull of the ``g_rows``-row bands
    the AABB's frustum-plane tests can touch (``MRT_PLANE_BINS``, on by
    default there). A span with lo > hi touches no row. The three-term
    dots sum x, y, z in that order, as the JAX einsums do on the CPU."""
    W, CC = cl_valid.shape
    C = state.camera_pos.shape[1]
    dev = cl_lo.device
    y_f, z_u = _corner_dots(cl_lo, cl_hi, state, (1, 2))
    tan_y = _tan_half_fov(eff_fov)[:, :, None, None]
    behind_any = (y_f <= _F_EPS_BEHIND).any(-1)
    safe_yf = torch.clamp_min(y_f, _F_EPS_BEHIND)
    py = (1.0 - z_u / (safe_yf * tan_y)) * (height * 0.5) - 0.5
    ymin = torch.where(behind_any, 0.0, py.amin(-1) - 2.0)
    ymax = torch.where(behind_any, float(height), py.amax(-1) + 2.0)

    def to_row(x):  # floor → int32, saturating (as XLA's conversion does)
        return torch.floor(x).clamp(-2.0 ** 30, 2.0 ** 30).to(torch.int32)

    row_lo = to_row(ymin).clamp(0, height - 1)
    row_hi = (to_row(ymax) + 1).clamp(0, height - 1)
    if g_rows > 0:
        n_bands = -(-height // g_rows)

        # Band k: the AABB lies wholly above its top edge (k·g - 2 px) or
        # wholly below its bottom edge ((k+1)·g + 1 px); [W, C, CC, K].
        ks = torch.arange(n_bands, dtype=torch.int32, device=dev)
        touch = _plane_bands(z_u, y_f, tan_y, height, g_rows, n_bands)
        first = torch.where(touch, ks, n_bands).amin(-1)
        last = torch.where(touch, ks, -1).amax(-1)
        p_lo = torch.clamp_max(first * g_rows, height - 1)
        p_hi = torch.clamp(last * g_rows + g_rows - 1, -1, height - 1)
        row_lo = torch.maximum(row_lo, p_lo)
        row_hi = torch.minimum(row_hi, p_hi)
    spans = torch.stack([row_lo, row_hi], dim=2).to(torch.int32)  # [W, C, 2, CC]
    return spans.reshape(W * C, 2, CC)


def band_cluster_bins(cl_lo, cl_hi, cl_valid, state: SimState, eff_fov, height: int,
                      width: int, n_tiles: int, tiles_x: int, tile_sub: int,
                      tile_cols: int, order=None) -> torch.Tensor:
    """Per-(view, tile) cluster bins, int32 ``[W·C, n_tiles, 1 + CC]``
    (``raytrace_pallas.band_cluster_bins``, :407-610, its 2D branch with the
    frustum-plane tests): tile r = ty · tiles_x + tx owns rows
    [ty·tile_sub, (ty+1)·tile_sub) and columns [tx·tile_cols,
    (tx+1)·tile_cols); a valid cluster that is on screen and not wholly
    behind the camera is in the tile's bin unless its AABB lies wholly
    outside one of the tile's four frustum planes, padded by 2 px. Entry 0
    is the count, entries 1..count the members front to back: the view's
    ``order`` (``camera_cluster_order``, computed when None) with the
    non-members taken out, a stable partition, so the count and the first
    count ids are the JAX package's ``argsort(where(member, dist, inf))``;
    the entries past the count are the rest of the order."""
    W, CC = cl_valid.shape
    C = state.camera_pos.shape[1]
    dev = cl_lo.device
    x_r, y_f, z_u = _corner_dots(cl_lo, cl_hi, state, (0, 1, 2))
    tan_y = _tan_half_fov(eff_fov)[:, :, None, None]
    behind = y_f <= _F_EPS_BEHIND
    behind_any, behind_all = behind.any(-1), behind.all(-1)
    straddle = behind_any & ~behind_all
    py = (1.0 - z_u / (torch.clamp_min(y_f, _F_EPS_BEHIND) * tan_y)) * (height * 0.5) - 0.5
    ymin = torch.where(straddle, 0.0, py.amin(-1) - 2.0)
    ymax = torch.where(straddle, float(height), py.amax(-1) + 2.0)
    ok = (ymax >= 0.0) & (ymin < float(height)) & ~behind_all & (cl_valid[:, None, :] > 0)
    tiles_y = n_tiles // tiles_x
    mem_y = _plane_bands(z_u, y_f, tan_y, height, tile_sub, tiles_y) & ok[..., None]
    # Columns: s(px) = (2 (px + 0.5) / width - 1) · tan_x; a tile drops the
    # AABB when every corner lies left of its left edge - 2 px or right of
    # its right edge + 2 px.
    tan_x = tan_y * (width / height)
    s_l = _edge_slopes([tx * tile_cols - 2.0 for tx in range(tiles_x)], width, -1.0, dev)
    s_r = _edge_slopes([(tx + 1) * tile_cols + 1.0 for tx in range(tiles_x)], width, -1.0, dev)
    left = (x_r[..., None] - (s_l * tan_x[..., None]) * y_f[..., None]).amax(-2) < 0.0
    right = (x_r[..., None] - (s_r * tan_x[..., None]) * y_f[..., None]).amin(-2) > 0.0
    mem_x = ~left & ~right  # [W, C, CC, TX]
    if order is None:
        order = camera_cluster_order(cl_lo, cl_hi, cl_valid, state.camera_pos)
    V = W * C
    idx = order.long()[:, None, :]  # [V, 1, CC]
    in_y = mem_y.reshape(V, CC, tiles_y).transpose(1, 2).gather(2, idx.expand(V, tiles_y, CC))
    in_x = mem_x.reshape(V, CC, tiles_x).transpose(1, 2).gather(2, idx.expand(V, tiles_x, CC))
    member = (in_y[:, :, None, :] & in_x[:, None, :, :]).reshape(V, n_tiles, CC)
    # The stable partition: a member goes to its rank among the members, a
    # non-member after all of them at its rank among the rest.
    rank = torch.cumsum(member, dim=-1, dtype=torch.int32)  # members up to here
    count = rank[..., -1:]
    ks = torch.arange(1, CC + 1, dtype=torch.int32, device=dev)
    dest = torch.where(member, rank - 1, count + ks - rank - 1).long()
    bins = torch.empty((V, n_tiles, 1 + CC), dtype=torch.int32, device=dev)
    bins[..., :1] = count
    bins[..., 1:].scatter_(2, dest, order[:, None, :].expand(V, n_tiles, CC))
    return bins


def cluster_row_sort(v0, e1, e2, valid, state: SimState, eff_fov, height: int,
                     cluster_size: int, g_rows: int, n_bands: int):
    """Per-step within-cluster triangle sort by projected image row and the
    per-(cluster, band) triangle ranges (``raytrace_pallas.cluster_row_sort``,
    :612-689), from the world soup's planes (``v0``, ``e1``, ``e2``: three
    ``[W, S]`` planes each, ``valid [W, S]``; ``planar_soup_parts``) and
    each world's first camera. Returns ``(perm [W, S], lo, hi [W, CC,
    n_bands])`` int32: ``perm`` maps a sorted lane to the original triangle
    index, and band b of cluster c needs only its sorted-local triangles
    [lo, hi): triangles sorted (stably) by their projected first row (the 2 px
    pad, the full height for one with a vertex at or behind the camera
    plane, invalid ones last and in no band); hi counts those that start
    above the band's end, lo those before which every triangle ends above
    its start (a running maximum)."""
    W, S = valid.shape
    n_cl = S // cluster_size
    dev = valid.device
    rot = state.camera_rot[:, 0]  # [W, 4]
    basis = torch.eye(3, dtype=torch.float32, device=dev)
    fwd = quat_rotate(rot, basis[1])
    up = quat_rotate(rot, basis[2])
    cam = state.camera_pos[:, 0]  # [W, 3]
    tan_y = _tan_half_fov(eff_fov[:, 0])[:, None]  # [W, 1]

    def dot(rel, axis):
        # The JAX einsum's order on the CPU, fused multiply-adds:
        # fma(z, az, fma(y, ay, x ax)), each in f64 (where the product of two
        # f32 is exact) rounded to f32: one fma's result unless the f64 sum
        # falls on an f32 rounding midpoint.
        d = rel[0] * axis[:, 0:1]
        for k in (1, 2):
            d = (rel[k].double() * axis[:, k:k + 1].double() + d.double()).float()
        return d

    def rows_of(p):  # three [W, S] planes → (py, y_f)
        rel = [p[k] - cam[:, k:k + 1] for k in range(3)]
        y_f = dot(rel, fwd)
        z_u = dot(rel, up)
        py = (1.0 - z_u / (torch.clamp_min(y_f, _F_EPS_BEHIND) * tan_y)) * (height * 0.5) - 0.5
        return py, y_f

    py0, yf0 = rows_of(v0)
    py1, yf1 = rows_of([v0[k] + e1[k] for k in range(3)])
    py2, yf2 = rows_of([v0[k] + e2[k] for k in range(3)])
    straddle = (yf0 <= _F_EPS_BEHIND) | (yf1 <= _F_EPS_BEHIND) | (yf2 <= _F_EPS_BEHIND)
    pmin = torch.minimum(torch.minimum(py0, py1), py2) - 2.0
    pmax = torch.maximum(torch.maximum(py0, py1), py2) + 2.0
    big = float(height * 4 + 8)
    pmin = torch.where(straddle, -big, pmin)
    pmax = torch.where(straddle, big, pmax)
    ok = valid > 0
    pmin = torch.where(ok, pmin, torch.inf)
    pmax = torch.where(ok, pmax, -torch.inf)
    key = pmin.reshape(W, n_cl, cluster_size)
    local = torch.argsort(key, dim=-1, stable=True)
    base = torch.arange(n_cl, device=dev)[None, :, None] * cluster_size
    perm = (local + base).reshape(W, S).to(torch.int32)
    m_sorted = key.gather(2, local)
    mx_run = torch.cummax(pmax.reshape(W, n_cl, cluster_size).gather(2, local), dim=2).values
    # Both are ascending along a cluster: a band's counts are searches.
    edges = torch.arange(n_bands + 1, device=dev, dtype=torch.float32) * g_rows
    edges = edges.expand(W, n_cl, n_bands + 1).contiguous()
    lo = torch.searchsorted(mx_run.contiguous(), edges[..., :-1].contiguous()).to(torch.int32)
    hi = torch.searchsorted(m_sorted.contiguous(), edges[..., 1:].contiguous()).to(torch.int32)
    return perm, torch.minimum(lo, hi), hi


def row_sorted(rows: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The binned route's rows (:4504-4522), in place: geometry rows 0-9 of
    each world gathered by ``perm`` (cluster_row_sort), row 10 the original
    triangle index of each lane as f32 (exact: S ≤ 2^24); the attribute rows
    keep the original order. A torch gather after K13 rather than a
    permutation inside it: K13 stays one layout for both routes, and the
    gather moves 10 rows once a step."""
    W, _, S = rows.shape
    if S > 1 << 24:
        raise ValueError(f"{S} triangles a world: row 10 holds indices exactly up to 2^24")
    idx = perm.long()[:, None, :].expand(W, _N_PREP_ROWS, S)
    rows[:, :_N_PREP_ROWS] = rows[:, :_N_PREP_ROWS].gather(2, idx)
    rows[:, _N_PREP_ROWS] = perm.to(torch.float32)
    return rows


def _index_order_rows(rows: torch.Tensor) -> torch.Tensor:
    """Row-sorted rows (``row_sorted``) back in triangle order: geometry
    rows 0-9 scattered to the index in row 10, row 10 zero again."""
    W, _, S = rows.shape
    gi = rows[:, _N_PREP_ROWS].long()[:, None, :].expand(W, _N_PREP_ROWS, S)
    geo = torch.empty_like(rows[:, :_N_PREP_ROWS]).scatter_(2, gi, rows[:, :_N_PREP_ROWS])
    pad = torch.zeros_like(rows[:, :1])
    return torch.cat([geo, pad, rows[:, _N_PREP_ROWS + 1:]], dim=1)


def pack_inputs(
    state: SimState,
    scene: SceneData,
    *,
    height: int,
    width: int,
    near: float = 0.1,
    far: float = 1000.0,
    fov_y_degrees: float = 90.0,
    raster: bool = False,
    texture_filter: str = "nearest",
    shadows: bool = False,
    watertight: bool = False,
    accel: str = "auto",
    deferred_mxu: bool = False,
    rowskip: bool = True,
) -> dict:
    """The whole prologue: the kernel's tensors and launch parameters, as
    keyword arguments of ``render_resident`` / ``render_resident_plain``.
    ``raster`` selects the raster conventions (``near`` is then the
    camera-plane znear). The rows take the prep layout on one-camera scenes
    without shadows or ``watertight`` and the raw layout otherwise
    (``render_core`` :4342-4347, :4425-4436); ``geo`` names the kernel's
    sweep: ``"prep"``, ``"raw"`` or, with ``shadows``, ``"raw_shadows"``,
    and under ``watertight`` ``"raw_wt"`` or ``"raw_wt_shadows"``. The
    ordered visit (``visit_route``) takes ``order`` (each view's cluster
    order), the binned visit ``bins`` (``band_cluster_bins`` at the bin tile
    ``bin_tile``, ``bin_tile_for``'s). On the streamed route the ordered
    visit takes ``spans`` too (row spans at 16-row bands), and the binned
    visit (K4) ``spans`` at 8-row bands and, on prep rows, ``ranges``
    ``[W, CC, bands, 2]`` (each cluster's sorted-local triangle range (lo,
    hi) per 8-row band) with the rows row-sorted (``row_sorted``); the
    resident visits take no spans, sort and ranges (the JAX package builds
    them for its deferred sweep only, :4373-4378, :4402-4410). Unused
    entries are None.

    The non-culled visit (``accel="none"``, or ``"auto"`` on tiny worlds:
    K1-none) takes no cluster table (``clusters`` None). Where the scene
    takes the 9-output route (``output_mode``), ``texture`` is ``"nine"``,
    on whatever visit the route takes (with that visit's inputs, the
    streamed binned visit's row-sorted rows and ranges included), and the
    rows sweep without the in-kernel shadow rays (``geo`` ``"raw"`` or
    ``"raw_wt"`` under ``shadows``: the epilogue traces them).
    ``accel="mxu"`` returns ``render_batched``'s inputs instead: K13's raw
    rows and the camera rows, with ``nine`` the 9-output mode; ``watertight``
    raises there, as in the JAX package (:4426-4431).

    ``deferred_mxu`` asks for K11 (``dmxu_route``): where it applies,
    ``dmxu`` is True and the binned visit keeps its rows unsorted (no
    ``ranges``); ``rowskip`` (False: the JAX ``MRT_ROWSKIP=0``, for the A/B)
    turns K11's per-row gate off."""
    check_supported(state, scene, texture_filter, accel)
    route = visit_route(state, scene, height, width, accel)
    mode = output_mode(scene, accel, shadows)
    if route.visit == "mxu" and watertight:
        raise ValueError(
            "watertight=True is not supported with accel='mxu' (the batched kernel "
            "has no per-pixel shear sweep) — use accel='auto' or the jnp path")
    # Effective per-camera view parameters (0 = inherit the call defaults).
    eff_fov = torch.where(state.camera_fov > 0, state.camera_fov, fov_y_degrees)
    eff_near = torch.where(state.camera_znear > 0, state.camera_znear, near)
    far_z = torch.full_like(eff_near, far)
    if raster:
        # The t search window must cover z < far for the worst-case corner
        # ray (render_core :4030-4034).
        deg2rad = float(np.float32(np.pi / 180))
        tan_y = torch.tan(eff_fov * deg2rad * 0.5)
        tan_x = tan_y * (width / height)
        far_t = far * torch.sqrt(1.0 + tan_x * tan_x + tan_y * tan_y)
    else:
        far_t = far_z
    prep = (state.max_cameras == 1 and not shadows and not watertight
            and route.visit != "mxu")
    geo = "prep"
    if not prep:
        in_kernel_shadows = shadows and mode == "fused"
        geo = ("raw_wt" if watertight else "raw") + ("_shadows" if in_kernel_shadows else "")
    dmxu, rowskip = dmxu_route(state, scene, height, width, accel=accel, shadows=shadows,
                               watertight=watertight, deferred_mxu=deferred_mxu,
                               rowskip=rowskip)
    rows = pack_cuda.pack_rows(state, scene,
                               state.camera_pos[:, 0, :] if prep else None)
    cams = _pack_cams(state, scene, width, height, eff_fov, eff_near, far_t, far_z)
    if route.visit == "mxu":
        return dict(rows=rows, cams=cams.contiguous(), num_cams=state.max_cameras,
                    n_lights=int(scene.light_dir.shape[0]), height=height, width=width,
                    raster=raster, nine=mode == "nine")
    clusters = order = spans = bins = ranges = bin_tile = None
    if route.visit != "none":
        cl_lo, cl_hi, cl_valid, cl_count = world_clusters(state, scene)
        clusters = _pack_clusters(cl_lo, cl_hi, cl_valid, cl_count).contiguous()
    if route.visit not in ("index", "none"):
        order = camera_cluster_order(cl_lo, cl_hi, cl_valid, state.camera_pos)
    if route.streamed:
        spans = camera_cluster_rowspans(cl_lo, cl_hi, cl_valid, state, eff_fov, height,
                                        g_rows=_BAND if route.visit == "binned" else _TILE)
    if route.visit == "binned":
        views, CC = order.shape
        bin_tile = bin_tile_for(views, height, width, CC)
        tx, ty = -(-width // bin_tile), -(-height // bin_tile)
        bins = band_cluster_bins(cl_lo, cl_hi, cl_valid, state, eff_fov, height, width,
                                 tx * ty, tx, bin_tile, bin_tile, order=order)
        order = None
        if route.streamed and geo == "prep" and not dmxu:
            p = planar_soup_parts(state, scene, what="geo")
            W = p["valid"].shape[0]
            planes = [tuple(x.reshape(W, -1) for x in p[k]) for k in ("v0", "e1", "e2")]
            perm, lo, hi = cluster_row_sort(
                *planes, p["valid"].reshape(W, -1), state, eff_fov, height,
                scene.tris_per_object // int(scene.cl_valid.shape[1]), _BAND,
                -(-height // _BAND))
            rows = row_sorted(rows, perm)
            ranges = torch.stack([lo, hi], dim=-1).contiguous()
    texture = mats = pool = fb_rows = None
    if mode == "nine":
        texture = "nine"
    elif is_textured(scene):
        texture = texture_filter
        pool = shade.texel_pool(scene)
        if has_mips(scene):
            mats = shade.mip_table(scene)
            fb_rows = scene.fb_rows
        else:
            mats = shade.material_table(scene)
    return dict(
        rows=rows,
        clusters=clusters,
        cams=cams.contiguous(),
        num_cams=state.max_cameras,
        n_lights=int(scene.light_dir.shape[0]),
        height=height,
        width=width,
        seg_div=scene.tris_per_object,
        raster=raster,
        texture=texture,
        mats=mats,
        pool=pool,
        geo=geo,
        fb_rows=fb_rows,
        order=order,
        spans=spans,
        bins=bins,
        ranges=ranges,
        bin_tile=bin_tile,
        dmxu=dmxu,
        rowskip=rowskip,
    )


# --------------------------------------------------------------------- #
# Kernel K1 (K1-raw, K8, K2, K6, K7's first launch) and its plain version
# --------------------------------------------------------------------- #
INDEX = Route(False, "index")
NONE = Route(False, "none")
# Each route's kernel name (the variants' prefix) and the csrc/ library that
# holds its entries.
_ROUTE_NAMES = {
    INDEX: "render_resident",
    NONE: "render_none",
    Route(False, "ordered"): "render_resident_ordered",
    Route(False, "binned"): "render_resident_binned",
    Route(True, "ordered"): "render_streamed",
    Route(True, "binned"): "render_binned",
}
_ROUTE_LIBRARIES = {INDEX: "render_resident", NONE: "render_none",
                    Route(True, "ordered"): "render_streamed",
                    Route(True, "binned"): "render_binned",
                    Route(False, "ordered"): "render_resident_ordered",
                    Route(False, "binned"): "render_resident_binned"}


def library_of(route: Route, seeded: bool, texture=None, dmxu: bool = False,
               geo: str = "prep") -> str:
    """The csrc/ library of a launch on its plan: the streamed binned walk's
    tile groups (K4 and K11 on prep rows, cold and seeded) build in
    ``render_binned.cu``, its other rows' entries on render_body's 16x16
    blocks in ``render_binned_blocks.cu`` (K4 cold), ``render_seeded.cu``
    (K4 seeded, with K9 on K1) and ``render_dmxu.cu`` (K11, with K11 on the
    ordered walk, cold and seeded); the ordered visits' seeded entries (K3 +
    K5, K3 on resident rows) in their own sources; K1-none and K1's
    9-output mode (cold and seeded) in ``render_none.cu``. The other
    visits' 9-output entries are their cold and seeded libraries'."""
    if route == Route(True, "binned"):
        if geo == "prep":
            return "render_binned"
        return "render_dmxu" if dmxu else "render_seeded" if seeded else "render_binned_blocks"
    if dmxu:
        return "render_dmxu"
    if texture == "nine" and route == INDEX:
        return "render_none"
    if seeded and route == INDEX:
        return "render_seeded"
    return _ROUTE_LIBRARIES[route]


def route_of(order=None, spans=None, bins=None, culled: bool = True) -> Route:
    """The route a launch on these visit inputs takes: streamed with row
    spans (``pack_inputs`` gives them past the resident budget), resident
    without; ordered with an order, binned with bins, without a cluster
    table (``culled`` False) every triangle (K1-none), else index order."""
    if not culled:
        return NONE
    visit = "binned" if bins is not None else "ordered" if order is not None else "index"
    return Route(spans is not None, visit)


def variant_name(raster: bool, texture, geo: str = "prep", route: Route = INDEX,
                 seeded: bool = False, dmxu: bool = False) -> str:
    """The name of one instantiation of the render kernel: the route's
    (``render_resident``, K1; ``render_resident_ordered`` / ``_binned``, K3
    and K4 on resident rows; ``render_streamed``, K3 + K5;
    ``render_binned``, K4), ``_dmxu`` (K11 on the streamed route's visit),
    ``_seeded`` (K9), then ``_raw`` (K1-raw),
    ``_raw_shadows`` (K8), ``_raw_wt`` or ``_raw_wt_shadows`` (K10),
    ``_raster`` (K2) and ``_tex_nearest`` / ``_tex_bilinear`` (K6),
    ``_tex_mip`` (the hand-off, K7's first launch) or ``_nine`` (the
    9-output mode); ``render_none`` is K1-none."""
    name = _ROUTE_NAMES[route] + ("_dmxu" if dmxu else "") + ("_seeded" if seeded else "")
    name += "" if geo == "prep" else f"_{geo}"
    name += "_raster" if raster else ""
    if texture == "nine":
        return name + "_nine"
    return name + (f"_tex_{texture}" if texture else "")


def _route_variants(*routes, seeded: bool = False, textures=_FUSED_TEX,
                    geos=tuple(_GEO_CODES), dmxu: bool = False) -> tuple:
    return tuple(variant_name(r, t, g, route, seeded, dmxu) for route in routes
                 for g in geos for r in ((False,) if seeded else (False, True))
                 for t in textures if t != "nine" or g in _NINE_GEOS)


# The cold entries of K1 (csrc/render_resident.cu) and of the streamed
# ordered walk (K3 + K5, csrc/render_streamed.cu), the streamed binned
# walk's (K4: csrc/render_binned.cu on prep rows, render_binned_blocks.cu
# on the others), the resident visits' sources' (K3 and K4 on resident
# rows), and every route's seeded raytrace entries (K9).
VARIANTS = _route_variants(INDEX, Route(True, "ordered"))
BINNED_VARIANTS = _route_variants(Route(True, "binned"))
RESIDENT_ORDERED_VARIANTS = _route_variants(Route(False, "ordered"))
RESIDENT_BINNED_VARIANTS = _route_variants(Route(False, "binned"))
SEEDED_VARIANTS = _route_variants(*(r for r in _ROUTE_NAMES if r != NONE), seeded=True)
# csrc/render_none.cu's: K1-none in every mode, K1's 9-output mode, each
# seeded too.
NONE_VARIANTS = (_route_variants(NONE, textures=tuple(_TEX_CODES))
                 + _route_variants(NONE, seeded=True, textures=tuple(_TEX_CODES)))
NINE_VARIANTS = (_route_variants(INDEX, textures=("nine",))
                 + _route_variants(INDEX, seeded=True, textures=("nine",)))
# csrc/render_dmxu.cu's: K11 on the two streamed visits, on prep and raw rows
# (it sweeps neither shadows nor the watertight decision), seeded too.
_DMXU_GEOS = ("prep", "raw")
_STREAMED_ROUTES = (Route(True, "ordered"), Route(True, "binned"))
DMXU_VARIANTS = (_route_variants(*_STREAMED_ROUTES, geos=_DMXU_GEOS, dmxu=True)
                 + _route_variants(*_STREAMED_ROUTES, seeded=True, geos=_DMXU_GEOS,
                                   dmxu=True))
# The culled visits' 9-output entries, each in its route's own source: K3
# and K4 on resident rows, K3 + K5 and K4 streamed, and K11 on both streamed
# visits, seeded too.
_CULLED_ROUTES = (Route(False, "ordered"), Route(False, "binned")) + _STREAMED_ROUTES
CULLED_NINE_VARIANTS = (
    _route_variants(*_CULLED_ROUTES, textures=("nine",))
    + _route_variants(*_CULLED_ROUTES, seeded=True, textures=("nine",))
    + _route_variants(*_STREAMED_ROUTES, textures=("nine",), geos=_DMXU_GEOS, dmxu=True)
    + _route_variants(*_STREAMED_ROUTES, seeded=True, textures=("nine",), geos=_DMXU_GEOS,
                      dmxu=True))
RENDER_VARIANTS = (VARIANTS + BINNED_VARIANTS + RESIDENT_ORDERED_VARIANTS
                   + RESIDENT_BINNED_VARIANTS + SEEDED_VARIANTS + NONE_VARIANTS
                   + NINE_VARIANTS + DMXU_VARIANTS + CULLED_NINE_VARIANTS)


def batched_name(raster: bool, nine: bool) -> str:
    """The name of one of K12's entries: ``render_batched``, ``_raster``
    (the raster conventions), ``_nine`` (the 9-output mode)."""
    return "render_batched" + ("_raster" if raster else "") + ("_nine" if nine else "")


BATCHED_VARIANTS = tuple(batched_name(r, n) for n in (False, True) for r in (False, True))
SHADE_MIP_VARIANTS = tuple(f"shade_mip_{f}" for f in shade.MIP_FILTERS)


def mip_name(texture: str) -> str:
    """The name of K7's folded entry for the mip filter ``texture``
    (``csrc/render_mip.cu``: the index visit's tile teams with the mip
    sample, one launch for K7's two)."""
    return f"render_mip_{texture}"


MIP_VARIANTS = tuple(mip_name(f) for f in shade.MIP_FILTERS)


def _check_tensors(ref, tensors) -> None:
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, not {ref.device}")


def _check_pool(pool, device, max_texels: int) -> None:
    if pool.dtype != torch.int32 or not pool.is_contiguous() or pool.dim() != 1:
        raise ValueError("pool must be a contiguous int32 [texels] tensor")
    if pool.device != device:
        raise ValueError(f"pool is on {pool.device}, not {device}")
    if pool.shape[0] > max_texels:
        raise ValueError(f"pool holds {pool.shape[0]} texels, over {max_texels}")


def _check_mip_table(table, fb_rows) -> None:
    if fb_rows not in _MIP_FB_ROWS:
        raise ValueError(f"fb_rows must be one of {_MIP_FB_ROWS}, got {fb_rows!r}")
    if (table.dim() != 2 or table.shape[0] < 7 or (table.shape[0] - 4) % 3
            or table.shape[1] > shade.TEX_MAX_MATERIALS):
        raise ValueError(f"the mip table must be [4 + 3L, M<={shade.TEX_MAX_MATERIALS}], "
                         f"got {tuple(table.shape)}")


def _check_visit(order, spans, num_views: int, n_clusters: int, device, bins=None,
                 ranges=None, bin_tile=None, height=0, width=0, rows=None,
                 geo="prep", dmxu=False) -> None:
    if order is not None and bins is not None:
        raise ValueError("a visit takes order (ordered) or bins (binned), not both")
    if spans is not None and order is None and bins is None:
        raise ValueError("the streamed route needs both order and spans, or bins and spans")
    if spans is None and _streamed_slots(int(rows.shape[2])):
        raise ValueError(f"{rows.shape[2]} triangles a world are past the resident budget: "
                         "the streamed route needs order or bins, and spans")
    if ranges is not None and (bins is None or spans is None):
        raise ValueError("ranges are for the streamed binned route")
    checks = []
    if spans is not None:
        checks.append(("spans", spans, (num_views, 2, n_clusters)))
    if order is not None:
        checks.append(("order", order, (num_views, n_clusters)))
    if bins is not None:
        if bin_tile not in tuple(_TILE << k for k in range(16)):
            raise ValueError(f"bin_tile must be 16·2^k, got {bin_tile!r}")
        n_bins = -(-height // bin_tile) * -(-width // bin_tile)
        checks.append(("bins", bins, (num_views, n_bins, 1 + n_clusters)))
        if spans is not None and (ranges is not None) != (geo == "prep" and not dmxu):
            raise ValueError("the binned route takes ranges with prep rows (not under K11) "
                             "and only then")
        if ranges is not None:
            checks.append(("ranges", ranges, (rows.shape[0], n_clusters,
                                              -(-height // _BAND), 2)))
    for name, t, shape in checks:
        if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous int32 {list(shape)} tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")


def _check_seed(seed, rows, shape, raster: bool) -> None:
    if seed is None:
        return
    if raster:
        raise ValueError("a seed is for the raytrace conventions (K9 has no raster variants)")
    if seed.dtype != torch.float32 or not seed.is_contiguous() or tuple(seed.shape) != shape:
        raise ValueError(f"seed must be a contiguous float32 {list(shape)} tensor, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != rows.device:
        raise ValueError(f"seed is on {seed.device}, not {rows.device}")


def _check_inputs(rows, clusters, cams, num_cams, n_lights, height, width,
                  seg_div, texture, mats, pool, geo, fb_rows=None, order=None,
                  spans=None, bins=None, ranges=None, bin_tile=None, seed=None,
                  raster=False, dmxu=False, rowskip=False, mip=False) -> None:
    if geo not in _GEO_CODES:
        raise ValueError(f"geo must be one of {tuple(_GEO_CODES)}, got {geo!r}")
    if rowskip and not dmxu:
        raise ValueError("rowskip is K11's row gate: it needs dmxu")
    if dmxu and (spans is None or geo not in _DMXU_GEOS or ranges is not None):
        raise ValueError(f"K11 (dmxu) runs on the streamed visits (spans) on {_DMXU_GEOS} "
                         "rows, unsorted (no ranges)")
    if geo == "prep" and num_cams != 1:
        raise ValueError("the prep rows bake in one camera origin: num_cams must be 1")
    if geo in _SHADOW_GEOS and n_lights > _MAX_SHADOW_LIGHTS:
        raise ValueError(f"shadows take at most {_MAX_SHADOW_LIGHTS} lights, got {n_lights}")
    tensors = [("rows", rows), ("cams", cams)]
    if clusters is not None:
        tensors.append(("clusters", clusters))
    elif order is not None or spans is not None or bins is not None:
        raise ValueError("the non-culled sweep (clusters None) takes no visit inputs")
    if texture == "nine":
        if geo not in _NINE_GEOS or mats is not None or pool is not None or fb_rows is not None:
            raise ValueError(f"the 9-output mode sweeps {_NINE_GEOS} rows and samples "
                             "nothing (its shadows and texture are the epilogue's)")
    elif texture is not None:
        filters = shade.FILTERS if fb_rows is None else shade.MIP_FILTERS
        if texture not in filters:
            raise ValueError(f"texture must be None or one of {filters}, got {texture!r}")
        if mats is None or pool is None:
            raise ValueError("a textured render needs mats and pool")
        tensors.append(("mats", mats))
        if fb_rows is None:
            _check_pool(pool, rows.device, shade.TEX_MAX_TEXELS)
            if (mats.dim() != 2 or mats.shape[0] != 6
                    or mats.shape[1] > shade.TEX_MAX_MATERIALS):
                raise ValueError(f"mats must be [6, M<={shade.TEX_MAX_MATERIALS}], "
                                 f"got {tuple(mats.shape)}")
        else:
            _check_pool(pool, rows.device, 1 << 24)
            _check_mip_table(mats, fb_rows)
    elif fb_rows is not None:
        raise ValueError("fb_rows is for textured scenes baked with mip chains")
    _check_tensors(rows, tensors)
    if rows.dim() != 3 or rows.shape[1] != _N_GEO_ROWS + _N_ATTR_ROWS:
        raise ValueError(f"rows must be [W, 40, S], got {tuple(rows.shape)}")
    W, _, S = rows.shape
    CC = 1
    if clusters is not None:
        if clusters.dim() != 3 or clusters.shape[:2] != (W, 8):
            raise ValueError(
                f"clusters must be [{W}, 8, CC], got {tuple(clusters.shape)}"
            )
        CC = clusters.shape[2]
        if CC < 1 or S % CC:
            raise ValueError(f"{S} triangles do not split into {CC} clusters")
    elif _streamed_slots(S):
        raise ValueError(f"{S} triangles a world are past the resident budget: the "
                         "non-culled sweep keeps them in shared memory")
    if cams.shape != (W * num_cams, _n_cam_cols(n_lights)):
        raise ValueError(
            f"cams must be [{W * num_cams}, {_n_cam_cols(n_lights)}], got "
            f"{tuple(cams.shape)}"
        )
    if height < 1 or width < 1 or seg_div < 1:
        raise ValueError(f"bad height/width/seg_div {height}/{width}/{seg_div}")
    _check_visit(order, spans, W * num_cams, CC, rows.device, bins, ranges, bin_tile,
                 height, width, rows, geo, dmxu)
    if clusters is not None and spans is None and (order is not None or bins is not None):
        check_resident_plan(rows, CC, n_lights, geo, order is not None)
    if spans is None and order is None and bins is None:
        check_index_plan(rows, CC if clusters is not None else 0, n_lights, geo, W * num_cams,
                         height, width, "mip" if mip or fb_rows is not None else texture,
                         raster=raster, seeded=seed is not None, culled=clusters is not None)
    if clusters is not None and spans is not None and order is not None:
        check_streamed_plan(rows, CC, n_lights, geo, W * num_cams, height, width, dmxu=dmxu)
    if clusters is not None and spans is not None and bins is not None:
        check_binned_plan(rows, CC, n_lights, geo, W * num_cams, height, width, bin_tile, dmxu)
    _check_seed(seed, rows, (W * num_cams, height, width), raster)


def render_resident(rows, clusters, cams, *, num_cams: int, n_lights: int,
                    height: int, width: int, seg_div: int, raster: bool = False,
                    texture=None, mats=None, pool=None, geo: str = "prep",
                    fb_rows=None, order=None, spans=None, bins=None, ranges=None,
                    bin_tile=None, seed=None, dmxu=False, rowskip=False):
    """The render kernel. Returns ``(depth f32, segmask i32, rgb i32-packed)``,
    each ``[W·C, height, width]``, in their final masked form: depth is t
    (raster: camera-plane z), segmask idx // seg_div (raster: -1). With
    ``texture="nine"`` (the 9-output mode, on every visit, each in its
    route's library: ``library_of``) it returns the JAX kernel's unshaded
    outputs instead, unmasked: ``(t, z, idx, mat, uvx, uvy, nx, ny, nz)``
    (t and z 0 and idx -1 on a miss, mat i32; the normal flipped toward the
    viewer), for ``frames_from_core``'s epilogue. ``clusters`` None: the
    non-culled sweep (K1-none, ``csrc/render_none.cu``), every triangle of
    the world for every pixel.
    ``texture`` is None for an untextured scene, else the filter, with
    ``mats`` / ``pool`` from ``shade.material_table`` / ``shade.texel_pool``;
    with ``fb_rows`` (a scene baked with mip chains) ``mats`` is
    ``shade.mip_table`` and the render is K7: where ``index_plan`` takes
    the tile teams, one launch of the folded entry (``csrc/render_mip.cu``,
    counted as ``mip_name(texture)``), else the kernel's hand-off
    (``render_handoff``), then ``shade_mip``.
    ``geo`` names the rows' layout (``pack_cuda.pack_rows``) and the sweep:
    ``"prep"`` (one camera per world), ``"raw"``, or ``"raw_shadows"``,
    which shades each light only where nothing lies between the hit point
    and the light; ``"raw_wt"`` and ``"raw_wt_shadows"`` decide the primary
    hits by the watertight Woop test (K10). The visit (``route_of``): with
    ``order`` the front-to-back walk, on resident rows (K3,
    ``csrc/render_resident_ordered.cu``) or with ``spans`` (``pack_inputs``
    on a mesh past the resident budget) the streamed route's (K3 + K5); with
    ``bins`` and ``bin_tile`` the binned walk, on resident rows (K4,
    ``csrc/render_resident_binned.cu``) or with ``spans`` and on prep rows
    ``ranges`` the streamed route's (K4, ``csrc/render_binned.cu``);
    without either, every cluster in index order (K1). ``seed`` (K9, f32
    ``[W·C, height, width]`` or None): each pixel's search starts at
    ``min(seed, far)``, so a hit at or beyond its seed is a miss. ``dmxu``
    (the streamed visits, ``pack_inputs(deferred_mxu=True)``): K11
    (``csrc/render_dmxu.cu``), every slot of a visited cluster swept and its
    first minimum merged, with ``rowskip`` each warp's two pixel rows gated
    on the cluster's row span; on raw rows its D, A, Q and t_num formed per
    view, so its plain version sweeps those (``render_resident_plain``).

    Tensors on the card launch the route's kernel on their device's current
    stream; tensors on the CPU run ``render_resident_plain``. Inputs that
    the resident visits' or the streamed walks' launch plans cannot take
    (``check_resident_plan``, ``check_streamed_plan``,
    ``check_binned_plan``) raise ``LaunchPlanError`` on either device. Each
    launch adds one to ``render_resident.launches`` and to its variant's
    entry of ``render_resident.variant_launches``."""
    _check_inputs(rows, clusters, cams, num_cams, n_lights, height, width,
                  seg_div, texture, mats, pool, geo, fb_rows, order, spans, bins,
                  ranges, bin_tile, seed, raster, dmxu, rowskip)
    kw = dict(num_cams=num_cams, n_lights=n_lights, height=height,
              width=width, seg_div=seg_div, raster=raster, geo=geo,
              order=order, spans=spans, bins=bins, ranges=ranges, bin_tile=bin_tile,
              seed=seed, dmxu=dmxu, rowskip=rowskip)
    if rows.device.type == "cpu":
        return render_resident_plain(rows, clusters, cams, texture=texture,
                                     mats=mats, pool=pool, fb_rows=fb_rows, **kw)
    if fb_rows is not None:
        plan = mip_plan(rows, clusters, cams, n_lights=n_lights, height=height, width=width,
                        raster=raster, geo=geo, order=order, spans=spans, bins=bins, seed=seed)
        if plan.groups:
            return _launch_mip(rows, clusters, cams, mats, pool, n_lights=n_lights,
                               height=height, width=width, seg_div=seg_div,
                               texture=texture, fb_rows=fb_rows, groups=plan.groups)
        depth, seg, code, handoff = render_handoff(rows, clusters, cams, **kw)
        rgb = shade_mip(code, handoff, cams, mats, pool, fb_rows=fb_rows,
                        texture=texture, n_lights=n_lights)
        return depth, seg, rgb
    return _launch_render(rows, clusters, cams, texture=texture, mats=mats,
                          pool=pool, **kw)


def mip_plan(rows, clusters, cams, *, n_lights: int, height: int, width: int,
             raster: bool = False, geo: str = "prep", order=None, spans=None, bins=None,
             seed=None, **_) -> IndexPlan:
    """K7's launch on these inputs (``render_resident``'s keyword
    arguments): on the resident index order, ``index_plan``'s for the
    ``"mip"`` mode (groups > 0: the folded entry, one launch); on every
    other visit, and where the plan takes the parent, 0 groups: the
    hand-off, then ``shade_mip``."""
    if route_of(order, spans, bins, clusters is not None) != INDEX:
        return IndexPlan(0, 0)
    return check_index_plan(rows, int(clusters.shape[2]), n_lights, geo, int(cams.shape[0]),
                            height, width, "mip", raster=raster, seeded=seed is not None)


def render_handoff(rows, clusters, cams, *, num_cams: int, n_lights: int,
                   height: int, width: int, seg_div: int, raster: bool = False,
                   geo: str = "prep", order=None, spans=None, bins=None, ranges=None,
                   bin_tile=None, seed=None, dmxu=False, rowskip=False):
    """K7's first launch in its two-launch design: the render kernel in its
    mip hand-off mode, on render_body's 16x16 blocks whatever the plan.
    Returns ``(depth, segmask, code, handoff)``: depth and segmask as
    ``render_resident`` writes them, ``code`` i32 ``[W·C, H, Wd]`` (the
    winner's material | geometric hit << 16 | shaded hit << 17) and
    ``handoff`` f32 ``[6, W·C, H, Wd]`` (u, v, the footprint, the three
    lambert sums with shadows applied). Launches on the card (counted as
    ``render_resident``'s ``_tex_mip`` variant), ``render_handoff_plain``
    on the CPU."""
    _check_inputs(rows, clusters, cams, num_cams, n_lights, height, width,
                  seg_div, None, None, None, geo, None, order, spans, bins, ranges,
                  bin_tile, seed, raster, dmxu, rowskip, mip=True)
    kw = dict(num_cams=num_cams, n_lights=n_lights, height=height,
              width=width, seg_div=seg_div, raster=raster, geo=geo,
              order=order, spans=spans, bins=bins, ranges=ranges, bin_tile=bin_tile,
              seed=seed, dmxu=dmxu, rowskip=rowskip)
    if rows.device.type == "cpu":
        return render_handoff_plain(rows, clusters, cams, **kw)
    return _launch_render(rows, clusters, cams, texture="mip", **kw)


def _launch_render(rows, clusters, cams, *, num_cams, n_lights, height, width,
                   seg_div, raster, texture, geo, mats=None, pool=None,
                   order=None, spans=None, bins=None, ranges=None, bin_tile=None,
                   seed=None, dmxu=False, rowskip=False):
    if rows.device.type != "cuda":
        raise ValueError(f"render_resident runs on cuda or cpu, not {rows.device}")
    W, _, S = rows.shape
    CC = 0 if clusters is None else clusters.shape[2]
    WC = W * num_cams
    tiles = -(-height // 16) * -(-width // 16)
    if tiles > 65535:
        raise ValueError(f"{height}x{width} needs {tiles} tiles; the grid takes 65535")
    route = route_of(order, spans, bins, clusters is not None)
    if route.streamed and ((S // CC) % 4 or rows.data_ptr() % 16):
        raise ValueError("the streamed route copies 16-byte slices: the cluster "
                         "size must be a multiple of 4 and rows 16-byte aligned")
    dev = rows.device
    shape = (WC, height, width)
    depth = torch.empty(shape, dtype=torch.float32, device=dev)
    seg = torch.empty(shape, dtype=torch.int32, device=dev)
    # The mip hand-off and the 9-output mode write code (the material) and
    # six f32 planes instead of rgb.
    mip = texture in ("mip", "nine")
    sampled = texture in shade.FILTERS
    if mip:
        code = torch.empty(shape, dtype=torch.int32, device=dev)
        handoff = torch.empty((_HANDOFF_PLANES,) + shape, dtype=torch.float32, device=dev)
    else:
        rgb = torch.empty(shape, dtype=torch.int32, device=dev)
    # The C entries share their arguments but for the visit's.
    head = [rows.data_ptr(), None if clusters is None else clusters.data_ptr(),
            cams.data_ptr(),
            mats.data_ptr() if sampled else None, pool.data_ptr() if sampled else None,
            int(mats.shape[1]) if sampled else 0,
            depth.data_ptr(), seg.data_ptr(), None if mip else rgb.data_ptr(),
            code.data_ptr() if mip else None, handoff.data_ptr() if mip else None]
    params = [WC, num_cams, S, CC, S // max(CC, 1), int(cams.shape[1]), n_lights,
              height, width, seg_div,
              float(np.float32(2.0 / width)), float(np.float32(2.0 / height)),
              int(raster), _TEX_CODES[texture], _GEO_CODES[geo]]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    bin_args = [0, 0, 0] if bins is None else [
        -(-width // bin_tile), bin_tile.bit_length() - _TILE.bit_length(), int(bins.shape[1])]
    n_bands = -(-height // _BAND)
    kernel = library_of(route, seed is not None, texture, dmxu, geo)
    if route == Route(True, "binned"):
        plan = binned_plan(geo, S // CC, n_lights, WC, height, width, bin_tile, dmxu,
                           _sm_count(dev))
        if plan.groups == 0:  # the parent design: render_body's 16x16 blocks
            kernel = ("render_dmxu" if dmxu else "render_seeded" if seed is not None
                      else "render_binned_blocks")
    if kernel == "render_binned":  # K4 and K11 on the binned walk's tile groups
        visit = [bins.data_ptr(), spans.data_ptr(), ptr(ranges), ptr(seed)]
        tail = bin_args + [n_bands, int(dmxu), int(rowskip), plan.groups, plan.parts, stream]
    elif kernel == "render_dmxu":  # K11 on either streamed visit, cold or seeded
        plan = (StreamPlan(0, 1, 0) if bins is not None else
                streamed_plan(geo, CC, S // CC, n_lights, WC, height, width, _sm_count(dev),
                              dmxu=True))
        visit = [ptr(order), spans.data_ptr(), ptr(bins), ptr(seed)]
        tail = bin_args + [int(rowskip), plan.groups, plan.parts, stream]
    elif kernel == "render_none":  # K1-none on its plan, and K1's 9-output mode
        plan = (IndexPlan(0, 0) if texture == "mip" else  # the hand-off: the parent's blocks
                check_index_plan(rows, CC, n_lights, geo, WC, height, width, texture,
                                 raster=raster, seeded=seed is not None,
                                 culled=clusters is not None))
        visit, tail = [ptr(seed)], [int(clusters is not None), plan.groups, stream]
    elif kernel == "render_streamed":  # K3 + K5, cold or seeded
        plan = streamed_plan(geo, CC, S // CC, n_lights, WC, height, width, _sm_count(dev))
        visit = [order.data_ptr(), spans.data_ptr(), ptr(seed)]
        tail = [plan.groups, plan.parts, stream]
    elif kernel == "render_seeded":  # K9 on K1 and K4
        visit = [ptr(spans), ptr(bins), ptr(ranges), seed.data_ptr()]
        tail = bin_args + [n_bands, stream]
    elif kernel == "render_binned_blocks":
        visit = [bins.data_ptr(), spans.data_ptr(), ptr(ranges)]
        tail = bin_args + [n_bands, stream]
    elif route == Route(False, "binned"):
        visit, tail = [bins.data_ptr(), ptr(seed)], bin_args + [stream]
    elif route == Route(False, "ordered"):
        visit, tail = [order.data_ptr(), ptr(seed)], [stream]
    else:  # K1 and K2: the index visit on its plan (0 groups: the parent design)
        plan = (IndexPlan(0, 0) if texture == "mip" else  # the hand-off: the parent's blocks
                check_index_plan(rows, CC, n_lights, geo, WC, height, width, texture,
                                 raster=raster))
        visit, tail = [], [plan.groups, stream]
    launch = _build.load(kernel)
    with torch.cuda.device(dev):
        err = launch(*head, *visit, *params, *tail)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: {launch.error_string(err)}")
    render_resident.launches += 1
    render_resident.variant_launches[
        variant_name(raster, texture, geo, route, seed is not None, dmxu)] += 1
    if texture == "nine":  # t, z, idx, mat, uvx, uvy, nx, ny, nz
        return (depth, handoff[0], seg, code, *handoff[1:])
    return (depth, seg, code, handoff) if mip else (depth, seg, rgb)


render_resident.launches = 0
render_resident.variant_launches = dict.fromkeys(RENDER_VARIANTS + MIP_VARIANTS, 0)


def _launch_mip(rows, clusters, cams, mats, pool, *, n_lights, height, width, seg_div,
                texture, fb_rows, groups):
    """K7 folded (``csrc/render_mip.cu``): one launch of the index visit's
    tile teams with the mip sample, ``groups`` groups a block, on prep rows
    raytraced (one camera a world); ``(depth, segmask, rgb)``."""
    W, _, S = rows.shape
    CC = int(clusters.shape[2])
    dev = rows.device
    tile_sub, tiles_x, n_tiles = mips.tile_geometry(height, width)
    shape = (W, height, width)
    depth = torch.empty(shape, dtype=torch.float32, device=dev)
    seg = torch.empty(shape, dtype=torch.int32, device=dev)
    rgb = torch.empty(shape, dtype=torch.int32, device=dev)
    launch = _build.load("render_mip")
    with torch.cuda.device(dev):
        err = launch(rows.data_ptr(), clusters.data_ptr(), cams.data_ptr(), mats.data_ptr(),
                     pool.data_ptr(), int(mats.shape[1]), depth.data_ptr(), seg.data_ptr(),
                     rgb.data_ptr(), W, S, CC, S // CC, int(cams.shape[1]), n_lights, height,
                     width, seg_div, float(np.float32(2.0 / width)),
                     float(np.float32(2.0 / height)), mips.num_levels(mats), fb_rows, tile_sub,
                     tiles_x, n_tiles, _MIP_FILTER_CODES[texture], groups,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_mip launch failed: {launch.error_string(err)}")
    render_resident.launches += 1
    render_resident.variant_launches[mip_name(texture)] += 1
    return depth, seg, rgb


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _occupancy_query(name: str, argtypes: list, symbol=None):
    fn = getattr(ctypes.CDLL(str(_build.build(name))), symbol or f"mrt_{name}_occupancy")
    fn.argtypes = argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def streamed_occupancy(kw: dict) -> dict:
    """What the card makes of the streamed ordered walk's entry that these
    inputs (``pack_inputs``'s, of the streamed ordered visit: K3 + K5, or
    K11's tile groups with ``dmxu``) launch: its variant, tile groups and
    blocks a view, threads a block, registers and local memory a thread,
    shared memory a block, and blocks and warps a multiprocessor
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Launches nothing;
    needs the card."""
    route = route_of(kw["order"], kw["spans"], kw["bins"], kw["clusters"] is not None)
    if route != Route(True, "ordered"):
        raise ValueError(f"{route} is not the streamed ordered walk")
    texture = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    seeded = kw.get("seed") is not None
    dmxu = bool(kw.get("dmxu"))
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    views = int(kw["cams"].shape[0])
    plan = streamed_plan(kw["geo"], CC, S // CC, kw["n_lights"], views, kw["height"],
                         kw["width"], _sm_count(kw["rows"].device), dmxu=dmxu)
    name = "render_dmxu" if dmxu else "render_streamed"
    out = (ctypes.c_int * 4)()
    err = _occupancy_query(name, [ctypes.c_int] * 9)(
        _GEO_CODES[kw["geo"]], int(kw["raster"]), _TEX_CODES[texture], int(seeded),
        plan.groups, CC, S // CC, int(kw["cams"].shape[1]), kw["n_lights"], out)
    if err != 0:
        raise RuntimeError(f"{name}'s occupancy query failed: CUDA error {err}")
    threads, registers, local, blocks = list(out)
    return {"variant": variant_name(kw["raster"], texture, kw["geo"], route, seeded, dmxu),
            "groups": plan.groups, "blocks_per_view": plan.parts,
            "blocks": views * (plan.parts if plan.groups else -(-kw["height"] // _TILE)
                               * -(-kw["width"] // _TILE)),
            "threads": threads, "registers": registers, "local_bytes": local,
            "smem_bytes": plan.smem_bytes, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


def binned_occupancy(kw: dict) -> dict:
    """What the card makes of the streamed binned walk's entry that these
    inputs (``pack_inputs``'s, of the streamed binned visit's tile groups:
    K4, or K11 with ``dmxu``, on prep rows) launch: its variant,
    tile groups and blocks a view, blocks in all, threads a block,
    registers and local memory a thread, shared memory a block, and blocks
    and warps a multiprocessor
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Launches nothing;
    needs the card."""
    route = route_of(kw["order"], kw["spans"], kw["bins"], kw["clusters"] is not None)
    if route != Route(True, "binned"):
        raise ValueError(f"{route} is not the streamed binned walk")
    if kw["rows"].device.type != "cuda":
        raise RuntimeError(f"binned_occupancy needs the card: the inputs are on "
                           f"{kw['rows'].device}")
    texture = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    seeded = kw.get("seed") is not None
    dmxu = bool(kw.get("dmxu"))
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    views = int(kw["cams"].shape[0])
    plan = binned_plan(kw["geo"], S // CC, kw["n_lights"], views, kw["height"], kw["width"],
                       kw["bin_tile"], dmxu, _sm_count(kw["rows"].device))
    if plan.groups == 0:
        raise ValueError(f"{kw['geo']} rows walk render_body's 16x16 blocks, which have no "
                         "occupancy query")
    out = (ctypes.c_int * 4)()
    err = _occupancy_query("render_binned", [ctypes.c_int] * 9)(
        _GEO_CODES[kw["geo"]], int(kw["raster"]), _TEX_CODES[texture], int(seeded), int(dmxu),
        plan.groups, S // CC, int(kw["cams"].shape[1]), kw["n_lights"], out)
    if err != 0:
        raise RuntimeError(f"render_binned's occupancy query failed: CUDA error {err}")
    threads, registers, local, blocks = list(out)
    return {"variant": variant_name(kw["raster"], texture, kw["geo"], route, seeded, dmxu),
            "groups": plan.groups, "blocks_per_view": plan.parts,
            "blocks": views * plan.parts, "threads": threads, "registers": registers,
            "local_bytes": local, "smem_bytes": plan.smem_bytes, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


def resident_occupancy(kw: dict) -> dict:
    """What the card makes of the resident visit's entry that these inputs
    (``pack_inputs``'s, of a resident ordered or binned visit) launch: its
    variant, tile groups, threads a block, registers and local memory a
    thread, shared memory a block, and blocks and warps a multiprocessor
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Launches nothing;
    needs the card."""
    route = route_of(kw["order"], kw["spans"], kw["bins"], kw["clusters"] is not None)
    if route not in (Route(False, "ordered"), Route(False, "binned")):
        raise ValueError(f"{route} is not a resident visit")
    name = _ROUTE_LIBRARIES[route]
    fn = _occupancy_query(name, [ctypes.c_int] * 8)
    texture = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    seeded = kw.get("seed") is not None
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    out = (ctypes.c_int * 4)()
    err = fn(_GEO_CODES[kw["geo"]], int(kw["raster"]), _TEX_CODES[texture], int(seeded), S, CC,
             int(kw["cams"].shape[1]), kw["n_lights"], out)
    if err != 0:
        raise RuntimeError(f"{name}'s occupancy query failed: CUDA error {err}")
    threads, registers, local, blocks = list(out)
    return {"variant": variant_name(kw["raster"], texture, kw["geo"], route, seeded),
            "groups": threads // _TILE ** 2, "threads": threads, "registers": registers,
            "local_bytes": local,
            "smem_bytes": resident_smem_bytes(kw["geo"], S, CC, kw["n_lights"],
                                              route.visit == "ordered"),
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}


# --------------------------------------------------------------------- #
# Kernel K7's second launch and its plain version
# --------------------------------------------------------------------- #
def index_occupancy(kw: dict) -> dict:
    """What the card makes of the index visit's entry that these inputs
    (``pack_inputs``'s, of the resident index order: K1 and K6 on prep
    rows, K7 folded, K1's 9-output mode, K1-raw, K8, K10, K2 and K2+K6;
    K1-none without a cluster table) launch on
    their plan: its variant, tile groups, threads a block, registers and
    local memory a thread, shared memory a block, and blocks and warps a
    multiprocessor
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Launches nothing;
    needs the card."""
    culled = kw["clusters"] is not None
    route = route_of(kw["order"], kw["spans"], kw["bins"], culled)
    texture = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2]) if culled else 0
    plan = check_index_plan(kw["rows"], CC, kw["n_lights"], kw["geo"],
                            int(kw["cams"].shape[0]), kw["height"], kw["width"], texture,
                            raster=kw["raster"], seeded=kw.get("seed") is not None,
                            culled=culled)
    if route not in (INDEX, NONE) or plan.groups == 0:
        raise ValueError("these inputs take no index visit on tile groups")
    out = (ctypes.c_int * 4)()
    n_cols = int(kw["cams"].shape[1])
    if not culled:
        name, variant = "render_none", variant_name(False, texture, kw["geo"], NONE)
        err = _occupancy_query(name, [ctypes.c_int] * 6)(
            _GEO_CODES[kw["geo"]], _TEX_CODES[texture], plan.groups, S, n_cols, kw["n_lights"],
            out)
    elif texture == "nine":
        name, variant = "render_none", variant_name(False, texture, kw["geo"], INDEX)
        err = _occupancy_query(name, [ctypes.c_int] * 6, "mrt_render_none_nine_occupancy")(
            _GEO_CODES[kw["geo"]], plan.groups, S, CC, n_cols, kw["n_lights"], out)
    elif texture == "mip":
        name, variant = "render_mip", mip_name(kw["texture"])
        err = _occupancy_query(name, [ctypes.c_int] * 9)(
            _MIP_FILTER_CODES[kw["texture"]], plan.groups, S, CC, n_cols, kw["n_lights"],
            kw["height"], kw["width"], mips.tile_geometry(kw["height"], kw["width"])[2], out)
    else:
        name = "render_resident"
        variant = variant_name(kw["raster"], texture, kw["geo"], INDEX)
        err = _occupancy_query(name, [ctypes.c_int] * 8)(
            _GEO_CODES[kw["geo"]], int(kw["raster"]), _TEX_CODES[texture], plan.groups, S, CC,
            n_cols, kw["n_lights"], out)
    if err != 0:
        raise RuntimeError(f"{name}'s occupancy query failed: CUDA error {err}")
    threads, registers, local, blocks = list(out)
    return {"variant": variant, "groups": plan.groups,
            "threads": threads, "registers": registers, "local_bytes": local,
            "smem_bytes": plan.smem_bytes, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32}


def _check_handoff(code, handoff, cams, table, pool, fb_rows, texture, n_lights):
    if texture not in shade.MIP_FILTERS:
        raise ValueError(f"texture must be one of {shade.MIP_FILTERS}, got {texture!r}")
    if code.dtype != torch.int32 or code.dim() != 3 or not code.is_contiguous():
        raise ValueError("code must be a contiguous int32 [V, H, Wd] tensor")
    if handoff.shape != (_HANDOFF_PLANES,) + tuple(code.shape):
        raise ValueError(f"handoff must be [{_HANDOFF_PLANES}, V, H, Wd], got "
                         f"{tuple(handoff.shape)}")
    _check_tensors(code, [("handoff", handoff), ("cams", cams), ("table", table)])
    if cams.shape != (code.shape[0], _n_cam_cols(n_lights)):
        raise ValueError(f"cams must be [{code.shape[0]}, {_n_cam_cols(n_lights)}], "
                         f"got {tuple(cams.shape)}")
    _check_pool(pool, code.device, 1 << 24)
    _check_mip_table(table, fb_rows)


def shade_mip(code, handoff, cams, table, pool, *, fb_rows: int, texture: str,
              n_lights: int):
    """K7's second launch (``csrc/shade_mip.cu``): from the hand-off of
    ``render_handoff``, each pixel's mip level, the window clamp of its TPU
    tile (``mips.tile_geometry``), the ``texture`` sample (nearest,
    bilinear or trilinear) from the mip table ``table`` and the pool, and
    the packed rgb ``[V, H, Wd]`` i32. Tensors on the card launch the
    kernel (one add to ``shade_mip.launches`` and to the filter's entry of
    ``shade_mip.variant_launches``); tensors on the CPU run
    ``shade_mip_plain``."""
    _check_handoff(code, handoff, cams, table, pool, fb_rows, texture, n_lights)
    if code.device.type == "cpu":
        return shade_mip_plain(code, handoff, cams, table, pool, fb_rows=fb_rows,
                               texture=texture, n_lights=n_lights)
    if code.device.type != "cuda":
        raise ValueError(f"shade_mip runs on cuda or cpu, not {code.device}")
    V, height, width = code.shape
    tile_sub, tiles_x, n_tiles = mips.tile_geometry(height, width)
    if n_tiles > 65535:
        raise ValueError(f"{height}x{width} needs {n_tiles} tiles; the grid takes 65535")
    rgb = torch.empty_like(code)
    launch = _build.load("shade_mip")
    with torch.cuda.device(code.device):
        err = launch(
            code.data_ptr(), handoff.data_ptr(), cams.data_ptr(), table.data_ptr(),
            pool.data_ptr(), rgb.data_ptr(), V, int(cams.shape[1]),
            _cam_valid_col(n_lights), int(table.shape[1]), mips.num_levels(table),
            fb_rows, height, width, tile_sub, tiles_x, n_tiles,
            _MIP_FILTER_CODES[texture],
            torch.cuda.current_stream(code.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"shade_mip launch failed: {launch.error_string(err)}")
    shade_mip.launches += 1
    shade_mip.variant_launches[f"shade_mip_{texture}"] += 1
    return rgb


shade_mip.launches = 0
shade_mip.variant_launches = dict.fromkeys(SHADE_MIP_VARIANTS, 0)


def _pack_rgb(base, s, shaded_hit, cam_ok=None):
    """RGBA8 of lambert + ambient 0.2 over the base colour, black where
    nothing is shaded, opaque black for an invalid camera (``cam_ok`` None:
    no camera mask)."""
    def quantize(b, sk):
        c = torch.clamp(b * (_F_AMBIENT + _F_DIFFUSE * sk), 0.0, 1.0)
        c = torch.where(shaded_hit, c, 0.0)
        return (c * 255.0 + 0.5).to(torch.int32)

    packed = (
        quantize(base[0], s[0])
        | (quantize(base[1], s[1]) << 8)
        | (quantize(base[2], s[2]) << 16)
        | _ALPHA
    )
    return packed if cam_ok is None else torch.where(cam_ok, packed, _ALPHA)


def shade_mip_plain(code, handoff, cams, table, pool, *, fb_rows: int,
                    texture: str, n_lights: int):
    """``shade_mip`` in torch ops (``ops/mips.py``), on any device."""
    V, height, width = code.shape
    c = code.reshape(V, -1)
    u, v, fp, *s = handoff.reshape(_HANDOFF_PLANES, V, -1)
    base = mips.mip_base(table, pool, fb_rows, c & 0xFFFF, u, v, fp,
                         (c & _FOUND_BIT) != 0, height, width, texture)
    cam_ok = cams[:, _cam_valid_col(n_lights):_cam_valid_col(n_lights) + 1] > 0
    rgb = _pack_rgb(base, s, (c & _SHADED_BIT) != 0, cam_ok)
    return rgb.to(torch.int32).reshape(V, height, width)


def plain_rays(cams, height: int, width: int, rows: int = 0, cols: int = 0):
    """Unit ray directions ``(dx, dy, dz)``, each ``[W·C, height·width]``,
    with K1's ray generation expressions (``raytrace_pallas.py:1180-1188``);
    with ``rows`` × ``cols`` (at least the image), those of a larger grid of
    threads, as the kernel's blocks past the image edge trace them."""
    dev = cams.device
    f32 = torch.float32
    ys, xs = torch.meshgrid(
        torch.arange(rows or height, device=dev, dtype=f32),
        torch.arange(cols or width, device=dev, dtype=f32),
        indexing="ij",
    )
    px = xs.reshape(1, -1)
    py = ys.reshape(1, -1)
    two_w = float(np.float32(2.0 / width))
    two_h = float(np.float32(2.0 / height))
    a = ((px + 0.5) * two_w - 1.0) * cams[:, 12:13]
    b = (1.0 - (py + 0.5) * two_h) * cams[:, 13:14]
    dx = a * cams[:, 3:4] + cams[:, 6:7] + b * cams[:, 9:10]
    dy = a * cams[:, 4:5] + cams[:, 7:8] + b * cams[:, 10:11]
    dz = a * cams[:, 5:6] + cams[:, 8:9] + b * cams[:, 11:12]
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv_len, dy * inv_len, dz * inv_len


def plain_triangle_test(dx, dy, dz, tri_rows, near, best_t=None, origin=None,
                        shear=None):
    """The sweep's Möller–Trumbore test of one triangle against every ray:
    ``tri_rows`` is its first 10 rows ``[W·C, 10, 1]``, the prep rows (K1)
    or, with the rays' origin ``origin`` (three components, each ``[W·C, 1]``
    per view or ``[W·C, P]`` per pixel), the raw rows (K1-raw: tv, q and
    t_num, then the pvec test, :1342-1380; K8's any-hit test from the hit
    points, :2885-2903, takes the same expressions with ``best_t`` None).
    With the rays' shear frame ``shear`` (``watertight.shear_select``, raw
    rows) the acceptance and t are K10's Woop decision (:1393-1435):
    a = v0 − o, b = a + e1, c = a + e2 sheared, the three edge functions,
    the validity row 9; (u, v) stay the Möller–Trumbore values.
    Returns ``(ok, t, u, v)``, ``ok`` the strict first-min acceptance."""
    def r(k):
        return tri_rows[:, k]

    if origin is None:
        det = dx * r(0) + dy * r(1) + dz * r(2)
        inv = torch.where(torch.abs(det) > _F_EPS_DET, 1.0 / det, 0.0)
        u = (dx * r(3) + dy * r(4) + dz * r(5)) * inv
        v = (dx * r(6) + dy * r(7) + dz * r(8)) * inv
        t = r(9) * inv
    else:
        e1x, e1y, e1z = r(3), r(4), r(5)
        e2x, e2y, e2z = r(6), r(7), r(8)
        tvx = origin[0] - r(0)
        tvy = origin[1] - r(1)
        tvz = origin[2] - r(2)
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        t_num = e2x * qx + e2y * qy + e2z * qz
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv = torch.where(torch.abs(det) > _F_EPS_DET, 1.0 / det, 0.0)
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = t_num * inv
    if shear is not None:
        awx = r(0) - origin[0]
        awy = r(1) - origin[1]
        awz = r(2) - origin[2]
        *_, t, accept = wt._edge_function_hit(
            *wt.sheared(shear, awx, awy, awz),
            *wt.sheared(shear, awx + e1x, awy + e1y, awz + e1z),
            *wt.sheared(shear, awx + e2x, awy + e2y, awz + e2z))
        ok = accept & (r(9) > 0.0) & (t > near)
    else:
        ok = (
            (torch.minimum(u, v) >= -_F_EPS_BARY)
            & (u + v <= _F_ONE_PLUS_EPS)
            & (t > near)
        )
    if best_t is not None:
        ok = ok & (t < best_t)
    return ok, t, u, v


class PlainHits(NamedTuple):
    """The plain sweep's per-pixel result, each ``[W·C, H·Wd]``: the best t
    (far, or the seed's bound, where nothing was accepted), the winner's
    index (-1 on a miss), its carried (u, v) (raw rows; else 0), and with
    shadows each light's occlusion (a tuple of bool planes)."""

    best_t: torch.Tensor
    best_idx: torch.Tensor
    best_u: torch.Tensor
    best_v: torch.Tensor
    occluded: tuple


def _plain_rows(rows, cams, num_cams: int, geo: str, ranges, dmxu: bool) -> tuple:
    """The rows the plain version sweeps: row-sorted rows (the binned
    route's ``ranges``) put back in triangle order, K11's raw rows as each
    view's D, A, Q and t_num (``dmxu_rows``); with their ``num_cams`` and
    ``geo``."""
    if ranges is not None:
        rows = _index_order_rows(rows)
    if dmxu and geo == "raw":
        return dmxu_rows(rows, cams, num_cams), 1, "prep"
    return rows, num_cams, geo


def plain_hits(rows, clusters, cams, *, num_cams: int, n_lights: int, height: int,
               width: int, raster: bool = False, geo: str = "prep", ranges=None,
               seed=None, dmxu=False, **_) -> PlainHits:
    """The sweep of ``render_resident_plain`` and ``render_handoff_plain``
    on these inputs (their keyword arguments; the texture mode is the
    resolve's): passed to either as ``hits``, it lets several texture modes
    of the same rows, cameras and seed share one sweep."""
    del clusters
    rows, num_cams, geo = _plain_rows(rows, cams, num_cams, geo, ranges, dmxu)
    return _plain_sweep(rows, cams, num_cams=num_cams, n_lights=n_lights, height=height,
                        width=width, raster=raster, geo=geo, seed=seed)


def render_resident_plain(rows, clusters, cams, *, num_cams: int,
                          n_lights: int, height: int, width: int,
                          seg_div: int, raster: bool = False, texture=None,
                          mats=None, pool=None, geo: str = "prep",
                          fb_rows=None, order=None, spans=None, bins=None,
                          ranges=None, bin_tile=None, seed=None, dmxu=False,
                          rowskip=False, hits=None):
    """The kernel in torch ops, on any device: the same expressions in the
    same order, with no cluster cull (the culls only skip work). A loop over
    the S triangles in ascending chunks carries (best_t, best_idx) — and on
    raw rows the winner's (u, v) — as ``[W·C, H·Wd]`` tensors, each chunk
    taking its first triangle at its least accepted t where that beats
    best_t (the strict-< running sweep: the lowest index wins an exact tie);
    best_t starts at far, or with ``seed`` (K9) at ``min(seed, far)``; with
    shadows, a loop over the S triangles per light ORs the occlusion.
    With ``fb_rows`` (K7):
    ``render_handoff_plain``, then ``shade_mip_plain``. It is the plain
    version of every route: the visit orders, bins and culls only skip
    work, and exact ties go to the lower index on all. Row-sorted rows (the
    binned route's ``ranges``) are put back in triangle order first. K11
    (``dmxu``) on raw rows sweeps each view's D, A, Q and t_num
    (``dmxu_rows``), as the kernel forms them; its row gate (``rowskip``)
    only skips work. ``hits``: ``plain_hits`` of the same inputs, the sweep
    done already."""
    del clusters, order, spans, bins, bin_tile, rowskip  # the plain version sweeps every triangle
    rows, num_cams, geo = _plain_rows(rows, cams, num_cams, geo, ranges, dmxu)
    kw = dict(num_cams=num_cams, n_lights=n_lights, height=height, width=width,
              seg_div=seg_div, raster=raster, geo=geo, seed=seed, hits=hits)
    if fb_rows is None:
        return _render_plain(rows, cams, texture=texture, mats=mats, pool=pool,
                             **kw)
    depth, seg, code, handoff = _render_plain(rows, cams, texture="mip", **kw)
    return depth, seg, shade_mip_plain(code, handoff, cams, mats, pool,
                                       fb_rows=fb_rows, texture=texture,
                                       n_lights=n_lights)


def render_handoff_plain(rows, clusters, cams, *, num_cams: int, n_lights: int,
                         height: int, width: int, seg_div: int,
                         raster: bool = False, geo: str = "prep", order=None,
                         spans=None, bins=None, ranges=None, bin_tile=None, seed=None,
                         dmxu=False, rowskip=False, hits=None):
    """``render_handoff`` in torch ops, on any device (``hits`` as in
    ``render_resident_plain``)."""
    del clusters, order, spans, bins, bin_tile, rowskip  # the plain version sweeps every triangle
    rows, num_cams, geo = _plain_rows(rows, cams, num_cams, geo, ranges, dmxu)
    return _render_plain(rows, cams, num_cams=num_cams, n_lights=n_lights,
                         height=height, width=width, seg_div=seg_div,
                         raster=raster, texture="mip", geo=geo, seed=seed, hits=hits)


def dmxu_rows(rows: torch.Tensor, cams: torch.Tensor, num_cams: int) -> torch.Tensor:
    """Raw rows ``[W, 40, S]`` → each view's rows ``[W·C, 40, S]`` with rows
    0-9 replaced by K11's per-view D = e2 × e1, A = e2 × tv, Q = tv × e1 and
    t_num = e2 · Q (tv = origin − v0; the JAX dmxu prepass, :1876-1903, and
    K12's, ``batched_prepass``): on these the prep sweep is K11's raw sweep,
    term for term."""
    rows_v = rows[torch.arange(cams.shape[0], device=rows.device) // num_cams]
    pre = torch.stack(batched_prepass(rows_v, cams), dim=1)
    return torch.cat([pre, rows_v[:, _N_PREP_ROWS:]], dim=1)


def _plain_chunks(S: int, rays: int):
    """Triangle ranges of the plain sweep, sized so that its ``[rays, K]``
    temporaries hold about 2^25 elements each."""
    k = max(1, min(S, (1 << 25) // max(1, rays)))
    return [(i, min(S, i + k)) for i in range(0, S, k)]


def _plain_sweep(rows, cams, *, num_cams, n_lights, height, width, raster, geo,
                 seed=None) -> PlainHits:
    W, _, S = rows.shape
    WC = W * num_cams
    dev = rows.device
    f32 = torch.float32
    raw = geo != "prep"
    rows_v = rows[torch.arange(WC, device=dev) // num_cams]  # [WC, 40, S]

    def cam(k):  # camera column k → [WC, 1]
        return cams[:, k:k + 1]

    dx, dy, dz = plain_rays(cams, height, width)
    near = cam(14)
    cosf = dx * cam(6) + dy * cam(7) + dz * cam(8)
    t_lo = near / torch.clamp_min(cosf, _F_COS_FLOOR) if raster else near
    P = height * width
    best_t = cam(15).expand(WC, P).clone()
    if seed is not None:  # K9: jnp.minimum(seed, far) (:1205-1209)
        best_t = torch.minimum(seed.reshape(WC, P), best_t)
    best_idx = torch.full((WC, P), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((WC, P), dtype=f32, device=dev)
    best_v = torch.zeros((WC, P), dtype=f32, device=dev)
    origin = (cam(0)[:, None], cam(1)[:, None], cam(2)[:, None]) if raw else None
    d3 = (dx[:, None], dy[:, None], dz[:, None])  # [WC, 1, P]
    shear = wt.shear_select(*d3) if geo in _WATERTIGHT_GEOS else None
    for i0, i1 in _plain_chunks(S, WC * P):
        # The chunk's tests as [WC, K, P]; its winner is the first triangle
        # at its least accepted t, taken on strict <: the running sweep's.
        ok, t, u, v = plain_triangle_test(
            *d3, rows_v[:, :_N_PREP_ROWS, i0:i1, None], t_lo[:, None], None, origin,
            shear)
        t = torch.where(ok, t, torch.inf)
        m = t.amin(1)
        ks = torch.arange(i1 - i0, dtype=torch.int32, device=dev)[None, :, None]
        first = torch.where(t == m[:, None], ks, i1 - i0).amin(1)
        take = m < best_t
        best_t = torch.where(take, m, best_t)
        best_idx = torch.where(take, first + i0, best_idx)
        if raw:
            pick = first.clamp_max(i1 - i0 - 1).long()[:, None]
            best_u = torch.where(take, torch.gather(u, 1, pick)[:, 0], best_u)
            best_v = torch.where(take, torch.gather(v, 1, pick)[:, 0], best_v)

    occluded = []  # per light: the any-hit sweep from the hit points (K8)
    if geo in _SHADOW_GEOS:
        t_hit = torch.where(best_idx >= 0, best_t, 0.0)
        hx = cam(0) + t_hit * dx
        hy = cam(1) + t_hit * dy
        hz = cam(2) + t_hit * dz
        eps_sh = _F_SHADOW_EPS * (1.0 + t_hit)
        for li in range(n_lights):
            c0 = _CAM_LIGHT0 + 6 * li
            sd = (-cam(c0), -cam(c0 + 1), -cam(c0 + 2))
            sd = tuple(c[:, None] for c in sd)
            occ = torch.zeros((WC, P), dtype=torch.bool, device=dev)
            for i0, i1 in _plain_chunks(S, WC * P):
                ok, _, _, _ = plain_triangle_test(
                    *sd, rows_v[:, :_N_PREP_ROWS, i0:i1, None], eps_sh[:, None],
                    origin=(hx[:, None], hy[:, None], hz[:, None]))
                occ = occ | ok.any(1)
            occluded.append(occ)
    return PlainHits(best_t, best_idx, best_u, best_v, tuple(occluded))


def _render_plain(rows, cams, *, num_cams, n_lights, height, width, seg_div,
                  raster, texture, geo, mats=None, pool=None, seed=None, hits=None):
    WC = rows.shape[0] * num_cams
    dev = rows.device
    f32 = torch.float32
    raw = geo != "prep"
    shadows = geo in _SHADOW_GEOS
    rows_v = rows[torch.arange(WC, device=dev) // num_cams]  # [WC, 40, S]

    def cam(k):  # camera column k → [WC, 1]
        return cams[:, k:k + 1]

    dx, dy, dz = plain_rays(cams, height, width)
    cosf = dx * cam(6) + dy * cam(7) + dz * cam(8)
    P = height * width
    if hits is None:
        hits = _plain_sweep(rows, cams, num_cams=num_cams, n_lights=n_lights,
                            height=height, width=width, raster=raster, geo=geo, seed=seed)
    best_t, best_idx, best_u, best_v, occluded = hits
    found = best_idx >= 0
    gidx = best_idx.clamp_min(0).long()

    def gather(k):  # row k of each pixel's winner → [WC, P]
        return torch.gather(rows_v[:, k], 1, gidx)

    def attr(k):  # attribute row k of each pixel's winner, 0 on a miss
        return torch.where(found, gather(_N_GEO_ROWS + k), 0.0)

    if raw:
        # The carried (u, v), clipped (:2739-2742).
        uc = torch.clamp(best_u, 0.0, 1.0)
        vc = torch.clamp(best_v, 0.0, 1.0)
    else:
        # The winner's (u, v) recomputed from its prep rows, as the kernel does.
        det = dx * gather(0) + dy * gather(1) + dz * gather(2)
        inv = torch.where(torch.abs(det) > _F_EPS_DET, 1.0 / det, 0.0)
        uc = torch.clamp((dx * gather(3) + dy * gather(4) + dz * gather(5)) * inv, 0.0, 1.0)
        vc = torch.clamp((dx * gather(6) + dy * gather(7) + dz * gather(8)) * inv, 0.0, 1.0)
    nx = torch.where(found, attr(6) + uc * attr(9) + vc * attr(12), 0.0)
    ny = torch.where(found, attr(7) + uc * attr(10) + vc * attr(13), 0.0)
    nz = torch.where(found, attr(8) + uc * attr(11) + vc * attr(14), 0.0)
    if texture is None:
        base = [attr(16), attr(17), attr(18)]
    else:
        mat = attr(15)
        u = torch.where(found, attr(0) + uc * attr(2) + vc * attr(4), 0.0)
        v = torch.where(found, attr(1) + uc * attr(3) + vc * attr(5), 0.0)
        if texture in shade.FILTERS:
            base = list(shade.sample_texture(mats, pool, mat, u, v, texture))
    ndotd = nx * dx + ny * dy + nz * dz
    flip = torch.where(ndotd > 0, -1.0, 1.0)
    nx = nx * flip
    ny = ny * flip
    nz = nz * flip
    t_hit = torch.where(found, best_t, 0.0)
    z = t_hit * cosf
    if texture == "nine":  # the unshaded outputs, unmasked (:2832-2834, :3664-3670)
        outs = (t_hit, z, best_idx, mat.to(torch.int32), u, v, nx, ny, nz)
        return tuple(x.reshape(WC, height, width) for x in outs)

    n_inv = 1.0 / torch.sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, _F_TINY))
    s = [torch.zeros((WC, P), dtype=f32, device=dev) for _ in range(3)]
    for li in range(n_lights):
        c0 = _CAM_LIGHT0 + 6 * li
        nd = torch.clamp_min(
            -(nx * cam(c0) + ny * cam(c0 + 1) + nz * cam(c0 + 2)) * n_inv, 0.0
        )
        if shadows:
            nd = torch.where(occluded[li], 0.0, nd)
        s = [s[k] + nd * cam(c0 + 3 + k) for k in range(3)]

    shaded_hit = found & (z < cam(_CAM_FAR_Z)) if raster else found
    cam_ok = cam(_cam_valid_col(n_lights)) > 0
    hit = shaded_hit & cam_ok
    if raster:
        depth = torch.where(hit, z, 0.0)
        seg = torch.full_like(best_idx, -1)
    else:
        depth = torch.where(hit, best_t, 0.0)
        seg = torch.where(hit, torch.div(best_idx, seg_div, rounding_mode="floor"), -1)
    shape = (WC, height, width)
    depth, seg = depth.reshape(shape), seg.to(torch.int32).reshape(shape)
    if texture == "mip":
        # The hand-off: the mip level reads t (raster too), 0 on a miss.
        fp = mips.footprint(t_hit, cam(13), height, attr(19))
        code = (mat.to(torch.int32) | torch.where(found, _FOUND_BIT, 0)
                | torch.where(shaded_hit, _SHADED_BIT, 0))
        handoff = torch.stack([u, v, fp, *s]).reshape((_HANDOFF_PLANES,) + shape)
        return depth, seg, code.to(torch.int32).reshape(shape), handoff
    rgb = _pack_rgb(base, s, shaded_hit, cam_ok)
    return depth, seg, rgb.to(torch.int32).reshape(shape)


# --------------------------------------------------------------------- #
# Kernel K12 (the batched kernel, accel="mxu") and its plain version
# --------------------------------------------------------------------- #
def _check_batched(rows, cams, num_cams, n_lights, height, width) -> None:
    _check_tensors(rows, [("cams", cams)])
    if rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous float32 tensor")
    if rows.dim() != 3 or rows.shape[1] != _N_GEO_ROWS + _N_ATTR_ROWS:
        raise ValueError(f"rows must be [W, 40, S], got {tuple(rows.shape)}")
    W = rows.shape[0]
    if cams.shape != (W * num_cams, _n_cam_cols(n_lights)):
        raise ValueError(f"cams must be [{W * num_cams}, {_n_cam_cols(n_lights)}], got "
                         f"{tuple(cams.shape)}")
    if height < 1 or width < 1:
        raise ValueError(f"bad height/width {height}/{width}")


class BatchedPlan(NamedTuple):
    """K12's launch (``batched_plan``): ``pixels`` a thread (1, 2 or 4) of
    a block of ``block`` (x, y) threads on the prepass records, or 0: the
    parent design, one pixel a thread of a 16x16 block; ``blocks`` a view."""

    pixels: int
    block: tuple
    blocks: int


# K12's pixels a thread (csrc/render_batched.cu's records design): 4 ran
# fastest of 1, 2 and 4 on every K12 path's inputs, timed in turns
# (port_tools/dense_plan_ab.py); 0 takes the parent design.
_BATCHED_PIXELS = 4
_BATCHED_BLOCK = (32, 8)
_BATCHED_PIXEL_CHOICES = (0, _BATCHED_PIXELS)


def batched_plan(height: int, width: int, pixels: int = _BATCHED_PIXELS) -> BatchedPlan:
    """K12's launch at this view size: ``pixels`` (4) a thread of a 32 x 8
    block, which covers 32 x 8·pixels of the view (thread (x, y) the pixels
    (x, y + 8q), q < pixels), or with 0 the parent's 16x16 blocks, one
    pixel a thread. ``LaunchPlanError`` for another count, or a view that
    needs more than the grid's 65,535 blocks."""
    if pixels not in _BATCHED_PIXEL_CHOICES:
        raise LaunchPlanError(f"K12 takes {_BATCHED_PIXELS} pixels a thread (0: the parent "
                              f"design), not {pixels}")
    if height < 1 or width < 1:
        raise LaunchPlanError(f"bad view size {height}x{width}")
    if pixels == 0:
        block = (_TILE, _TILE)
        blocks = -(-height // _TILE) * -(-width // _TILE)
    else:
        block = _BATCHED_BLOCK
        blocks = -(-width // block[0]) * -(-height // (block[1] * pixels))
    if blocks > 65535:
        raise LaunchPlanError(f"K12 at {height}x{width} needs {blocks} blocks a view; the "
                              "grid takes 65535")
    return BatchedPlan(pixels, block, blocks)


def batched_cover(height: int, width: int, plan: BatchedPlan) -> torch.Tensor:
    """How many times the kernel's threads on ``plan`` write each pixel of
    a ``height`` x ``width`` view (i32 ``[height, width]``), by the kernel's
    own index arithmetic: every pixel once is the plan's rule."""
    bx, by = plan.block
    rows = by * max(plan.pixels, 1)
    blocks_x = -(-width // bx)
    cover = torch.zeros((height, width), dtype=torch.int32)
    b = torch.arange(plan.blocks)
    tx = torch.arange(bx)
    ty = torch.arange(by)
    for q in range(max(plan.pixels, 1)):
        px = (b % blocks_x * bx)[:, None, None] + tx[None, None, :]
        py = (b // blocks_x * rows)[:, None, None] + ty[None, :, None] + by * q
        px, py = torch.broadcast_tensors(px, py)
        inside = (px < width) & (py < height)
        cover.index_put_((py[inside], px[inside]), torch.ones(int(inside.sum()),
                                                                dtype=torch.int32),
                         accumulate=True)
    return cover


def render_batched(rows, cams, *, num_cams: int, n_lights: int, height: int, width: int,
                   raster: bool = False, nine: bool = False):
    """Kernel K12 (``csrc/render_batched.cu``), the JAX package's batched
    kernel (``accel="mxu"``, ``raytrace_pallas._batched_kernel``): per view
    the pinhole prepass D = e2 × e1, A = e2 × tv, B = tv × e1, t_num = e2 · B
    (tv = origin − v0) of every triangle of K13's raw rows, then for each
    pixel det = d · D, u = (d · A) / det, v = (d · B) / det, t = t_num / det
    (each dot three products summed x, y, z in that order; 1/det once, 0
    where |det| ≤ 1e-10), accepted with the ε slack, t > t_lo and t < far,
    the first minimum in triangle order; the winner's (u, v) recomputed and
    clipped, its normal interpolated and flipped toward the viewer. Returns
    the unmasked ``(t, z, idx, rgb)`` (``nine`` False: lambert + ambient
    over the colour rows, black off a hit; not masked by the camera's
    validity) or ``(t, z, idx, mat, uvx, uvy, nx, ny, nz)`` (``nine``), each
    ``[W·C, height, width]``, t and z 0 and idx -1 on a miss (mat, uv and
    the normal 0), for ``frames_from_core``'s epilogue. ``raster``: the
    per-pixel t_lo = near / max(cos, 1e-6), and a hit past the z-far clip
    shades black.

    Tensors on the card launch the kernel on ``batched_plan``'s launch
    (one add to ``render_batched.launches`` and to the variant's entry of
    ``render_batched.variant_launches``); on the CPU
    ``render_batched_plain`` runs. A view size the plan cannot take raises
    ``LaunchPlanError`` on either device."""
    _check_batched(rows, cams, num_cams, n_lights, height, width)
    plan = batched_plan(height, width)
    kw = dict(num_cams=num_cams, n_lights=n_lights, height=height, width=width,
              raster=raster, nine=nine)
    if rows.device.type == "cpu":
        return render_batched_plain(rows, cams, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"render_batched runs on cuda or cpu, not {rows.device}")
    W, _, S = rows.shape
    WC = W * num_cams
    dev = rows.device
    shape = (WC, height, width)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    # Shaded: z, then rgb; 9-output: the six f32 planes (z, uv, normal) and mat.
    planes = torch.empty(((_NINE_PLANES if nine else 1),) + shape, dtype=torch.float32,
                         device=dev)
    ints = torch.empty(shape, dtype=torch.int32, device=dev)  # rgb, or mat
    launch = _build.load("render_batched")
    with torch.cuda.device(dev):
        err = launch(rows.data_ptr(), cams.data_ptr(), t.data_ptr(), idx.data_ptr(),
                     planes.data_ptr(), ints.data_ptr(), WC, num_cams, S,
                     int(cams.shape[1]), n_lights, height, width,
                     float(np.float32(2.0 / width)), float(np.float32(2.0 / height)),
                     int(raster), int(nine), plan.pixels,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_batched launch failed: {launch.error_string(err)}")
    render_batched.launches += 1
    render_batched.variant_launches[batched_name(raster, nine)] += 1
    if nine:
        return (t, planes[0], idx, ints, *planes[1:])
    return t, planes[0], idx, ints


render_batched.launches = 0
render_batched.variant_launches = dict.fromkeys(BATCHED_VARIANTS, 0)


def batched_prepass(rows_v: torch.Tensor, cams: torch.Tensor) -> list:
    """K12's per-view prepass rows (:3757-3784) from raw rows ``[V, 40, S]``
    and each view's camera origin: D = e2 × e1 (0-2), A = e2 × tv (3-5),
    B = tv × e1 (6-8), t_num = e2 · B (9), each ``[V, S]``."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows_v[:, :9].unbind(1)
    tvx = cams[:, 0:1] - v0x
    tvy = cams[:, 1:2] - v0y
    tvz = cams[:, 2:3] - v0z
    bx = tvy * e1z - tvz * e1y
    by = tvz * e1x - tvx * e1z
    bz = tvx * e1y - tvy * e1x
    return [
        e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z, e2x * e1y - e2y * e1x,
        e2y * tvz - e2z * tvy, e2z * tvx - e2x * tvz, e2x * tvy - e2y * tvx,
        bx, by, bz,
        e2x * bx + e2y * by + e2z * bz,
    ]


def _batched_test(pre, dx, dy, dz):
    """K12's numerators and divide on prepass rows ``pre`` (ten tensors that
    broadcast against the rays): det, u, v and t (:3838-3853)."""
    det = (pre[0] * dx + pre[1] * dy) + pre[2] * dz
    inv = torch.where(torch.abs(det) > _F_EPS_DET, 1.0 / det, 0.0)
    u = ((pre[3] * dx + pre[4] * dy) + pre[5] * dz) * inv
    v = ((pre[6] * dx + pre[7] * dy) + pre[8] * dz) * inv
    return u, v, pre[9] * inv


def render_batched_plain(rows, cams, *, num_cams: int, n_lights: int, height: int,
                         width: int, raster: bool = False, nine: bool = False):
    """``render_batched`` in torch ops, on any device: the kernel's
    expressions in its order (the numerators as three products summed x, y,
    z, not a matmul, whose summation order is not the kernel's), the sweep
    in ascending chunks (first minimum within a chunk, strict < across:
    the first minimum in triangle order), the winner's prepass and
    attribute rows gathered by index (the JAX one-hot resolve's values)."""
    W, _, S = rows.shape
    WC = W * num_cams
    dev = rows.device
    rows_v = rows[torch.arange(WC, device=dev) // num_cams]  # [WC, 40, S]

    def cam(k):
        return cams[:, k:k + 1]

    dx, dy, dz = plain_rays(cams, height, width)
    cosf = dx * cam(6) + dy * cam(7) + dz * cam(8)
    t_lo = near_bound = cam(14)
    if raster:
        t_lo = near_bound / torch.clamp_min(cosf, _F_COS_FLOOR)
    pre = batched_prepass(rows_v, cams)
    P = height * width
    best_t = cam(15).expand(WC, P).clone()
    best_idx = torch.full((WC, P), -1, dtype=torch.int32, device=dev)
    d3 = (dx[:, None], dy[:, None], dz[:, None])  # [WC, 1, P]
    for i0, i1 in _plain_chunks(S, WC * P):
        u, v, t = _batched_test([r[:, i0:i1, None] for r in pre], *d3)
        ok = ((u >= -_F_EPS_BARY) & (v >= -_F_EPS_BARY) & (u + v <= _F_ONE_PLUS_EPS)
              & (t > t_lo[:, None]))
        t = torch.where(ok, t, torch.inf)
        m = t.amin(1)
        ks = torch.arange(i1 - i0, dtype=torch.int32, device=dev)[None, :, None]
        first = torch.where(t == m[:, None], ks, i1 - i0).amin(1)
        take = m < best_t
        best_t = torch.where(take, m, best_t)
        best_idx = torch.where(take, first + i0, best_idx)
    found = best_idx >= 0
    gidx = best_idx.clamp_min(0).long()

    def win(x):  # a [WC, S] row of each pixel's winner, 0 on a miss
        return torch.where(found, torch.gather(x, 1, gidx), 0.0)

    def attr(k):
        return win(rows_v[:, _N_GEO_ROWS + k])

    u, v, _ = _batched_test([win(r) for r in pre], dx, dy, dz)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = torch.clamp(v, 0.0, 1.0)
    nx = attr(6) + uc * attr(9) + vc * attr(12)
    ny = attr(7) + uc * attr(10) + vc * attr(13)
    nz = attr(8) + uc * attr(11) + vc * attr(14)
    flip = torch.where(nx * dx + ny * dy + nz * dz > 0, -1.0, 1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    t_hit = torch.where(found, best_t, 0.0)
    z = t_hit * cosf
    shape = (WC, height, width)
    if nine:
        outs = (t_hit, z, best_idx, attr(15).to(torch.int32),
                attr(0) + uc * attr(2) + vc * attr(4), attr(1) + uc * attr(3) + vc * attr(5),
                nx, ny, nz)
        return tuple(x.reshape(shape) for x in outs)
    n_inv = 1.0 / torch.sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, _F_TINY))
    s = [torch.zeros_like(nx) for _ in range(3)]
    for li in range(n_lights):
        c0 = _CAM_LIGHT0 + 6 * li
        nd = torch.clamp_min(-(nx * cam(c0) + ny * cam(c0 + 1) + nz * cam(c0 + 2)) * n_inv,
                             0.0)
        s = [s[k] + nd * cam(c0 + 3 + k) for k in range(3)]
    hit = found & (z < cam(_CAM_FAR_Z)) if raster else found
    rgb = _pack_rgb([attr(16), attr(17), attr(18)], s, hit)
    return t_hit.reshape(shape), z.reshape(shape), best_idx.reshape(shape), \
        rgb.to(torch.int32).reshape(shape)


# --------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------- #
def render_core(state: SimState, scene: SceneData, *, height: int, width: int,
                near: float = 0.1, far: float = 1000.0,
                fov_y_degrees: float = 90.0, raster: bool = False,
                texture_filter: str = "nearest", shadows: bool = False,
                watertight: bool = False, accel: str = "auto", seed_t=None,
                deferred_mxu: bool = False) -> tuple:
    """Prologue + kernel (or its plain version on the CPU). Returns the
    kernel's outputs, each ``[W·C, height, width]``: ``(depth, segmask,
    rgb_packed)`` in their final masked form on the fused routes,
    ``(t, z, idx, rgb)`` from K12 on untextured scenes (``accel="mxu"``), or
    the 9-output route's ``(t, z, idx, mat, uvx, uvy, nx, ny, nz)``
    (``output_mode``); ``frames_from_core`` finishes each. ``accel`` picks
    the route (``visit_route``); every culled visit gives the same frames.
    ``seed_t`` (K9, the JAX ``render_core``'s, :4146-4158): a per-pixel
    upper bound on the hit t, ``[W, C, height, width]`` (or any shape of as
    many values), each pixel's search window ``min(seed, far)``: a pixel
    whose nearest hit lies at or beyond its seed renders as a miss; with
    ``accel="mxu"`` a ``ValueError``. ``deferred_mxu``: K11 on the streamed
    visits where the JAX package's ``MRT_DEFERRED_MXU=1`` takes it
    (``dmxu_route``), ignored elsewhere; the same frames."""
    if seed_t is not None:
        check_seedable(accel)
    kw = pack_inputs(state, scene, height=height, width=width, near=near,
                     far=far, fov_y_degrees=fov_y_degrees, raster=raster,
                     texture_filter=texture_filter, shadows=shadows,
                     watertight=watertight, accel=accel, deferred_mxu=deferred_mxu)
    if accel == "mxu":
        return render_batched(**kw)
    views = int(kw["cams"].shape[0])
    seed = None if seed_t is None else (
        seed_t.to(torch.float32).reshape(views, height, width).contiguous())
    return render_resident(**kw, seed=seed)


def frames_from_core(state: SimState, *outs, scene: SceneData | None = None,
                     raster: bool = False, far: float = 1000.0,
                     fov_y_degrees: float = 90.0, texture_filter: str = "nearest",
                     shadows: bool = False) -> Frames:
    """Kernel outputs ``[W·C, H, Wd]`` → padded ``Frames [W, C, H, Wd, …]``
    (the JAX ``_frames_from_core``, :4962-5018). The fused routes' three
    outputs are final: a reshape. Else a pixel is a hit where idx ≥ 0, in
    raster mode z < ``far`` too, and its camera is valid; K12's rgb
    ``(t, z, idx, rgb)`` reads opaque black for an invalid camera; the
    9-output route's ``(t, z, idx, mat, uvx, uvy, nx, ny, nz)`` is shaded
    by ``shade.shade_lambert_planar`` on ``scene`` (``texture_filter``), with
    ``shadows`` each light's visibility from ``compute_lit`` at the points
    camera origin + t · ``camera_ray_dirs`` (at the cameras' fov, else
    ``fov_y_degrees``). Depth is t (raster: z) on a hit, else 0; segmask
    idx // tris_per_object on a hit, else -1 (raster: -1)."""
    W, C = state.camera_pos.shape[:2]
    H, Wd = outs[0].shape[1:]
    if len(outs) == 3:
        depth, seg, rgb = outs
        return Frames(
            rgb=packed_to_rgba8(rgb).reshape(W, C, H, Wd, 4),
            depth=depth.reshape(W, C, H, Wd),
            segmask=seg.reshape(W, C, H, Wd),
        )
    t, z, idx = (x.reshape(W, C, H * Wd) for x in outs[:3])
    hit = idx >= 0
    if raster:
        hit = hit & (z < float(np.float32(far)))
    cam_ok = state.camera_valid[:, :, None] > 0.0
    hit = hit & cam_ok
    if len(outs) == 4:
        packed = torch.where(cam_ok, outs[3].reshape(W, C, H * Wd), _ALPHA)
    else:
        lit = None
        if shadows:
            soup = build_world_soup(state, scene)
            eff_fov = torch.where(state.camera_fov > 0, state.camera_fov, fov_y_degrees)
            dirs = camera_ray_dirs(state.camera_rot, H, Wd, eff_fov)
            points = state.camera_pos[:, :, None, :] + t[..., None] * dirs
            lit = compute_lit(soup, scene, points, t)
        mat, uvx, uvy, nx, ny, nz = (x.reshape(W, C, H * Wd) for x in outs[3:])
        packed = shade.shade_lambert_planar(scene, mat, uvx, uvy, nx, ny, nz, hit,
                                            texture_filter, lit=lit)
    depth = torch.where(hit, z if raster else t, 0.0)
    if raster:
        seg = torch.full_like(idx, -1)
    else:
        seg = torch.where(hit, torch.div(idx, scene.tris_per_object, rounding_mode="floor"),
                          -1)
    return Frames(
        rgb=packed_to_rgba8(packed.to(torch.int32)).reshape(W, C, H, Wd, 4),
        depth=depth.reshape(W, C, H, Wd),
        segmask=seg.to(torch.int32).reshape(W, C, H, Wd),
    )


def raytrace(state: SimState, scene: SceneData, *, height: int, width: int,
             near: float = 0.1, far: float = 1000.0,
             fov_y_degrees: float = 90.0,
             texture_filter: str = "nearest", shadows: bool = False,
             watertight: bool = False, accel: str = "auto", seed_t=None,
             deferred_mxu: bool = False) -> Frames:
    """Render every (world, camera) view → padded ``Frames``; invalid
    camera slots render black/0/-1; ``shadows`` casts one shadow ray per
    (pixel, light); ``watertight`` decides hits by the crack-free Woop test
    (``ops/watertight.py``); ``accel``, ``seed_t`` and ``deferred_mxu`` as
    in ``render_core``.
    The counterpart of ``raytrace_pallas.raytrace`` (:5043-5064) /
    ``raytrace_ref.raytrace``."""
    return frames_from_core(state, *render_core(
        state, scene, height=height, width=width, near=near, far=far,
        fov_y_degrees=fov_y_degrees, texture_filter=texture_filter,
        shadows=shadows, watertight=watertight, accel=accel, seed_t=seed_t,
        deferred_mxu=deferred_mxu,
    ), scene=scene, far=far, fov_y_degrees=fov_y_degrees, texture_filter=texture_filter,
        shadows=shadows)
