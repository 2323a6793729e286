"""GPU smoke run of the PyTorch/CUDA port (madrona_renderer_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc). Phases, each
printed as JSON lines:

  1. env     — Python/torch/CUDA versions, the card's name and power limit;
  2. build   — every kernel under madrona_renderer_tpu_torch/csrc, one nvcc
               per source, all started together; the GPU health ladder
               (madrona_renderer_tpu_torch/ladder.py, the port of
               tools/tpu_ladder.py: a torch op and the probes L1-L3 beside
               the build, then the quad scene, the demo fleet and 256-world
               steps), each rung in a process of its own, a ``ladder`` line
               per rung, and L1-L3 on the tool's inputs against their plain
               versions here;
  3. kernel_vs_plain — each kernel against its plain PyTorch version on the
               same CUDA inputs at 64 worlds: the fused pack K13 in both
               layouts (``pack_rows`` prep, ``pack_rows_raw``, bitwise) and
               every variant of the render kernel (prep / raw / raw with
               shadows, and K10's watertight raw / raw with shadows, bitwise
               x raytrace / raster x untextured / nearest / bilinear), each
               through the four resident visits (K1's index order, K3 and
               K4 on resident rows: ``render_resident_ordered*``,
               ``render_resident_binned*``, and K1-none: ``render_none*``)
               and, raytraced, each of those seeded (K9, ``*_seeded*``: per
               pixel far, just above the hit, at it or at half of it), the
               9-output mode (``*_nine``) of K1 and K1-none on the prep,
               raw and K10 rows, seeded too, and K12 (``render_batched*``,
               shaded and 9-output, raytrace and raster; on the occluder
               scenes the mxu route's shadow epilogue), all bitwise (a plain
               output that several checks share is computed once), on the
               demo scene with one and with four cameras per world
               (untextured and textured), random scenes (padded triangle
               slots; one with 1-3 cameras per world, per-camera fov and
               znear), the demo scene at 40x24 with two lights, the occluder
               scene of tests/test_shadows.py with one and with two lights,
               the quad-seam scene of tests/test_watertight_pallas.py
               split across two instances and in one (a ``seam`` line counts
               the crack pixels inside the quad: none), each without and
               with shadows, and the resident terrain (bench.py's big-mesh
               scene at a 27 grid, varied per world) at 64x64 and at
               128x128, the bin tiling of its 128x128 path; then K7 (the render
               kernel's mip
               hand-off and ``shade_mip``) bitwise, together and each alone,
               in every variant (prep / raw / raw with shadows x raytrace /
               raster x nearest / bilinear / trilinear) on the mip scenes of
               tests/test_mips.py (the gradient floor with a close-up quad,
               also at 64x256 and with two cameras; the overflow floor; the
               uv-seam close-up at 48x48; the close-up whose trilinear blend
               dies; trilinear, with and without K10, through the four
               resident visits and seeded), with a
               ``k7_levels`` line per scene: pixels per level, pixels
               clamped to the coarse chain, blends killed; then every
               variant of the streamed route (K3 + K5, ``render_streamed*``;
               K10's on the untextured, 32x32-textured and mip-mapped terrain
               and the tie scene; K9's seeded ones on the terrain scenes and
               the tie scene) bitwise on bench.py's big-mesh scene with a
               per-world terrain yaw and cube position (also with two
               cameras, a 32x32 texture and a 256x256 mip-mapped one), on the
               streamed scenes of tests/test_pallas_parity.py and
               tests/test_shadows.py, and on the tie scene (exact-t ties
               across clusters go to the lower index, a ``tie`` line counts
               the pixels); each of those again with accel="binned": every
               variant of the binned visit (K4, ``render_binned*``) bitwise
               (a ``tie`` line under bins too); every geometry variant of K4
               on 4 worlds of the binned terrain at 128x128 bitwise against
               its plain version and against K5 (``k4_vs_k5`` lines); the
               seam scene made streamed under bins (a ``seam`` line);
               K11 (deferred_mxu, ``render_*_dmxu*``) in every mode of the
               streamed scenes without shadows or watertight, on both
               visits, seeded too, bitwise against its plain version, its
               replayed walk (``walk_vs_kernel``) and on prep rows the
               route's kernel (``dmxu_vs_k5`` / ``dmxu_vs_k4``), with its
               row gate on the varied terrain at 64x256 (one and two
               cameras; ``rowskip_off`` lines), and on the 128x128 terrain;
               the 9-output mode (``*_nine``) of every culled visit, bitwise
               in all nine planes: K3 and K4 on resident rows on the 27-grid
               terrain textured with the 256x256 checker baked without mips
               (``terrain27_64_tex256``; the epilogue's shadows on their
               outputs, ``nine_shadows`` lines), K3 + K5, K4 and K11 on the
               72-grid one (``bigmesh64_tex256``; K11 on raw rows too), each
               seeded too in the raytrace conventions, and K4 and K11's
               binned visit, its row gate on and off, on 4 worlds of the
               textured binned terrain at 128x128 (``terrain4_128_tex256``);
               every check of a binned entry on the tile groups (K4 and K11
               on the streamed binned walk's prep rows, csrc/render_binned.cu:
               cold, seeded, raster, mip hand-off and 9-output) also holds it at
               forced plans, G = 1, 2 and 4 tile groups with B = 1 and the
               plan's blocks a view, and against the parent design
               (render_body's 16x16 blocks, a plan of 0 groups), bitwise
               (``plans_vs_kernel`` lines; at the binned paths' full size
               too); so is every check of K11 on the streamed ordered walk
               (its tile groups, csrc/render_dmxu.cu: prep and raw rows,
               cold, seeded, raster, mip hand-off and 9-output, the row
               gate on and off) at raytrace_cuda.streamed_plan's forced
               plans and against its parent design, and every check of K12
               on its records (4 pixels a thread) and in its parent design
               (one a thread of a 16x16 block: a plan of 0 pixels), and
               every check of K1 and K6 on the index visit's tile teams
               (prep rows, raytraced, untextured, nearest or bilinear), of
               K7 folded into them (the mip render on prep rows,
               csrc/render_mip.cu), of K8 on them (raw rows with shadows),
               of K1-raw on them (raw rows without shadows), of K1's
               9-output mode on them (prep rows, csrc/render_none.cu), of
               K10 on them (raw rows, the watertight decision), of
               K1-none on them (prep and K10 rows, no cluster table,
               csrc/render_none.cu) and of K2 and K2+K6 on them (prep
               rows, the raster conventions) at raytrace_cuda.index_plan's
               forced plans, G = 1 and 2, and in its parent design
               (``g0``; K7's two launches), a forced plan whose block does
               not fit recorded as refused, with the entry's occupancy
               (``index_occupancy`` lines; fails where its registers are
               not the ones index_plan counts blocks by,
               raytrace_cuda._INDEX_REGS, by index_entry_key);
               a mode's texture filters share its inputs and seed, so their
               variants share one plain sweep (raytrace_cuda.plain_hits),
               and inputs equal in geometry, cameras, visit and seed share
               the walk replayed for the timing lines' bounds;
  4. paths   — the twenty-four paths of the port, each through MadronaRenderer and
               stepped with a position mutation through the exported tensor
               between steps, with every launch count set to 0 just before
               and read just after:
                 main             demo_config, 4096 worlds x 64x64,
                                  raytraced;
                 textured_4096w   the same with the 32x32 PNG checkerboard,
                                  nearest filtering;
                 watertight_4096w bench.py:314, textured_4096w with
                                  watertight=True (K10 on the raw rows;
                                  beside it K1-raw's ε-slack sweep on the
                                  same rows, a ``wt_vs_eps`` line);
                 textured_4096w_ssaa2 bench.py:309, textured_4096w with
                                  ssaa=2 (K6 at 128x128, the box filter
                                  to 64x64);
                 raster_256w_png  256 worlds x 64x64 of the textured cube,
                                  RenderMode.Rasterizer (K2+K6 on the index
                                  visit's teams, blocks of two groups;
                                  nearest and bilinear on its inputs at full
                                  size and on 64 of its worlds at every
                                  forced plan);
                 multicam_1024w4c 1024 worlds x 4 cameras x 64x64 (4096
                                  views), raytraced on the raw rows
                                  (K1-raw on the index visit's teams);
                 shadows_4096w    main with shadows=True (raw rows and one
                                  shadow ray per pixel and light);
                 textured256_4096w bench.py's paged-texture row: 4096 worlds
                                  x 64x64 of a cube and a plane both
                                  textured with a 256x256 checker, which
                                  bakes mip chains (K7, nearest);
                 bigmesh_512w     bench.py's big-mesh row: 512 worlds x
                                  64x64 of a 10,368-triangle terrain and a
                                  cube (S = 20,736 triangles per world, past
                                  the resident budget: K3 + K5, with the
                                  walk replayed in torch ops, its frames
                                  held to the exports and its work counted,
                                  the step's device time and idle share);
                                  it, bigmesh_512w_warm, bigmesh_512w_tex256
                                  and the binned terrain paths' K5 A/B each
                                  print a ``streamed_occupancy`` line: the
                                  streamed ordered entry's tile groups and
                                  blocks a view, threads, registers, local
                                  memory, shared memory, blocks and warps
                                  per SM;
                 bigmesh_512w_warm bench.py:322-324, bigmesh_512w with
                                  warmstart=True: the streamed walk seeded
                                  (K9) by the previous depth, repaired where
                                  it misses; every step's frames bitwise a
                                  cold render's, the last step's seeded
                                  inputs bitwise against the seeded plain
                                  version, the replayed walk's work cold and
                                  seeded, beside bigmesh_512w's cold steps;
                 resident_terrain_4096w_64, resident_terrain_1024w_128
                                  bench.py's big-mesh scene at a 27 grid
                                  (S = 2,928: resident, 366 clusters) at
                                  4096 worlds x 64² ("auto" orders: K3 on
                                  resident rows) and 1024 x 128² (bins: K4
                                  on resident rows), world 0's cube moved
                                  each step; the three visits on the last
                                  step's inputs bitwise equal to the plain
                                  version and the exports, each timed step's inputs
                                  through the three at the kernel entry (the
                                  A/B), the replayed walks' work, and a
                                  ``resident_occupancy`` line: the path
                                  entry's tile groups, threads, registers,
                                  shared memory, blocks and warps per SM;
                 binned_32w_128, binned_32w_256, terrain_32w_512
                                  tools/tpu_binned_bench.py's scene (32
                                  worlds of the 100,352-triangle terrain)
                                  at 128x128 and 256x256 with accel="auto",
                                  and bench.py:505-546's health anchor at
                                  512x512 with accel="binned": K4, each step
                                  turning every terrain through the
                                  exported rotation tensor; K4 against K5
                                  bitwise at full size (against the plain
                                  version too at 128x128), the replayed
                                  binned walk against the exports, the
                                  bins' and the row sort's bytes and device
                                  times, the step's device time from a
                                  profiler trace, and the same steps with
                                  accel="clusters" (K5) beside them; a
                                  ``binned_occupancy`` line: the binned
                                  entry's tile groups and blocks a view,
                                  threads, registers, local memory, shared
                                  memory, blocks and warps per SM;
                 mxu_4096w, mxu_4096w_128
                                  tools/tpu_accel_compare.py's defaults:
                                  the demo scene, 4096 worlds at 64x64 and
                                  128x128, accel="mxu" (K12, the 4-output
                                  epilogue), every instance turned about z
                                  each step as the tool's rollout does; the
                                  same steps through "auto" (K1) beside
                                  them, each timed step's inputs through
                                  both kernels (and K12's parent design),
                                  and (64x64) a ``mxu_vs_k1``
                                  line: the frames' largest rgb and
                                  relative depth differences and segmask
                                  mismatches (a report: the two round
                                  otherwise);
                 none_4096w       tools/tpu_opt_probe.py:69-72 (accel=
                                  "none": K1-none), every step's frames
                                  bitwise K1's, the "clusters" steps beside;
                 textured_4096w_mxu bench.py:291's scene with accel="mxu":
                                  K12's 9-output mode and the planar
                                  shading epilogue;
                 tex256_cliff_4096w tools/tpu_paged_tex_bench.py:167: the
                                  256x256 texture baked without mips, K1's
                                  9-output mode (on the index visit's
                                  teams) and the epilogue, the same
                                  loop on the mip-mapped bake (K7) beside;
               each of these five with the kernel and the epilogue on the
               last step's inputs equal to the exports, the step's device
               time and idle share from the profiler and the epilogue's
               time;
                 dmxu_32w_512     tools/tpu_dmxu_bench.py's defaults: 32
                                  worlds of the binned terrain at 512x512,
                                  accel="binned", deferred_mxu=True (K11
                                  with its row gate), the tools' loop; each
                                  step's state through K4 bitwise
                                  (``dmxu_vs_k4``) and both timed at the
                                  kernel entry, the replayed walk against
                                  the exports, the rowskip=False launch, the
                                  forced plans and the parent design, a
                                  ``binned_occupancy`` line, the
                                  tool's 128x128 check against the plain
                                  version; terrain_32w_512's steps are its
                                  K4 A/B;
                 bigmesh_512w_dmxu bigmesh_512w with deferred_mxu=True (K11
                                  on the ordered walk's tile groups, no row
                                  gate at 64x64), every step's state through
                                  K5 bitwise (``dmxu_vs_k5``) and timed with
                                  K11's parent design beside, the forced
                                  plans at full size, a
                                  ``streamed_occupancy`` line, bigmesh_512w's
                                  steps its A/B;
                 bigmesh_512w_tex256 bigmesh_512w with the terrain textured
                                  by the 256x256 checker baked without mips
                                  (``mipmaps=False``): K3 + K5's 9-output
                                  mode and the planar epilogue; the same
                                  steps with deferred_mxu=True (K11's 9-output
                                  mode), each step's state through both at the
                                  kernel entry, the nine planes bitwise;
                 resident_terrain_4096w_64_tex256 resident_terrain_4096w_64
                                  textured the same way: K3's 9-output mode on
                                  resident rows (a ``resident_occupancy``
                                  line); each step's state through K4 on
                                  resident rows (accel="binned") too;
               these two with the kernel and the epilogue on the last step's
               inputs equal to the exports, the device time, idle share and
               epilogue time, and both visits against the plain version at
               full size;
               then, on each path's last inputs at full size, the kernels
               (under SSAA, filtered down) against the exported frames and
               their plain versions (and
               for shadows_4096w the unshadowed render of the same rows:
               rgb darker somewhere, depth and segmask bitwise; for
               textured256_4096w every K7 variant on its inputs); one line
               per path (phase = its name) with the step and prologue times
               on the host clock and the prologue's operator count;
  5. timing  — each kernel at its path's full-size inputs (K4's
               ``render_binned`` on binned_32w_128's, its other variants on
               the 64-world inputs of their first scene of phase 3; K10's
               untextured variants on main's, its textured ones on
               watertight_4096w's): its device time in a CUDA graph of
               back-to-back launches, its time through
               the wrapper (host overhead included), its plain version's
               time (on inputs a check ran on, the check's own cold call),
               its bound (from the walk the data makes, replayed by
               ops/walk_replay.py: K1's culls, or the positions gated, the
               clusters streamed, the slab and triangle tests; the streamed
               variants that
               bigmesh_512w does not run are timed on the 64-world inputs of
               their first scene of phase 3); then, in lines with an
               ``inputs`` key that
               the kernels line leaves out, K13's raw layout on
               multicam_1024w4c's 1024 worlds, the raw sweep on main's
               one-camera rows (beside a ``prep_vs_raw`` line of phase 4
               that compares its frames with the prep sweep's), and each
               K7 variant's two launches together on textured256_4096w's
               inputs (for the folded ones, their A/B: the kernels line has
               render_mip_<filter> rows, timed in turns with them, both
               against k7_bound, the function's own bytes), the parent
               design of K8, K10, K1-none, K1's 9-output mode and K1-raw
               in turns with their team entries on shadows_4096w's,
               watertight_4096w's, none_4096w's, tex256_cliff_4096w's and
               multicam_1024w4c's inputs (``"ab": "parent"`` lines), K1-raw on
               watertight_4096w's rows, the ssaa path's
               kernel at 128x128 and its filter (torch ops: time and bound),
               and K4 and K5 on each terrain path's inputs (K4's bound from
               the replayed binned walk; at 256x256 and 512x512 no plain
               time; K5 without a bound, its walk's replay would take
               minutes); this slice's kernels (K3 and K4 on resident rows,
               K9) on their path's full-size inputs or the 64-world inputs
               of their first check, 10 launches a graph, their bounds from
               the replayed walks (ops/walk_replay.py, seeded where they
               are), and the visits a resident terrain path does not take on
               its inputs; the ninth slice's (K1-none, the 9-output mode,
               K12) likewise, their bounds counted from every triangle test
               (K12 at 128x128 on mxu_4096w_128's inputs), and the shadow
               epilogue (compute_lit, torch ops) on shadows_4096w's inputs
               in a line of its own; K11's entries (the
               paths' own, render_binned_dmxu on dmxu_32w_512's 128x128
               inputs, the others on 64 worlds) with bounds from
               walk_replay.dmxu_walk's (triangle, pixel) tests, K11 at 512x512
               with and without its row gate and with its row gate on the
               ordered walk at 64x256 in lines of their own, and L1-L3 on
               the tool's inputs beside their library calls; the 9-output
               entries of the culled visits on their path's full-size inputs
               or the inputs of their first check; the binned walk's lines
               carry its plan (tile groups, blocks a view), K1's its tile
               groups; K1 at 128x128 on mxu_4096w_128's "auto" inputs is a
               row of its own, ``render_resident@128``, with those steps'
               launches (the 64x64 row keeps the others);

then the nvidia-smi line, the ``kernels`` summary line and the result line
``{"ok": true, "device": {...}}``. Any failed check raises: the script then
exits non-zero and prints no result. Without a card it exits non-zero at
once.
"""

from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

NUM_WORLDS = 4096
RASTER_WORLDS = 256
MULTICAM_WORLDS = 1024
MULTICAM_CAMS = 4
HEIGHT = WIDTH = 64
TEX_SIZE = 32
WARMUP_STEPS = 3
# Timed steps of every path (20 and 60 before the ninth slice made room for
# its five paths: the paths' steps are a small part of the run).
TIMED_STEPS = 10
RASTER_TIMED_STEPS = 30
PAGED_TEX_SIZE = 256
BIGMESH_WORLDS = 512
# The binned terrain paths (tools/tpu_binned_bench.py, bench.py:505-546):
# 32 worlds of the 224-grid terrain at each size; the variant checks at 4.
TERRAIN_WORLDS = 32
TERRAIN_CHECK_WORLDS = 4
TERRAIN_PATHS = (("binned_32w_128", 128, "auto"), ("binned_32w_256", 256, "auto"),
                 ("terrain_32w_512", 512, "binned"))
MIP_FILTERS = ("nearest", "bilinear", "trilinear")
# The light of the 9-output scenes' shadow checks (the epilogue's
# compute_lit): the cube's shadow falls on the terrain.
NINE_SUN = [((0.5, 1.0, -1.0), (1.0, 1.0, 1.0))]
KERNEL_REPS = 50
SMALL_WORLDS = 64
SSAA = 2
# The resident terrain paths: bench.py's big-mesh scene at a 27 grid (1,458
# terrain triangles and the cube: S = 2,928 slots, 366 clusters of 8, 374,784
# bytes of the JAX kernel's rows, within the 384 KB resident budget): 4096
# worlds at 64² (ordered: one TPU tile) and 1024 at 128² (binned: 4 tiles).
RESIDENT_GRID = 27
RESIDENT_PATHS = (("resident_terrain_4096w_64", 4096, 64, "ordered"),
                  ("resident_terrain_1024w_128", 1024, 128, "binned"))
# The timing lines of the entries off the paths (the resident visits', the
# seeded ones, K1-none's, the 9-output mode's, K12's raster ones, and the
# streamed entries on 64 worlds): fewer launches a CUDA graph.
NEW_KERNEL_REPS = 10
# This slice's paths (tools/tpu_accel_compare.py, tools/tpu_opt_probe.py,
# bench.py:291, tools/tpu_paged_tex_bench.py:167): every instance turned by
# dq about z each step, as the tools' rollouts do (half-angle 0.015, the
# paged-texture tool's 0.01).
TOOL_HALF_ANGLE = 0.015
PAGED_HALF_ANGLE = 0.01
MXU_RESOLUTIONS = (64, 128)
# K11's binned path (tools/tpu_dmxu_bench.py: 32 worlds of the
# binned terrain at 512²) and the terrain path whose steps are its K4 A/B.
DMXU_RES = 512
DMXU_K4_PATH = "terrain_32w_512"
# K11's row-gate checks on 64 worlds: 2 TPU tiles across (tile_geometry).
ROWSKIP_SIZE = (64, 256)

# H100 SXM peaks (NVIDIA data sheet). The published 67 TFLOP/s of FP32
# outside the tensor cores counts a fused multiply-add as two operations
# (132 SMs x 128 lanes x 2 x 1.98 GHz). The kernels are built with
# --fmad=false, so each operation counted below issues as an instruction of
# its own: their peak is half of that.
PEAK_FP32_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12
# int32 add, shift and logic: 64 lanes an SM (Hopper white paper) at the
# same 1.98 GHz.
PEAK_INT32_OPS = 132 * 64 * 1.98e9

# The render kernel's FP32 operations, counted from
# csrc/render_resident.cu (add, sub, mul, div, sqrt, floor, min, max,
# compare and float<->int conversion count one each, though an IEEE divide
# or square root takes several instructions, so the bound is a floor): per
# thread, ray generation 30 + direction inverses 9 + winner resolve 36
# (raw: 16, the carried u, v are only clipped) + flip 9 + shading 29 + 14
# per light; per thread and cluster, the slab test 25; per triangle test
# 27 on prep rows, 36 on raw rows (the pvec 9, det 5, 1/det 3, u 6, v 6,
# t 1, acceptance 6), whose tv, q and t_num (17) a block computes once per
# triangle. Shadows add per thread the hit point and the bias (8), per
# light the occlusion select (4), per light and cluster the slab test (24),
# and per shadow triangle test 52; of these the light's direction and its
# inverses (12 per light) and the shadow test's pvec, det and 1/det (17 per
# light and triangle) are the same for every thread, so the work needs the
# first once per view and the second once per visiting block: the bound
# charges them so, and each thread 35 per shadow triangle test.
# The raster variant adds the cosine, its floor, the t-space near bound, z
# and the far clip (9); the textured variants add the uv resolve (8), the
# material lookup (4), the wrap (4) and the sample: nearest 11 (two
# products, two conversions, three dequant divides, three colour products,
# 1 - v), bilinear 62 (the texel-centre offsets, floors, weights and
# conversions 14, twelve dequant divides, three lerps of 12, three colour
# products).
# K10 (the watertight sweeps, csrc/render_resident.cu GEO raw_wt and
# raw_wt_shadows) per thread adds the shear frame (3 compares, the
# reciprocal, 2 products: 6) and the winner's Möller–Trumbore (u, v) in the
# resolve (tv 3, q 9, t_num 5, the pvec 9, det 5, 1/det 2, u 6, v 6, t 1:
# 46) to the raw resolve's; per triangle test 43 (the three vertices'
# shears 15, the edge functions 9, det 2, the det and sign compares 7, t 6
# and its reciprocal 1, the validity and t-window compares 3; the 18
# component selects are not counted), whose a, b, c (9 adds) a block
# computes once per triangle.
K1_OPS_FIXED = {"prep": 113, "raw": 113 - 20, "wt": 113 - 20 + 6 + 46}
K1_OPS_PER_LIGHT = 14
K1_OPS_PER_CLUSTER = 25
K1_OPS_PER_TRIANGLE = {"prep": 27, "raw": 36, "wt": 43}
K1_OPS_HOIST = {"prep": 0, "raw": 17, "wt": 9}
K1_OPS_RASTER = 9
K1_OPS_TEX = {None: 0, "nearest": 8 + 4 + 4 + 11, "bilinear": 8 + 4 + 4 + 62,
              "mip": 8 + 3,  # the mip hand-off: uv, and the footprint's 3 products
              "nine": 8 + 4}  # the 9-output mode: uv and the material
K8_OPS_FIXED = 8
K8_OPS_PER_LIGHT = 4
K8_OPS_PER_CLUSTER = 24
K8_OPS_PER_TRIANGLE = 52 - 17
K8_OPS_PER_VIEW_LIGHT = 12
K8_OPS_PER_BLOCK_TRIANGLE = 17
K1_THREADS_PER_BLOCK = 256
# Rows of the pack each block reads (the geometry rows) and each hit reads
# once (the normal rows, and the colour rows (untextured) or the material
# and uv rows (textured)).
K1_GEO_ROWS = {"prep": 10, "raw": 9, "wt": 10}
K1_ATTR_ROWS = {None: 9 + 3, "nearest": 9 + 7, "bilinear": 9 + 7, "mip": 9 + 8,
                "nine": 9 + 7}
# Bytes a pixel writes: depth, segmask and rgb; in the mip hand-off mode
# depth, segmask and the 28-byte hand-off instead of rgb; in the 9-output
# mode nine 4-byte values.
K1_OUT_BYTES = {"rgb": 12, "mip": 8 + 28, "nine": 36}
# shade_mip's FP32 operations (csrc/shade_mip.cu), counted as above: per
# pixel that hit geometry, pass 1 (uv wrap 4, the level's L - 1 compares,
# the primary taps) and per shaded pixel of a valid camera pass 2 (uv wrap
# 4, the level, the primary taps twice, the fit conversion 1, the sample,
# the base colour products 3 and the packing 24), trilinear adding the
# live test 3, the secondary taps twice, the weight 4, a second sample and
# the blend 12. Taps: nearest 8 (three conversions of the level's offset
# and size, three products and 1 - v, two conversions), bilinear 14;
# sample: nearest 6 (three dequant conversions and divides), bilinear 60.
MIP_OPS_TAPS = {"nearest": 8, "bilinear": 14, "trilinear": 14}
MIP_OPS_SAMPLE = {"nearest": 6, "bilinear": 60, "trilinear": 60}
MIP_OPS_TRILINEAR = 3 + 2 * 14 + 4 + 60 + 12
MIP_HANDOFF_BYTES = 28
# K13's FP32 operations per (world, triangle slot), counted from
# csrc/pack_rows.cu: six quaternion rotations of 30, the scaled vertex and
# edge products and the translation 12, the validity product 1, three
# inverse scales of 8 and the normal products 9, the texel density 26, the
# material id conversion 1, and the prep products 41 (prep layout) or the
# six edge-validity products (raw layout).
K13_OPS_PER_SLOT = {"pack_rows": 6 * 30 + 12 + 1 + 24 + 9 + 26 + 1 + 41,
                    "pack_rows_raw": 6 * 30 + 12 + 1 + 24 + 9 + 26 + 1 + 6}
# Floats K13 reads once: per instance pos, quat, scale, valid, object id;
# per world the camera origin (prep layout); per object triangle v0, e1,
# e2, n0, dn1, dn2, uv0, duv1, duv2, material, valid; per material colour
# and texture id; per texture width and height.
K13_FLOATS_PER_INSTANCE = 3 + 4 + 3 + 1 + 1
K13_FLOATS_PER_TRIANGLE = 6 * 3 + 3 * 2 + 2
# The streamed route's FP32 operations (csrc/render_resident.cu, STREAM),
# counted as above on top of K1's per-thread fixed work: per block and
# position the walk reaches, the approach distance (12 for the per-axis
# gaps, 5 for the squares and sums, 1 for the slack: the same for every
# thread, so charged once a block) and per thread the early-exit test (2);
# per thread and position past the row gate the slab test (26: K1's 25 and
# the tie slack); per triangle test 28 on prep rows and 37 on raw rows
# (K1's and the tie compare; K10: 44), the raw rows' tv, q and t_num (17;
# K10: a, b, c, 9) once per block and staged triangle. The shadow walk gates
# every cluster per light (24 per thread) and tests as K8 does.
K5_OPS_APPROACH = 18
K5_OPS_EXIT = 2
K5_OPS_SLAB = 26
K5_OPS_PER_TRIANGLE = {"prep": 28, "raw": 37, "wt": 44}
# The binned route (K4, csrc/render_binned.cu): the ordered walk's gates and
# tests; on prep rows each test adds the original index's conversion (29)
# and is made by the 128 threads of one band, the band's row gate (2 compares
# a thread) charged per band that a visit reaches.
K4_OPS_PER_TRIANGLE = {"prep": 29, "raw": 37, "wt": 44}
K4_OPS_BAND_GATE = 2
# K1-none (csrc/render_none.cu): K1's per-thread work without the slab tests,
# and every slot of the world that a test can accept (live_slots: not the
# padding, whose tests fail for every ray) tested by every thread; its
# shadow rays those per light. The 9-output mode (K1's and K1-none's) stops
# before the shading (29 + 14 per light a thread) and resolves the material
# and uv as the textured variants do (8 + 4), writing 36 bytes a pixel.
K1_OPS_SHADING = 29
# K12 (csrc/render_batched.cu): per view and triangle the prepass (tv 3, the
# cross products of D, A and B 27, t_num 5: 35; the work needs it once a
# view, though every block computes it), per pixel and triangle the
# numerators 15, the reciprocal and its guard 3, u, v, t 3 and the tests 6;
# per pixel the ray 30, the resolve (the winner's prepass 35, numerators and
# reciprocal 21, the clips 4, the normal 12, the flip 9) and the shading
# (29 + 14 per light) or the uv 8. Bytes: the rows read once (v0, e1, e2 and
# the attribute rows a hit reads), the camera rows, and 16 bytes a pixel
# written (t, z, idx, rgb) or 36 (the 9-output mode).
K12_OPS_PREPASS = 35
K12_OPS_PER_TRIANGLE = 15 + 3 + 3 + 6
K12_OPS_FIXED = 30 + 35 + 21 + 4 + 12 + 9
K12_OUT_BYTES = {False: 16, True: 36}
# The shadow epilogue (compute_lit, torch ops): per pixel, light and
# triangle tv 3, u 6, q 9, v 6, t 6, the bias 2 and the tests 7 (39); per
# light and triangle the pvec, det and 1/det 17.
EPILOGUE_OPS_PER_TEST = 39
EPILOGUE_OPS_PER_TRIANGLE = 17
# K3 and K4 on resident rows (csrc/render_resident_ordered.cu,
# csrc/render_resident_binned.cu): K1's block set-up (rows, hoisted terms,
# cluster table) and per-thread work, then the streamed walk's gates (the
# approach distance, the exit test, the slab test with its slack) and its
# triangle tests with the tie compare (K5_OPS_PER_TRIANGLE); the shadow sweep
# is K1's (index order). K9 adds the seed's read and its min (1 a thread).
K9_OPS_SEED = 1
# K11 (csrc/render_dmxu.cu): per (pixel, slot) test 28 (det 5, the guarded
# reciprocal 3, u 6, v 6, t 1, the acceptance 5 and the minimum's compare 2:
# the prep test's 27 and t < the cluster's minimum); per thread and visited
# cluster the merge (2 compares and the tie's 2) and the row gate (2); on raw
# rows per block, visited cluster and slot D, A, Q and t_num (tv 3, the
# three cross products 27, t_num 5: 35).
K11_OPS_PER_TEST = 28
K11_OPS_PER_VISIT = 4 + 2
K11_OPS_RAW_SLOT = 35
# The ladder's probes (csrc/ladder.cu): L1 one product an element, L2 one
# add, L3 one add a row element per thread of the block (every thread sums
# the row: 256 x n a block), each bound by the bytes it moves.


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line carries the seconds since the start."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - _T0, 1))
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn) -> tuple:
    """``fn``'s result and its device time by CUDA events, one call (the
    plain versions of the checks, timed where they run once)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events (after one warm-up call, unless ``warm`` is False: the plain
    sweeps of the streamed scenes, seconds long, are timed cold, once)."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn`` launch: ``reps`` calls captured in one
    CUDA graph and replayed, so no host time sits between the launches (for
    kernels shorter than their wrapper's host overhead)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up outside the capture (first-use build and load)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize —
    what a caller waits for (for host-bound work, where device events would
    only time the gaps the host leaves)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def count_torch_ops(fn) -> int:
    """Number of torch operators ``fn`` dispatches, views excluded (each of
    the others is a kernel launch or a host-side op)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    views = {"view", "_unsafe_view", "unbind", "select", "slice", "expand",
             "unsqueeze", "alias", "t", "reshape", "as_strided"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in views:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def random_scene(seed: int, n_worlds: int, cfg_mod, texture=None, max_cams: int = 1):
    """Random triangles, 1-4 instances and one camera per world (with
    ``max_cams`` > 1: 1 to ``max_cams`` cameras per world with their own fov
    and znear); with a ``texture`` path, random uvs (beyond [0, 1], so the
    repeat wrap works) and the first mesh's material textured."""
    rng = np.random.default_rng(seed)
    meshes = [(rng.normal(size=(int(rng.integers(1, 7)) * 3, 3)) * 5).astype(np.float32)
              for _ in range(int(rng.integers(1, 4)))]
    verts = np.concatenate(meshes)
    counts = [len(m) for m in meshes]
    offs = np.cumsum([0] + counts[:-1]).astype(np.uint32)
    uvs = np.zeros((len(verts), 2), np.float32)
    mesh_mats = np.full(len(meshes), -1, np.int32)
    mats, textures = [], []
    if texture is not None:
        uvs = rng.uniform(-1.5, 2.5, size=(len(verts), 2)).astype(np.float32)
        mesh_mats[0] = 0
        mats = [cfg_mod.AdditionalMaterial(color=(0.9, 0.8, 0.7, 1.0), texture_id=0)]
        textures = [texture]
    geo = cfg_mod.GeometryConfig(
        vertices=verts, uvs=uvs,
        indices=np.concatenate([np.arange(c, dtype=np.uint32) for c in counts]),
        mesh_vertex_offsets=offs, mesh_index_offsets=offs.copy(),
        mesh_materials=mesh_mats,
    )

    def unit(v):
        return (v / np.linalg.norm(v)).tolist()

    n_inst = int(rng.integers(1, 5))
    instances, cameras, worlds = [], [], []
    for w in range(n_worlds):
        for _ in range(n_inst):
            instances.append(cfg_mod.ImportedInstance(
                position=rng.normal(size=3).tolist(), rotation=unit(rng.normal(size=4)),
                scale=rng.uniform(0.5, 2.0, size=3).tolist(),
                object_id=int(rng.integers(0, len(meshes)))))
        n_cams = 1 if max_cams == 1 else int(rng.integers(1, max_cams + 1))
        for _ in range(n_cams):
            extra = {} if max_cams == 1 else dict(
                fov_y_degrees=float(rng.choice([0.0, 60.0, 110.0])),
                znear=float(rng.choice([0.0, 0.5, 3.0])))
            cameras.append(cfg_mod.ImportedCamera(
                position=(rng.normal(size=3) * 3 + [0, -12, 0]).tolist(),
                rotation=unit(rng.normal(size=4) * 0.2 + [1, 0, 0, 0]), **extra))
        worlds.append(cfg_mod.WorldInit(n_inst, n_inst * w, n_cams, len(cameras) - n_cams))
    return geo, mats, textures, instances, cameras, worlds


def occluder_scene(n_worlds: int, cfg_mod):
    """tests/test_shadows.py's scene per world: a ground quad at y=10 and a
    small occluder quad at y=5, shifted along x from world to world, seen by
    a camera at the origin looking +y."""
    def quad(half):
        a, b, c, d = [-half, 0, -half], [half, 0, -half], [half, 0, half], [-half, 0, half]
        return np.asarray([a, b, c, a, c, d], np.float32)

    verts = np.concatenate([quad(50.0), quad(2.0)])
    offs = np.asarray([0, 6], np.uint32)
    geo = cfg_mod.GeometryConfig(
        vertices=verts, uvs=np.zeros((12, 2), np.float32),
        indices=np.tile(np.arange(6, dtype=np.uint32), 2), mesh_vertex_offsets=offs,
        mesh_index_offsets=offs.copy(), mesh_materials=np.full(2, -1, np.int32))
    ident = [1.0, 0.0, 0.0, 0.0]
    instances, cameras, worlds = [], [], []
    for w in range(n_worlds):
        instances += [cfg_mod.ImportedInstance([0, 10, 0], ident, object_id=0),
                      cfg_mod.ImportedInstance([0.05 * w - 1.6, 5, 0], ident, object_id=1)]
        cameras.append(cfg_mod.ImportedCamera([0, 0, 0], ident))
        worlds.append(cfg_mod.WorldInit(2, 2 * w, 1, w))
    return geo, [], [], instances, cameras, worlds


def seam_scene(n_worlds: int, cfg_mod, split: bool = True, fill: bool = False):
    """tests/test_watertight_pallas.py's crack scene per world: two triangles
    sharing the diagonal of a flat quad 3 ahead of a camera at the origin,
    in two instances (a seam across clusters) or in one, moved 0.01·w along
    x in world w; with ``fill``, a 3,600-triangle cloud behind the camera as
    a third instance, which makes the mesh streamed."""
    tri_a = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1]], np.float32)
    tri_b = np.asarray([[-1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    meshes = [tri_a, tri_b] if split else [np.concatenate([tri_a, tri_b])]
    if fill:
        meshes.append(cloud_mesh(11))
    ident = [1.0, 0.0, 0.0, 0.0]
    instances, cameras, worlds = [], [], []
    for w in range(n_worlds):
        for obj in range(len(meshes)):
            y = -60 if fill and obj == len(meshes) - 1 else 3
            instances.append(cfg_mod.ImportedInstance([0.01 * w, y, 0], ident, object_id=obj))
        cameras.append(cfg_mod.ImportedCamera([0, 0, 0], ident))
        worlds.append(cfg_mod.WorldInit(len(meshes), len(meshes) * w, 1, w))
    uvs = [np.zeros((len(m), 2), np.float32) for m in meshes]
    return (geometry(cfg_mod, meshes, uvs, [-1] * len(meshes)), [], [], instances, cameras,
            worlds)


def demo_scene(n_worlds: int, dynamic: bool, scenes, cfg_mod, textured=False, num_cams=1):
    r = scenes.demo_config(n_worlds, cfg_mod.RenderMode.Raytracer, WIDTH, HEIGHT,
                           dynamic=dynamic, textured=textured, tex_size=TEX_SIZE,
                           num_cams=num_cams).rcfg
    return (r.geo_cfg, r.additional_mats, r.additional_textures, r.instances,
            r.cameras, r.worlds)


def png_texture(name: str, image: np.ndarray, scenes) -> str:
    """Write ``image`` as a PNG beside the demo textures; its path."""
    from madrona_renderer_tpu_torch.assets.png import write_png

    scenes.ASSET_DIR.mkdir(parents=True, exist_ok=True)
    path = scenes.ASSET_DIR / f"chip_smoke_{name}.png"
    write_png(str(path), image)
    return str(path)


def checker_texture(size: int) -> np.ndarray:
    """The demo checker of tools/tpu_paged_tex_bench.py: 8-texel cells."""
    yy, xx = np.mgrid[0:size, 0:size]
    checker = ((yy // 8 + xx // 8) % 2).astype(np.float32)
    img = np.empty((size, size, 4), np.uint8)
    img[..., 0] = (255 * (0.35 + 0.6 * checker)).astype(np.uint8)
    img[..., 1] = (255 * (0.55 - 0.25 * checker)).astype(np.uint8)
    img[..., 2] = (255 * (0.25 + 0.5 * (1 - checker))).astype(np.uint8)
    img[..., 3] = 255
    return img


def gradient_texture(size: int = 256) -> np.ndarray:
    """tests/test_mips.py's smooth gradient texture."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    return np.stack([xx * 255, yy * 255, (xx + yy) * 127.5, np.full_like(xx, 255)],
                    axis=-1).astype(np.uint8)


def geometry(cfg_mod, meshes, uvs, mesh_mats):
    counts = [len(m) for m in meshes]
    offs = np.cumsum([0] + counts[:-1]).astype(np.uint32)
    return cfg_mod.GeometryConfig(
        vertices=np.concatenate(meshes).astype(np.float32),
        uvs=np.concatenate(uvs).astype(np.float32),
        indices=np.concatenate([np.arange(c, dtype=np.uint32) for c in counts]),
        mesh_vertex_offsets=offs, mesh_index_offsets=offs.copy(),
        mesh_materials=np.asarray(mesh_mats, np.int32))


def quad_xz(half: float, y: float = 0.0) -> np.ndarray:
    """A quad in the XZ plane at ``y``, facing a camera that looks +y."""
    a, b, c, d = [-half, y, -half], [half, y, -half], [half, y, half], [-half, y, half]
    return np.asarray([a, b, c, a, c, d], np.float32)


def quad_uvs(scale: float = 1.0, shift: float = 0.0) -> np.ndarray:
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
    return uv * scale + shift


def paged_tex_config(n_worlds: int, scenes, cfg_mod):
    """bench.py's ``textured256_4096w`` scene (tools/tpu_paged_tex_bench.py
    :26-86): the demo cube at (0, 6, 1.2) scaled 2 and the plane with its
    uvs tiled 4 times, both materials textured with a 256x256 checker of
    8-texel cells, one camera per world at (0, 0, 2) looking +y."""
    cube_v, cube_uv = scenes.cube_mesh()
    plane_v, plane_uv = scenes.plane_mesh()
    tex = png_texture(f"paged_{PAGED_TEX_SIZE}", checker_texture(PAGED_TEX_SIZE), scenes)
    ident = [1.0, 0.0, 0.0, 0.0]
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        insts += [cfg_mod.ImportedInstance([0, 6, 1.2], ident, [2, 2, 2], object_id=0),
                  cfg_mod.ImportedInstance([0, 0, 0], ident, [1, 1, 1], object_id=1)]
        cams.append(cfg_mod.ImportedCamera([0, 0, 2], ident))
        worlds.append(cfg_mod.WorldInit(2, 2 * w, 1, w))
    return cfg_mod.ManagerConfig(
        gpu_id=0, num_worlds=n_worlds, render_mode=cfg_mod.RenderMode.Raytracer,
        batch_render_view_width=WIDTH, batch_render_view_height=HEIGHT,
        rcfg=cfg_mod.RenderConfig(
            geo_cfg=geometry(cfg_mod, [cube_v, plane_v], [cube_uv, plane_uv * 4.0], [0, 1]),
            additional_mats=[cfg_mod.AdditionalMaterial((1, 1, 1, 1), texture_id=0),
                             cfg_mod.AdditionalMaterial((0.9, 0.85, 0.8, 1.0), texture_id=0)],
            additional_textures=[tex], instances=insts, cameras=cams, worlds=worlds))


def mip_scene(kind: str, n_worlds: int, cfg_mod, tex: str):
    """tests/test_mips.py's mip scenes, per world: ``gradient`` (a floor 10
    ahead, uvs tiled 7.3 times, an untextured close-up quad; ``gradient_2cams``
    with a second camera per world), ``overflow`` (the floor alone, uvs
    tiled 63.7 times), ``seam`` and ``closeup`` (a floor tiled 40 times
    behind a textured close-up whose uvs span [0, 0.07] across the seam, or
    [0.40, 0.47]). The floor of world w moves 0.01·w along x."""
    ident = [1.0, 0.0, 0.0, 0.0]
    num_cams = 2 if kind == "gradient_2cams" else 1
    if kind in ("seam", "closeup"):
        lo = 0.0 if kind == "seam" else 0.40
        meshes, uvs = [quad_xz(60.0), quad_xz(2.5, 4.0)], [quad_uvs(40.0), quad_uvs(0.07, lo)]
        mesh_mats, mats = [0, 0], [cfg_mod.AdditionalMaterial((1, 1, 1, 1), texture_id=0)]
    else:
        uv_scale = 63.7 if kind == "overflow" else 7.3
        meshes, uvs, mesh_mats = [quad_xz(60.0)], [quad_uvs(uv_scale)], [0]
        if kind != "overflow":
            meshes.append(quad_xz(2.0, 4.0))
            uvs.append(np.zeros((6, 2), np.float32))
            mesh_mats.append(1)
        mats = [cfg_mod.AdditionalMaterial((1, 1, 1, 1), texture_id=0),
                cfg_mod.AdditionalMaterial((0.9, 0.4, 0.3, 1.0))]
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        insts.append(cfg_mod.ImportedInstance([0.01 * w, 10, 0], ident, object_id=0))
        if len(meshes) > 1:
            insts.append(cfg_mod.ImportedInstance([0, 0, 0], ident, object_id=1))
        cams.append(cfg_mod.ImportedCamera([0, 0, 0], ident))
        if num_cams == 2:
            cams.append(cfg_mod.ImportedCamera([0.7, -0.5, 0.3],
                                               [math.cos(0.075), 0.0, 0.0, math.sin(0.075)]))
        worlds.append(cfg_mod.WorldInit(len(meshes), len(meshes) * w, num_cams, num_cams * w))
    return geometry(cfg_mod, meshes, uvs, mesh_mats), mats, [tex], insts, cams, worlds


def cloud_mesh(seed: int, n_tris: int = 3600, spread: float = 10.0, y_lo: float = 4.0,
               y_hi: float = 40.0, jitter: float = 0.4) -> np.ndarray:
    """tests/test_pallas_parity.py's random triangle cloud ahead of a camera
    at the origin looking +y."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n_tris, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(y_lo, y_hi, size=n_tris)
    tris = np.repeat(centers, 3, axis=0)
    tris[1::3] += rng.normal(size=(n_tris, 3)).astype(np.float32) * jitter
    tris[2::3] += rng.normal(size=(n_tris, 3)).astype(np.float32) * jitter
    return tris


def bigmesh_scene(n_worlds: int, cfg_mod, scenes, vary: bool = False, num_cams: int = 1,
                  texture=None, grid: int = 72):
    """bench.py's ``bigmesh_512w`` scene (tools/tpu_bigmesh_bench.py:44-90):
    the 72x72 terrain (10,368 triangles; ``grid`` x ``grid``) at the origin
    and the demo cube scaled 2 at (0, 0, 2.5), one camera per world at
    (0, 14, 6) pitched -0.25. With ``vary``, world w's terrain turns by a yaw
    of 0.05·w and its cube moves 0.1·w along x, so the worlds' visit orders
    differ; further cameras of a world stand 1.5 apart along x; with a
    ``texture`` path the terrain's uvs are its xy / 8 and its material
    samples the texture."""
    terrain = scenes.terrain_mesh(grid)
    cube_v, cube_uv = scenes.cube_mesh()
    uvs = [terrain[:, :2] / 8.0 if texture else np.zeros((len(terrain), 2), np.float32),
           cube_uv]
    mats = [cfg_mod.AdditionalMaterial((0.35, 0.5, 0.3, 1.0), texture_id=0 if texture else -1),
            cfg_mod.AdditionalMaterial((0.9, 0.3, 0.2, 1.0))]
    ps, pc = math.sin(-0.25 / 2), math.cos(-0.25 / 2)
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        yaw = 0.05 * w if vary else 0.0
        insts += [cfg_mod.ImportedInstance([0, 0, 0], [math.cos(yaw / 2), 0, 0, math.sin(yaw / 2)],
                                           [1, 1, 1], object_id=0),
                  cfg_mod.ImportedInstance([0.1 * w if vary else 0.0, 0, 2.5], [1, 0, 0, 0],
                                           [2, 2, 2], object_id=1)]
        for c in range(num_cams):
            cams.append(cfg_mod.ImportedCamera([1.5 * c, 14.0, 6.0], [0.0, 0.0, ps, pc]))
        worlds.append(cfg_mod.WorldInit(2, 2 * w, num_cams, num_cams * w))
    return (geometry(cfg_mod, [terrain, cube_v], uvs, [0, 1]), mats,
            [texture] if texture else [], insts, cams, worlds)


def streamed_test_scene(kind: str, n_worlds: int, cfg_mod):
    """The streamed scenes of tests/test_pallas_parity.py and
    tests/test_shadows.py, per world, the instances of world w moved 0.01·w
    along x: ``cloud`` (3,600 triangles ahead of a camera at the origin,
    :176), ``instances64`` (64 instances of a 500-triangle cloud, 64-triangle
    clusters, :204), ``hetero`` (two instances, every other world holding
    only the first, :596), ``two_cams`` (two cameras per world, :634); and
    ``tie``: instance 0 a quad 10 ahead of the camera, instance 1 the same
    quad at the same pose with a small triangle 5 ahead, so that its cluster
    comes first in the visit order while every pixel of the quad ties
    between the two (the lower index, instance 0, wins), and a 3,600-triangle
    cloud behind the camera that makes the mesh streamed."""
    ident = [1.0, 0.0, 0.0, 0.0]
    num_cams = 2 if kind == "two_cams" else 1
    if kind == "instances64":
        meshes = [cloud_mesh(13, 500, 6.0, 4.0, 25.0, 0.5)]
        per_world = [([(i % 8 - 3.5) * 2, 0, (i // 8 - 3.5) * 2], [0.5] * 3, 0)
                     for i in range(64)]
    elif kind == "tie":
        small = np.asarray([[-0.5, -5.0, -0.5], [0.5, -5.0, -0.5], [0.0, -5.0, 0.5]],
                           np.float32)
        quad = quad_xz(4.0)
        meshes = [quad, np.concatenate([quad, small]), cloud_mesh(11)]
        per_world = [([0, 10, 0], [1] * 3, 0), ([0, 10, 0], [1] * 3, 1),
                     ([0, -60, 0], [1] * 3, 2)]
    else:
        meshes = [cloud_mesh({"cloud": 11, "hetero": 41, "two_cams": 43}[kind])]
        per_world = [([0, 0, 0], [1] * 3, 0)]
        if kind == "hetero":
            per_world.append(([3, 5, 0], [0.5] * 3, 0))
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        n_inst = 1 if kind == "hetero" and w % 2 else len(per_world)
        for pos, scale, obj in per_world[:n_inst]:
            insts.append(cfg_mod.ImportedInstance([pos[0] + 0.01 * w, pos[1], pos[2]], ident,
                                                  scale, object_id=obj))
        cams.append(cfg_mod.ImportedCamera([0, 0, 0], ident))
        if num_cams == 2:
            cams.append(cfg_mod.ImportedCamera([5, -2, 1], [0.96, 0, 0, 0.28]))
        worlds.append(cfg_mod.WorldInit(n_inst, len(insts) - n_inst, num_cams, num_cams * w))
    uvs = [np.zeros((len(m), 2), np.float32) for m in meshes]
    return geometry(cfg_mod, meshes, uvs, [-1] * len(meshes)), [], [], insts, cams, worlds


def compare_outputs(k, p) -> dict:
    """Kernel outputs vs plain outputs: rgb bytes, depth, segmask."""
    (kd, ks, kc), (pd, ps, pc) = k, p
    rgb_lsb = int((kc.view(torch.uint8).int() - pc.view(torch.uint8).int()).abs().max())
    depth_abs = float((kd - pd).abs().max())
    depth_bad = int((~torch.isclose(kd, pd, rtol=1e-5, atol=0.0)).sum())
    seg_mismatch = int((ks != ps).sum())
    return dict(rgb_max_lsb=rgb_lsb, depth_max_abs=depth_abs,
                depth_outside_rtol=depth_bad, seg_mismatches=seg_mismatch,
                pixels=int(ks.numel()), bitwise=bool(
                    torch.equal(kd, pd) and torch.equal(ks, ps) and torch.equal(kc, pc)))


def check_close(tag: str, c: dict) -> None:
    """The bar: rgb within 1 LSB, depth within rtol 1e-5, segmask exact."""
    if c["rgb_max_lsb"] > 1 or c["depth_outside_rtol"] or c["seg_mismatches"]:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version: {c}")


def compare_all(k, p) -> dict:
    """Kernel outputs vs plain outputs, any number of them (K12's four, the
    9-output mode's nine): the largest difference and whether every output
    is bitwise its plain twin."""
    errs = [float((a.double() - b.double()).abs().max()) for a, b in zip(k, p)]
    return dict(max_abs_err=max(errs), outputs=len(k), pixels=int(k[0].numel()),
                bitwise=all(torch.equal(a, b) for a, b in zip(k, p)))


def output_err(k, p) -> float:
    return max(float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max()),
               float((k[2].view(torch.uint8).int() - p[2].view(torch.uint8).int())
                     .abs().max()))


def layout(kw: dict) -> str:
    """The rows' layout and sweep a variant's operation counts follow:
    ``prep``, ``raw`` (K1-raw, K8) or ``wt`` (K10)."""
    geo = kw["geo"]
    return "prep" if geo == "prep" else "wt" if geo.startswith("raw_wt") else "raw"


def k5_bound(kw: dict, walk: dict) -> tuple:
    """Least time for the streamed render kernel's work on these inputs,
    from the walk this run's data makes (``walk_replay.streamed_walk``, or
    for K4 ``walk_replay.binned_walk``):
    the rows of every (world, cluster) some block streams read once (10 prep
    rows, 9 raw rows or, K10, 10), the winners' attribute rows (prep: and
    their 9 prep rows for the uv; K10: their 9 raw rows), the cluster table,
    each view's order and spans, the camera rows and the pixels written;
    against the FP32 operations of the
    positions the blocks gate, the slab tests and the triangle tests they
    make; with K9's seed its read and min (ms, 'bytes'|'operations', bytes,
    operations)."""
    W, _, S = kw["rows"].shape
    CC = kw["clusters"].shape[2]
    size = S // CC
    seeded = kw.get("seed") is not None
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    blocks = views * math.ceil(kw["height"] / 16) * math.ceil(kw["width"] / 16)
    threads = blocks * K1_THREADS_PER_BLOCK
    tex = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    lights = kw["n_lights"]
    geo = layout(kw)
    binned = kw.get("bins") is not None
    ranged = kw.get("ranges") is not None
    # Visit inputs: the ordered walk's order and spans; the binned walk's
    # spans, the bin entries its blocks reach and (prep) the range of each
    # (cluster, band) a visit reads, with the original-index row.
    visit_bytes = (views * 2 * CC * 4 + walk["bin_entries"] * 4 + walk["band_reads"] * 8
                   if binned else views * 2 * CC * 4 + views * CC * 4)
    nbytes = (walk["clusters_streamed"] * (K1_GEO_ROWS[geo] + ranged) * size * 4
              + walk["winners"] * (K1_ATTR_ROWS[tex] + (9 if geo != "raw" else 0)) * 4
              + kw["clusters"].numel() * 4 + visit_bytes + kw["cams"].numel() * 4
              + pixels * (out_bytes(tex) + 4 * seeded))
    if tex in ("nearest", "bilinear"):
        nbytes += kw["mats"].numel() * 4 + kw["pool"].numel() * 4
    per_thread = per_thread_ops(kw, geo, tex)
    # The positions gated and each block's last (binned: the stops counted).
    reached = walk["gated"] + (walk["stops"] if binned else blocks)
    per_triangle = (K4_OPS_PER_TRIANGLE if binned else K5_OPS_PER_TRIANGLE)[geo]
    ops = (threads * per_thread
           + reached * (K5_OPS_APPROACH + K1_THREADS_PER_BLOCK * K5_OPS_EXIT)
           + walk["slab_tests"] * K1_THREADS_PER_BLOCK * K5_OPS_SLAB
           + walk["triangle_visits"] * walk.get("sweep_threads", K1_THREADS_PER_BLOCK)
           * per_triangle)
    if ranged:
        ops += walk["cluster_visits"] * K1_THREADS_PER_BLOCK * K4_OPS_BAND_GATE
    ops += walk["triangle_visits"] * K1_OPS_HOIST[geo]
    if kw["geo"].endswith("_shadows"):
        ops += (threads * (K8_OPS_FIXED + K8_OPS_PER_LIGHT * lights
                           + K8_OPS_PER_CLUSTER * CC * lights)
                + views * lights * K8_OPS_PER_VIEW_LIGHT
                + walk["shadow_triangle_visits"] * (K1_THREADS_PER_BLOCK * K8_OPS_PER_TRIANGLE
                                                    + K8_OPS_PER_BLOCK_TRIANGLE))
    return roofline(nbytes, ops) + (nbytes, ops)


def dmxu_bound(kw: dict, walk: dict) -> tuple:
    """Least time for K11's work on these inputs, from the walk this run's
    data makes (``walk_replay.dmxu_walk``): the bytes of ``k5_bound`` (every
    slot's rows of each streamed cluster, no ranges), against the per-thread
    work, the walk's gates, every (pixel, slot) test its row gate leaves, the
    merges and, on raw rows, each visit's D, A, Q, t_num (ms,
    'bytes'|'operations', bytes, operations)."""
    W, _, S = kw["rows"].shape
    CC = kw["clusters"].shape[2]
    size = S // CC
    seeded = kw.get("seed") is not None
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    blocks = views * math.ceil(kw["height"] / 16) * math.ceil(kw["width"] / 16)
    threads = blocks * K1_THREADS_PER_BLOCK
    tex = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    geo = layout(kw)
    binned = kw.get("bins") is not None
    visit_bytes = (views * 2 * CC * 4 + walk["bin_entries"] * 4 if binned
                   else views * 2 * CC * 4 + views * CC * 4)
    nbytes = (walk["clusters_streamed"] * K1_GEO_ROWS[geo] * size * 4
              + walk["winners"] * (K1_ATTR_ROWS[tex] + (9 if geo != "raw" else 0)) * 4
              + kw["clusters"].numel() * 4 + visit_bytes + kw["cams"].numel() * 4
              + pixels * (out_bytes(tex) + 4 * seeded))
    if tex in ("nearest", "bilinear"):
        nbytes += kw["mats"].numel() * 4 + kw["pool"].numel() * 4
    per_thread = per_thread_ops(kw, geo, tex)
    reached = walk["gated"] + (walk["stops"] if binned else blocks)
    ops = (threads * per_thread
           + reached * (K5_OPS_APPROACH + K1_THREADS_PER_BLOCK * K5_OPS_EXIT)
           + walk["slab_tests"] * K1_THREADS_PER_BLOCK * K5_OPS_SLAB
           + walk["cluster_visits"] * K1_THREADS_PER_BLOCK * K11_OPS_PER_VISIT
           + walk["pixel_tests"] * K11_OPS_PER_TEST)
    if geo == "raw":
        ops += walk["triangle_visits"] * K11_OPS_RAW_SLOT
    return roofline(nbytes, ops) + (nbytes, ops)


def ladder_bound(name: str, args) -> tuple:
    """Least time for a ladder probe's work: its inputs read once (L3: the
    row it sums) and its [blocks, 8, 128] output written once, against its
    FP32 operations (ms, 'bytes'|'operations', bytes, operations)."""
    blocks, out = args[-1].shape[0], args[-1].shape[0] * 8 * 128
    if name == "ladder_fori_smem":
        n = args[0].shape[2]
        nbytes, ops = 4 * (blocks * n + out), blocks * K1_THREADS_PER_BLOCK * n
    else:
        nbytes, ops = 4 * (sum(a.numel() for a in args) + out), out
    return roofline(nbytes, ops) + (nbytes, ops)


def out_bytes(tex) -> int:
    """Bytes the render kernel writes a pixel in this texture mode."""
    return K1_OUT_BYTES[tex if tex in ("mip", "nine") else "rgb"]


def per_thread_ops(kw: dict, geo: str, tex) -> int:
    """The render kernel's FP32 operations a thread makes outside its
    sweeps: ray, resolve and shading (none in the 9-output mode), the
    texture mode's, raster's and the seed's."""
    lights = kw["n_lights"]
    ops = (K1_OPS_FIXED[geo] + K1_OPS_PER_LIGHT * lights + K1_OPS_TEX[tex]
           + (K1_OPS_RASTER if kw["raster"] else 0) + K9_OPS_SEED * (kw.get("seed") is not None))
    if tex == "nine":
        ops -= K1_OPS_SHADING + K1_OPS_PER_LIGHT * lights
    return ops


def live_slots(kw: dict) -> int:
    """The slots a view's tests can accept, summed over the views: where
    the view's near is at least 0, on prep rows those whose D (rows 0-2)
    is not zero, on raw rows those whose validity (row 9) is positive;
    every ray's test of the others fails (K1-none's teams skip them)."""
    rows = kw["rows"]
    live = (rows[:, 0:3] != 0).any(1) if kw["geo"] == "prep" else rows[:, 9] > 0
    per_view = live.sum(1).repeat_interleave(kw["num_cams"])
    near_ok = kw["cams"][:, 14] >= 0
    return int(torch.where(near_ok, per_view, rows.shape[2]).sum())


def none_bound(kw: dict) -> tuple:
    """Least time for K1-none's work (csrc/render_none.cu) on these inputs:
    the rows each block reads, the attribute rows a hit reads once, the
    camera rows, the seed and the pixels written, against the per-thread
    work, the block's hoisted per-triangle terms and every thread's test of
    every slot a test can accept (live_slots); with shadows every thread's
    shadow test of those per light (ms, 'bytes'|'operations', bytes,
    operations)."""
    W, _, S = kw["rows"].shape
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    tiles = math.ceil(kw["height"] / 16) * math.ceil(kw["width"] / 16)
    blocks = views * tiles
    threads = blocks * K1_THREADS_PER_BLOCK
    # (block, slot) pairs whose tests the data needs.
    tested = tiles * live_slots(kw)
    tex = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    geo = layout(kw)
    lights = kw["n_lights"]
    seeded = kw.get("seed") is not None
    nbytes = (W * (K1_GEO_ROWS[geo] + K1_ATTR_ROWS[tex]) * S * 4 + kw["cams"].numel() * 4
              + pixels * (out_bytes(tex) + 4 * seeded))
    if tex in ("nearest", "bilinear"):
        nbytes += kw["mats"].numel() * 4 + kw["pool"].numel() * 4
    ops = (threads * per_thread_ops(kw, geo, tex) + blocks * S * K1_OPS_HOIST[geo]
           + tested * K1_THREADS_PER_BLOCK * K1_OPS_PER_TRIANGLE[geo])
    if kw["geo"].endswith("_shadows"):
        ops += (threads * (K8_OPS_FIXED + K8_OPS_PER_LIGHT * lights)
                + views * lights * K8_OPS_PER_VIEW_LIGHT
                + tested * lights * (K1_THREADS_PER_BLOCK * K8_OPS_PER_TRIANGLE
                                     + K8_OPS_PER_BLOCK_TRIANGLE))
    return roofline(nbytes, ops) + (nbytes, ops)


def k12_bound(kw: dict) -> tuple:
    """Least time for K12's work (csrc/render_batched.cu) on these inputs:
    the rows read once (v0, e1, e2 and the attribute rows: normals and
    colour, or normals, material and uv), the camera rows and the pixels
    written, against the prepass once a view and triangle, every pixel's
    test of every triangle and the per-pixel ray, resolve and shading (or
    uv) (ms, 'bytes'|'operations', bytes, operations)."""
    W, _, S = kw["rows"].shape
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    nine = kw["nine"]
    nbytes = (W * (9 + 9 + (7 if nine else 3)) * S * 4 + kw["cams"].numel() * 4
              + pixels * K12_OUT_BYTES[nine])
    per_pixel = (K12_OPS_FIXED + (K1_OPS_RASTER if kw["raster"] else 0)
                 + (8 if nine else K1_OPS_SHADING + K1_OPS_PER_LIGHT * kw["n_lights"]))
    ops = views * S * K12_OPS_PREPASS + pixels * S * K12_OPS_PER_TRIANGLE + pixels * per_pixel
    return roofline(nbytes, ops) + (nbytes, ops)


def resident_bound(kw: dict, walk: dict) -> tuple:
    """Least time for the resident render kernel's work on these inputs
    (K1, or K3 and K4 on resident rows), from the walk this run's data
    makes (``walk_replay.resident_walk``, with the seed where there is
    one): bytes over HBM rate vs FP32 operations over peak, the larger of
    the two. Bytes: the rows each block reads (the geometry rows) and each
    hit reads once (the attribute rows), the cluster table, the camera
    rows, the visit's order or the bin entries its blocks read, the seed,
    the pixels written. Operations: per thread the ray, resolve and shading
    work (K1: and a slab test per cluster), per block the hoisted
    per-triangle terms, the walk's gates, and the triangle tests of the
    visited clusters (K1: at its own count), with shadows K8's sweep
    (ms, 'bytes'|'operations', bytes, operations)."""
    W, _, S = kw["rows"].shape
    CC = kw["clusters"].shape[2]
    views = kw["cams"].shape[0]
    pixels = views * kw["height"] * kw["width"]
    blocks = views * math.ceil(kw["height"] / 16) * math.ceil(kw["width"] / 16)
    threads = blocks * K1_THREADS_PER_BLOCK
    tex = "mip" if kw.get("fb_rows") is not None else kw["texture"]
    lights = kw["n_lights"]
    geo = layout(kw)
    seeded = kw.get("seed") is not None
    visit_bytes = (walk["bin_entries"] * 4 if kw.get("bins") is not None
                   else views * CC * 4 if kw.get("order") is not None else 0)
    nbytes = (W * (K1_GEO_ROWS[geo] + K1_ATTR_ROWS[tex]) * S * 4
              + kw["clusters"].numel() * 4 + kw["cams"].numel() * 4 + visit_bytes
              + pixels * (out_bytes(tex) + 4 * seeded))
    if tex in ("nearest", "bilinear"):
        nbytes += kw["mats"].numel() * 4 + kw["pool"].numel() * 4
    per_thread = per_thread_ops(kw, geo, tex)
    if kw.get("order") is None and kw.get("bins") is None:  # K1's index order
        per_thread += K1_OPS_PER_CLUSTER * CC
        ops = walk["triangle_visits"] * K1_THREADS_PER_BLOCK * K1_OPS_PER_TRIANGLE[geo]
    else:
        reached = walk["gated"] + walk.get("stops", blocks)
        ops = (reached * (K5_OPS_APPROACH + K1_THREADS_PER_BLOCK * K5_OPS_EXIT)
               + walk["slab_tests"] * K1_THREADS_PER_BLOCK * K5_OPS_SLAB
               + walk["triangle_visits"] * K1_THREADS_PER_BLOCK * K5_OPS_PER_TRIANGLE[geo])
    ops += threads * per_thread + blocks * S * K1_OPS_HOIST[geo]
    if kw["geo"].endswith("_shadows"):
        ops += (threads * (K8_OPS_FIXED + K8_OPS_PER_LIGHT * lights
                           + K8_OPS_PER_CLUSTER * CC * lights)
                + views * lights * K8_OPS_PER_VIEW_LIGHT
                + walk["shadow_triangle_visits"] * (K1_THREADS_PER_BLOCK * K8_OPS_PER_TRIANGLE
                                                    + K8_OPS_PER_BLOCK_TRIANGLE))
    return roofline(nbytes, ops) + (nbytes, ops)


def shade_mip_bound(kw: dict, code) -> tuple:
    """Least time for shade_mip's work on this hand-off: the hand-off read
    and the rgb written once, the mip table, pool and camera rows read
    once, against its FP32 operations for this run's hit and shaded
    pixels."""
    from madrona_renderer_tpu_torch.ops import mips
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc

    filt, n_lvl = kw["texture"], mips.num_levels(kw["mats"])
    col = 17 + 6 * kw["n_lights"]
    cam_ok = (kw["cams"][:, col] > 0).reshape(-1, 1, 1)
    found = int(((code & rc._FOUND_BIT) != 0).sum())
    shaded = int((((code & rc._SHADED_BIT) != 0) & cam_ok).sum())
    pass1 = 4 + (n_lvl - 1) + MIP_OPS_TAPS[filt]
    pass2 = (4 + (n_lvl - 1) + 2 * MIP_OPS_TAPS[filt] + 1 + MIP_OPS_SAMPLE[filt] + 27
             + (MIP_OPS_TRILINEAR if filt == "trilinear" else 0))
    ops = found * pass1 + shaded * pass2
    nbytes = (code.numel() * (MIP_HANDOFF_BYTES + 4) + kw["mats"].numel() * 4
              + kw["pool"].numel() * 4 + kw["cams"].numel() * 4)
    return roofline(nbytes, ops) + (nbytes, ops)


def k7_bound(kw: dict, walk: dict, code) -> tuple:
    """Least time for K7's function on these inputs, whichever design runs
    it (the folded entry or the hand-off and shade_mip): bytes, the rows,
    cluster table, cameras (and the visit's and the seed's) the render
    reads, the mip table and the pool read once, and depth, segmask and rgb
    written (12 B a pixel; the hand-off is no input or output of the
    function); operations, those of both launches (the render's on the
    walk, shade_mip's for this run's hit and shaded pixels)."""
    _, _, render_bytes, render_ops = resident_bound(kw, walk)
    _, _, _, shade_ops = shade_mip_bound(kw, code)
    nbytes = (render_bytes - code.numel() * (K1_OUT_BYTES["mip"] - K1_OUT_BYTES["rgb"])
              + kw["mats"].numel() * 4 + kw["pool"].numel() * 4)
    return roofline(nbytes, render_ops + shade_ops) + (nbytes, render_ops + shade_ops)


def k13_bound(state, scene, layout: str) -> tuple:
    """Least time for K13's work in ``layout`` (``pack_rows`` or
    ``pack_rows_raw``): each input read once, the [W, 40, S] rows written
    once, against its FP32 operations."""
    W, I = state.instance_obj.shape
    O, T = scene.tri_valid.shape
    M = scene.mat_color.shape[0]
    K = scene.tex_width.shape[0]
    cam_floats = W * 3 if layout == "pack_rows" else 0
    nbytes = 4 * (W * 40 * I * T + W * I * K13_FLOATS_PER_INSTANCE + cam_floats
                  + O * T * K13_FLOATS_PER_TRIANGLE + M * 5 + K * 2)
    ops = W * I * T * K13_OPS_PER_SLOT[layout]
    return roofline(nbytes, ops) + (nbytes, ops)


def device_ms(fn, reps: int = 3):
    """Device time of ``fn`` from a torch.profiler trace: the durations of
    the kernels it launched, summed, a mean over ``reps`` calls. None when
    the profiler cannot trace the card or its trace holds no device time
    (then only the CUDA events' times stand)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    except (RuntimeError, AssertionError):
        return None
    return total / reps / 1e3 if total > 0 else None


def roofline(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import madrona_renderer_tpu_torch as m
    from madrona_renderer_tpu_torch import _build, config as cfg_mod, ladder
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene, configure_lighting
    from madrona_renderer_tpu_torch.core.state import init_state
    from madrona_renderer_tpu_torch.ops import mips, pack_cuda, ssaa, walk_replay
    from madrona_renderer_tpu_torch.ops import raytrace_cuda as rc
    from madrona_renderer_tpu_torch.runners import scenes

    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    shade_filters = ("nearest", "bilinear")
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card, "nvidia_smi": smi,
          "device_count": torch.cuda.device_count()})

    # Every library at once, one nvcc each (as _build.build_all), each timed;
    # beside the build, the GPU health ladder's first rungs (a torch op and
    # the probes L1-L3, which need csrc/ladder.cu only, built first by its
    # rung processes or here, whichever comes first: a build publishes
    # atomically), each in a process of its own.
    t0 = time.perf_counter()
    build_s = {}

    def timed_build(name):
        start = time.perf_counter()
        _build.build(name)
        build_s[name] = time.perf_counter() - start

    with ThreadPoolExecutor(len(_build.sources()) + 1) as pool:
        builds = [pool.submit(timed_build, name) for name in _build.sources()]
        early = pool.submit(ladder.run_ladder, out=lambda line: None,
                            rungs=ladder.RUNGS[:4])
        for b in builds:
            b.result()
        build_end = time.perf_counter() - t0
        ladder_runs = early.result()
    emit({"phase": "build", "kernels": sorted(build_s), "seconds": build_end,
          "seconds_each": build_s})

    # Per kernel name: the largest error against its plain version.
    kernel_names = (rc.RENDER_VARIANTS + rc.MIP_VARIANTS + rc.BATCHED_VARIANTS
                    + rc.SHADE_MIP_VARIANTS + pack_cuda.LAYOUTS)
    max_err = {name: 0.0 for name in kernel_names + ladder.KERNELS}

    # ---- 2b. the GPU health ladder (madrona_renderer_tpu_torch/ladder.py):
    # every rung in a process of its own, its render rungs after the build
    # so that they find the libraries built; a failed or hung rung fails the
    # run. The probes' launch counts are their rung processes' (each starts
    # at 0).
    if len(ladder_runs) == 4 and all(run["ok"] for run in ladder_runs):
        ladder_runs += ladder.run_ladder(out=lambda line: None, rungs=ladder.RUNGS[4:])
    for run in ladder_runs:
        emit({"phase": "ladder", **run})
    if len(ladder_runs) != len(ladder.RUNGS) or not all(run["ok"] for run in ladder_runs):
        raise AssertionError(f"the ladder failed at rung {ladder_runs[-1]['rung']!r}")
    ladder_launches = {}
    for run in ladder_runs:
        ladder_launches.update(run.get("launches", {}))
    if any(ladder_launches.get(name) != 1 for name in ladder.KERNELS):
        raise AssertionError(f"the ladder's probes launched {ladder_launches}")
    # L1-L3 on the tool's inputs against their plain versions, here.
    probes = ladder.probe_inputs(dev)
    for name in ladder.KERNELS:
        k = ladder.WRAPPERS[name](*probes[name])
        torch.cuda.synchronize()
        p = ladder.PLAIN[name](*probes[name])
        max_err[name] = float((k - p).abs().max())
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": "tools/tpu_ladder.py inputs",
              "max_abs_err": max_err[name], "bitwise": bool(torch.equal(k, p))})
        if not torch.equal(k, p):
            raise AssertionError(f"{name} differs from its plain version")

    def check_pack(tag, state, scene, cam):
        name = pack_cuda.layout_name(cam)
        k = pack_cuda.pack_rows(state, scene, cam)
        torch.cuda.synchronize()
        p = rc._pack_rows_planar(state, scene, cam)
        err = float((k - p).abs().max())
        max_err[name] = max(max_err[name], err)
        bitwise = torch.equal(k, p)
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": tag,
              "worlds": int(k.shape[0]), "slots": int(k.shape[2]),
              "max_abs_err": err, "bitwise": bitwise})
        if not bitwise:
            raise AssertionError(f"{tag}: {name} differs from its plain version")

    def is_k7(kw):
        return kw.get("fb_rows") is not None

    def is_batched(kw):
        """K12's inputs (pack_inputs with accel="mxu")."""
        return "nine" in kw

    def route(kw):
        if is_batched(kw):
            return rc.Route(False, "mxu")
        return rc.route_of(kw.get("order"), kw.get("spans"), kw.get("bins"),
                           kw["clusters"] is not None)

    def binned(kw):
        return route(kw).visit == "binned"

    def streamed(kw):
        return route(kw).streamed

    def seeded(kw):
        return kw.get("seed") is not None

    def dmxu(kw):
        """K11's inputs (pack_inputs with deferred_mxu where it applies)."""
        return bool(kw.get("dmxu"))

    def handoff_name(kw):
        return rc.variant_name(kw["raster"], "mip", kw["geo"], route(kw), seeded(kw), dmxu(kw))

    def pair_name(kw):
        """K7's two launches' names: the hand-off and shade_mip."""
        return f"{handoff_name(kw)}+shade_mip_{kw['texture']}"

    def variant(kw):
        """The render kernel's variant; for K7 the folded entry's name where
        its plan takes the index visit's teams, else its two launches'."""
        if is_batched(kw):
            return rc.batched_name(kw["raster"], kw["nine"])
        if is_k7(kw):
            if rc.mip_plan(**kw).groups:
                return rc.mip_name(kw["texture"])
            return pair_name(kw)
        return rc.variant_name(kw["raster"], kw["texture"], kw["geo"], route(kw), seeded(kw),
                               dmxu(kw))

    def resident_visits(kw, state, scene, none=False):
        """A resident scene's inputs for each visit: index order (K1), the
        view's order (K3) and the bins at bin_tile_for's tile (K4), as
        pack_inputs builds them (the default 90° fov), and with ``none``
        no cluster table (K1-none)."""
        eff_fov = torch.where(state.camera_fov > 0, state.camera_fov, 90.0)
        lo, hi, valid, count = rc.world_clusters(state, scene)
        order = rc.camera_cluster_order(lo, hi, valid, state.camera_pos)
        views, CC = order.shape
        h, w = kw["height"], kw["width"]
        tile = rc.bin_tile_for(views, h, w, CC)
        tx, ty = -(-w // tile), -(-h // tile)
        bins = rc.band_cluster_bins(lo, hi, valid, state, eff_fov, h, w, tx * ty, tx, tile,
                                    tile, order=order)
        base = dict(kw, clusters=rc._pack_clusters(lo, hi, valid, count).contiguous(),
                    order=None, spans=None, bins=None, ranges=None, bin_tile=None)
        visits = [base, dict(base, order=order), dict(base, bins=bins, bin_tile=tile)]
        return visits + [dict(base, clusters=None)] if none else visits


    def seed_for(depth):
        """K9's test seed for frames of this depth: per pixel at random far
        (1000), just above the hit (× 1.0001), exactly at it (a miss), or
        at half of it (a miss); far on a miss. The picks are drawn afresh
        from one generator seed, so equal depths get equal seeds (and the
        seeded walks replayed for one serve the other)."""
        gen = torch.Generator(device=depth.device).manual_seed(9)
        pick = torch.randint(0, 4, depth.shape, generator=gen, device=depth.device)
        scale = torch.tensor([1.0, 1.0001, 1.0, 0.5], device=depth.device)[pick]
        bound = torch.where(pick == 0, 1000.0, depth * scale)
        return torch.where(depth > 0, bound, 1000.0).contiguous()

    def is_new(kw):
        """K3 or K4 on resident rows, K9, K1-none, K12, the 9-output mode or
        K11: the kernels held bitwise to their plain version and timed on
        the first inputs they were checked on."""
        return (seeded(kw) or (not streamed(kw) and route(kw).visit != "index")
                or kw.get("texture") == "nine" or dmxu(kw))

    first_kw = {}  # the first inputs each of this slice's variants was checked on
    # (name, path, inputs) of the timings on a second path's (or check's) inputs.
    extra_timing = []
    # Per variant (K7: per hand-off variant too): the inputs it was checked
    # on and its plain version's time there, one cold call, for its first
    # inputs and for a path's own (``keep``); the timing lines take it where
    # they time the variant on those inputs.
    plain_of, handoff_plain_of = {}, {}

    def note_plain(checked, name, kw, ms, keep):
        if keep or name not in checked:
            checked.setdefault(name, []).append((kw, ms))

    # The plain outputs of inputs whose plain version another check already
    # ran (the visits and routes of one scene and mode share it: the plain
    # version sweeps every triangle in index order whatever the visit), and
    # the plain sweeps (rc.plain_hits) that a mode's texture variants share
    # (the 9-output mode's among them); cleared with each scene's loop
    # (clear_plain).
    plain_memo, hits_memo = {}, {}

    def clear_plain():
        plain_memo.clear()
        hits_memo.clear()

    def plain_run(kw, fn):
        """``fn`` (render_resident_plain or render_handoff_plain) on ``kw``
        and its time, the sweep shared by the inputs' texture modes: one
        rc.plain_hits for the same rows, cameras and seed (the memo holds
        them, so no other tensor takes their place) and sweep; the time is
        the sweep's and the resolve's."""
        key = (id(kw["rows"]), id(kw["cams"]), id(kw.get("seed")), kw["geo"], kw["raster"],
               kw["height"], kw["width"], kw.get("ranges") is not None, dmxu(kw))
        if key not in hits_memo:
            ms, hits = timed_ms(lambda: rc.plain_hits(**kw))
            hits_memo[key] = (ms, hits, (kw["rows"], kw["cams"], kw.get("seed")))
        sweep_ms, hits, _ = hits_memo[key]
        ms, out = timed_ms(lambda: fn(**kw, hits=hits))
        return sweep_ms + ms, out

    def check_render(tag, kw, keep=False, memo=None):
        """The render kernel (K12: render_batched) against its plain
        version on ``kw``; ``memo`` names the plain outputs it shares with
        other checks."""
        name = variant(kw)
        run, plain = ((rc.render_batched, rc.render_batched_plain) if is_batched(kw)
                      else (rc.render_resident, rc.render_resident_plain))
        k_out = run(**kw)
        torch.cuda.synchronize()
        if memo is not None and memo in plain_memo:
            plain_ms, p_out = plain_memo[memo]
        elif memo is None or is_batched(kw):
            plain_ms, p_out = timed_ms(lambda: plain(**kw))
        else:
            plain_ms, p_out = plain_run(kw, plain)
        if memo is not None:
            plain_memo[memo] = plain_ms, p_out
        note_plain(plain_of, name, kw, plain_ms, keep)
        if len(k_out) == 3:
            c = compare_outputs(k_out, p_out)
            check_close(f"{tag} {name}", c)
            err = output_err(k_out, p_out)
        else:  # K12, and the 9-output mode: unshaded or unmasked outputs
            c = compare_all(k_out, p_out)
            err = c["max_abs_err"]
        if (is_batched(kw) or is_k7(kw) or kw["geo"] in rc._WATERTIGHT_GEOS or is_new(kw)
                or kw["raster"] and is_index_visit(kw)) and not c["bitwise"]:
            raise AssertionError(f"{tag} {name}: differs from its plain version: {c}")
        if is_new(kw) or is_batched(kw):
            first_kw.setdefault(handoff_name(kw) if is_k7(kw) else name, kw)
        if len(k_out) == 3 and kw["raster"] and not bool((k_out[1] == -1).all()):
            raise AssertionError(f"{tag} {name}: raster segmask is not -1 everywhere")
        for part in name.split("+"):
            max_err[part] = max(max_err.get(part, 0.0), err)
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": tag,
              "hit_share": float((k_out[0] > 0).float().mean()), **c})
        if not is_batched(kw) and streamed(kw) and (
                kw["geo"] == "prep" if binned(kw) else dmxu(kw)):
            check_plans(tag, kw, k_out)
        if is_batched(kw):
            check_batched_plans(tag, kw, k_out)
        if is_index_visit(kw):
            check_index_plans(tag, kw, k_out)
        return k_out

    real_binned_plan = rc.binned_plan
    real_streamed_plan = rc.streamed_plan
    real_batched_plan = rc.batched_plan
    real_index_plan = rc.index_plan

    def index_plan_of(kw, **force):
        """The index order's launch plan (rc.index_plan's own) on these
        inputs: K1's, or without a cluster table K1-none's."""
        culled = kw["clusters"] is not None
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2]) if culled else 0
        return real_index_plan(kw["geo"], S, CC, kw["n_lights"], int(kw["cams"].shape[0]),
                               kw["height"], kw["width"], "mip" if is_k7(kw) else kw["texture"],
                               raster=kw["raster"], seeded=seeded(kw), culled=culled, **force)

    def is_index_visit(kw):
        """Inputs in a mode the index visit's tile teams take (K1 and K6:
        prep rows, raytraced, untextured or nearest or bilinear, cold; K7
        folded; K1's 9-output mode; K1-raw; K8; K10; K1-none on prep and K10
        rows), whatever the plan picks for their count of views."""
        return (not is_batched(kw) and route(kw) in (rc.INDEX, rc.NONE)
                and rc.index_takes(kw["geo"], "mip" if is_k7(kw) else kw["texture"],
                                   kw["raster"], seeded(kw), kw["clusters"] is not None))

    def forced_index_plan(groups):
        """rc.index_plan forced to ``groups`` tile groups (0: the parent
        design, render_body's 16x16 blocks)."""
        def plan(*args, **kwargs):
            return real_index_plan(*args, **dict(kwargs, groups=groups))
        return plan

    def on_index_plan(fn, groups):
        """``fn()`` with rc.index_plan forced to ``groups`` (0: the parent
        design; K7's two launches; None: the plan's own)."""
        rc.index_plan = real_index_plan if groups is None else forced_index_plan(groups)
        try:
            return fn()
        finally:
            rc.index_plan = real_index_plan

    def check_index_plans(tag, kw, k_out):
        """The index visit at every forced plan, G = 1 and 2 groups of tile
        teams (4 pixels a thread; K8, K10 and the raster entry 2), and in
        its parent design (render_body's 16x16 blocks, a plan of 0 groups;
        K7: its two launches) on the same inputs, each bitwise against the kernel's
        outputs ``k_out`` (held to the plain version): K1, K6, K7 folded (so
        also against the pair), K1's 9-output mode, K1-raw, K8, K10,
        K1-none, K2 and K2+K6."""
        same = {}
        for g in (0, *rc._INDEX_GROUP_CHOICES):
            try:
                out = on_index_plan(lambda: rc.render_resident(**kw), g)
            except rc.LaunchPlanError:
                # The teams' block does not fit these inputs: a forced plan
                # is refused before any sweep, and the default is the parent.
                if index_plan_of(kw).groups:
                    raise
                same[f"g{g}"] = "refused"
                continue
            same[f"g{g}"] = all(torch.equal(x, y) for x, y in zip(out, k_out))
        emit({"phase": "plans_vs_kernel", "case": tag, "kernel": variant(kw),
              "plan": index_plan_of(kw)._asdict(), **same})
        if not all(v is True or v == "refused" for v in same.values()):
            raise AssertionError(f"{tag} {variant(kw)}: a forced plan or the parent design "
                                 f"differs: {same}")
        if index_plan_of(kw).groups:
            occ = rc.index_occupancy(kw)
            emit({"phase": "index_occupancy", "case": tag, **occ})
            # index_plan counts blocks a multiprocessor by _INDEX_REGS (an
            # entry's most textured variant's): the entry's registers, as
            # the card allocates them (8 at a time), are at most that and
            # leave the multiprocessor the blocks the plan counts.
            regs = rc._INDEX_REGS[rc.index_entry_key(kw["geo"], kw["clusters"] is not None,
                                                      kw["texture"], kw["raster"])]
            card = -(-occ["registers"] // 8) * 8
            threads = occ["threads"]
            if card > regs or rc._SM_REGS // (threads * card) != rc._SM_REGS // (threads * regs):
                raise AssertionError(f"{tag} {occ['variant']}: {occ['registers']} registers a "
                                     f"thread, index_plan assumes {regs}")

    def forced_streamed_plan(groups, parts):
        """rc.streamed_plan forced, for K11 (dmxu), to ``groups`` tile groups
        and ``parts`` blocks a view (0 groups: the parent design,
        render_body's 16x16 blocks); K3 + K5 keep their own plan."""
        def plan(geo, cc, size, n_lights, *args, dmxu=False, **kwargs):
            if not dmxu:
                return real_streamed_plan(geo, cc, size, n_lights, *args, **kwargs)
            return rc.StreamPlan(groups, parts,
                                 rc.streamed_block_bytes(geo, cc, size, n_lights, groups, True))
        return plan

    def on_plan(fn, kw, groups, parts=1):
        """``fn()`` with ``kw``'s kernel forced to a plan: K12 to ``groups``
        pixels a thread (0: the parent design), K11 on the ordered walk and
        the binned walk's tile groups to ``groups`` tile groups and
        ``parts`` blocks a view (0: the parent design)."""
        if is_batched(kw):
            name, plan = "batched_plan", lambda h, w: real_batched_plan(h, w, groups)
        elif binned(kw):
            name, plan = "binned_plan", forced_plan(groups, parts)
        else:
            name, plan = "streamed_plan", forced_streamed_plan(groups, parts)
        real = getattr(rc, name)
        setattr(rc, name, plan)
        try:
            return fn()
        finally:
            setattr(rc, name, real)

    def check_batched_plans(tag, kw, k_out):
        """K12 on its records (4 pixels a thread) and in its parent design
        (0: one a thread of a 16x16 block) on the same inputs, each bitwise
        against the kernel's outputs ``k_out`` (held to the plain
        version)."""
        same = {}
        for p in rc._BATCHED_PIXEL_CHOICES:
            out = on_plan(lambda: rc.render_batched(**kw), kw, p)
            same[f"pixels{p}"] = all(torch.equal(x, y) for x, y in zip(out, k_out))
        emit({"phase": "plans_vs_kernel", "case": tag, "kernel": variant(kw),
              "plan": {"pixels": rc.batched_plan(kw["height"], kw["width"]).pixels}, **same})
        if not all(same.values()):
            raise AssertionError(f"{tag} {variant(kw)}: a forced plan or the parent design "
                                 f"differs: {same}")

    def forced_plan(groups, parts):
        """rc.binned_plan forced to ``groups`` tile groups and ``parts``
        blocks a view (0 groups: the parent design, render_body's 16x16
        blocks) on prep rows; the other rows keep render_body's blocks."""
        def plan(geo, size, n_lights, views, height, width, bin_tile, dmxu=False, sms=132):
            if geo != "prep":
                return real_binned_plan(geo, size, n_lights, views, height, width, bin_tile,
                                        dmxu, sms)
            return rc.StreamPlan(groups, parts,
                                 rc.binned_block_bytes(geo, size, n_lights, groups, dmxu))
        return plan

    def check_plans(tag, kw, k_out):
        """The streamed walks' tile groups (K4 and K11 on the binned walk's
        prep rows, K11 on the ordered walk) at forced plans, G = 1, 2 and 4
        tile groups with B = 1 and the plan's blocks a view, and their
        parent design (render_body's 16x16 blocks, a plan of 0 groups) on
        the same inputs, each bitwise against the kernel's outputs ``k_out``
        (held to the plain version or to K5)."""
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
        if binned(kw):
            plan = rc.binned_plan(kw["geo"], S // CC, kw["n_lights"],
                                  int(kw["cams"].shape[0]), kw["height"], kw["width"],
                                  kw["bin_tile"], dmxu(kw))
        else:
            plan = rc.streamed_plan(kw["geo"], CC, S // CC, kw["n_lights"],
                                    int(kw["cams"].shape[0]), kw["height"], kw["width"],
                                    dmxu=True)
        plans = sorted({(0, 1)} | {(g, b) for g in (1, 2, 4) for b in (1, max(plan.parts, 1))})
        same = {}
        for g, b in plans:
            out = on_plan(lambda: rc.render_resident(**kw), kw, g, b)
            same[f"g{g}_b{b}"] = all(torch.equal(x, y) for x, y in zip(out, k_out))
        emit({"phase": "plans_vs_kernel", "case": tag, "kernel": variant(kw),
              "plan": {"groups": plan.groups, "blocks_per_view": plan.parts}, **same})
        if not all(same.values()):
            raise AssertionError(f"{tag} {variant(kw)}: a forced plan or the parent design "
                                 f"differs: {same}")

    handoff_keys = ("num_cams", "n_lights", "height", "width", "seg_div", "raster", "geo",
                    "order", "spans", "bins", "ranges", "bin_tile", "seed", "dmxu", "rowskip")

    walk_of = {}
    # Every walk replayed, with weak references to the inputs it read: a
    # walk depends on the geometry rows (0-10), the cluster table, the
    # cameras, the visit's inputs and the seed, not on the attribute rows
    # or the texture, so inputs equal in those (a texture mode of the same
    # scene, a textured twin of a scene's geometry) take its walk.
    walk_shelf = []
    walk_tensors = ("cams", "clusters", "order", "spans", "bins", "ranges", "seed")
    walk_params = ("geo", "raster", "height", "width", "num_cams", "n_lights", "seg_div",
                   "bin_tile", "dmxu", "rowskip")

    def same_walk_inputs(kw, refs) -> bool:
        theirs = [r if r is None else r() for r in refs]
        mine = [kw["rows"]] + [kw.get(k) for k in walk_tensors]
        if any(r is not None and t is None for r, t in zip(refs, theirs)):
            return False  # an input of that walk is gone
        if mine[0].shape != theirs[0].shape:
            return False
        pairs = [(mine[0][:, :rc._N_PREP_ROWS + 1], theirs[0][:, :rc._N_PREP_ROWS + 1])]
        pairs += list(zip(mine[1:], theirs[1:]))
        return all(a is b or (a is not None and b is not None and a.shape == b.shape
                              and torch.equal(a, b)) for a, b in pairs)

    def walks(kw):
        """The kernel's walk on these inputs, replayed in torch ops
        (ops/walk_replay.py: the streamed ordered or binned walk, or the
        resident route's), with the seed where there is one: its frames and
        its work; a walk replayed on equal inputs (``walk_shelf``) is
        reused."""
        seed = kw.get("seed")
        key = (kw["geo"], kw["raster"], kw["rows"].data_ptr(), kw["cams"].data_ptr(),
               route(kw), None if seed is None else seed.data_ptr(), dmxu(kw),
               bool(kw.get("rowskip")))
        if key not in walk_of:
            params = (tuple(kw.get(k) for k in walk_params)
                      + (route(kw), tuple(kw["rows"].shape)))
            found = next((walk for p, refs, walk in walk_shelf
                          if p == params and same_walk_inputs(kw, refs)), None)
            if found is None:
                walk_shelf[:] = [e for e in walk_shelf
                                 if all(r is None or r() is not None for r in e[1])]
                walk = (walk_replay.resident_walk if not streamed(kw)
                        else walk_replay.dmxu_walk if dmxu(kw)
                        else walk_replay.binned_walk if binned(kw)
                        else walk_replay.streamed_walk)
                found = walk(**kw)
                refs = [weakref.ref(t) if t is not None else None
                        for t in [kw["rows"]] + [kw.get(k) for k in walk_tensors]]
                walk_shelf.append((params, refs, found))
            walk_of[key] = found
            # The key holds device addresses: the entry goes when one of its
            # tensors does, before the allocator can hand the address to
            # another input.
            for t in (kw["rows"], kw["cams"], seed):
                if t is not None:
                    weakref.finalize(t, walk_of.pop, key, None)
        return walk_of[key]

    def handoff(kw, plain=False, **hits):
        fn = rc.render_handoff_plain if plain else rc.render_handoff
        return fn(kw["rows"], kw["clusters"], kw["cams"],
                  **{k: kw[k] for k in handoff_keys if k in kw}, **hits)

    def shade(kw, code, hf, plain=False):
        fn = rc.shade_mip_plain if plain else rc.shade_mip
        return fn(code, hf, kw["cams"], kw["mats"], kw["pool"], fb_rows=kw["fb_rows"],
                  texture=kw["texture"], n_lights=kw["n_lights"])

    def check_k7(tag, kw, memo=None):
        """K7's two launches together (check_render) and each alone against
        its plain version on the same inputs, bitwise; returns the card's
        hand-off."""
        check_render(tag, kw, memo=memo)
        k_h = handoff(kw)
        torch.cuda.synchronize()
        h_memo = None if memo is None else memo + ("handoff",)
        if h_memo in plain_memo:
            plain_ms, p_h = plain_memo[h_memo]
        elif h_memo is None:
            plain_ms, p_h = timed_ms(lambda: handoff(kw, plain=True))
        else:
            plain_ms, p_h = plain_run(kw, lambda **k: handoff(k, plain=True, hits=k["hits"]))
            plain_memo[h_memo] = plain_ms, p_h
        note_plain(handoff_plain_of, handoff_name(kw), kw, plain_ms, False)
        h_bitwise = all(torch.equal(a, b) for a, b in zip(k_h, p_h))
        k_rgb = shade(kw, *k_h[2:])
        torch.cuda.synchronize()
        p_rgb = shade(kw, *k_h[2:], plain=True)
        s_lsb = int((k_rgb.view(torch.uint8).int() - p_rgb.view(torch.uint8).int()).abs().max())
        s_name = f"shade_mip_{kw['texture']}"
        max_err[s_name] = max(max_err[s_name], float(s_lsb))
        emit({"phase": "kernel_vs_plain", "kernel": handoff_name(kw), "case": tag,
              "handoff_bitwise": h_bitwise,
              "handoff_max_abs": float((k_h[3] - p_h[3]).abs().max())})
        emit({"phase": "kernel_vs_plain", "kernel": s_name, "case": tag,
              "rgb_max_lsb": s_lsb, "bitwise": bool(torch.equal(k_rgb, p_rgb))})
        if not h_bitwise or not torch.equal(k_rgb, p_rgb):
            raise AssertionError(f"{tag}: a K7 launch differs from its plain version")
        return k_h

    def level_stats(tag, kw, k_h):
        """Pixels per mip level, pixels the window clamp sent to the coarse
        chain and trilinear blends killed, from the card's hand-off."""
        code, hf = k_h[2], k_h[3]
        V, H, Wd = code.shape
        c = code.reshape(V, -1)
        u, v, fp = hf.reshape(6, V, -1)[:3]
        found = (c & rc._FOUND_BIT) != 0
        lvl, lvl_c, kill, _ = mips.mip_levels(kw["mats"], kw["fb_rows"], c & 0xFFFF, u, v,
                                              fp, found, H, Wd, "trilinear")
        _, lvl_b, _, _ = mips.mip_levels(kw["mats"], kw["fb_rows"], c & 0xFFFF, u, v,
                                         fp, found, H, Wd, "nearest")
        stats = {"pixels_per_level": torch.bincount(
                     lvl[found].long(), minlength=mips.num_levels(kw["mats"])).tolist(),
                 "clamped_nearest": int((lvl_b != lvl).sum()),
                 "clamped_bilinear": int((lvl_c != lvl).sum()),
                 "blend_killed": int(kill.sum())}
        emit({"phase": "k7_levels", "case": tag, "fb_rows": kw["fb_rows"],
              "levels": mips.num_levels(kw["mats"]), **stats})
        return stats

    # ---- 3. each kernel against its plain version on the card ----------- #
    tex_png = scenes.demo_texture_png(TEX_SIZE)
    # The 256x256 checker (65,536 texels): baked without mips, past the
    # in-kernel texture route, it takes the 9-output mode on every visit.
    tex256_png = png_texture(f"paged_{PAGED_TEX_SIZE}", checker_texture(PAGED_TEX_SIZE), scenes)
    two_lights = [((1.0, -1.0, -0.05), (0.7, 0.7, 0.7)),
                  ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2))]
    occluder_lights = [((1.0, 1.0, 0.0), (1.0, 1.0, 1.0))]
    cases = {
        "demo64_dynamic": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod), {}),
        "demo64_dynamic_tex32": (
            demo_scene(SMALL_WORLDS, True, scenes, cfg_mod, textured=True), {}),
        "demo64_4cams": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod, num_cams=4), {}),
        "demo64_4cams_tex32": (
            demo_scene(SMALL_WORLDS, True, scenes, cfg_mod, textured=True, num_cams=4), {}),
        "random7": (random_scene(7, SMALL_WORLDS, cfg_mod), {}),
        "random8": (random_scene(8, SMALL_WORLDS, cfg_mod), {}),
        "random9_textured": (random_scene(9, SMALL_WORLDS, cfg_mod, tex_png), {}),
        "random10_1to3cams": (random_scene(10, SMALL_WORLDS, cfg_mod, max_cams=3), {}),
        "demo64_40x24_two_lights": (demo_scene(SMALL_WORLDS, True, scenes, cfg_mod),
                                    dict(height=40, width=24, lights=two_lights)),
        "occluder64_one_light": (occluder_scene(SMALL_WORLDS, cfg_mod),
                                 dict(lights=occluder_lights)),
        "occluder64_two_lights": (occluder_scene(SMALL_WORLDS, cfg_mod),
                                  dict(lights=occluder_lights + two_lights[1:])),
        "seam64": (seam_scene(SMALL_WORLDS, cfg_mod), {}),
        "seam64_unsplit": (seam_scene(SMALL_WORLDS, cfg_mod, split=False), {}),
        "terrain27_64": (bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True,
                                       grid=RESIDENT_GRID), {}),
        # At 128², the bin tiling of resident_terrain_1024w_128 (8x8 bin
        # tiles of 16 px).
        "terrain27_128": (bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True,
                                        grid=RESIDENT_GRID), dict(height=128, width=128)),
        # The 9-output mode on every resident visit (K3 and K4 on resident
        # rows, K1 and K1-none), lit by a sun whose shadows the epilogue
        # traces.
        "terrain27_64_tex256": (bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True,
                                              grid=RESIDENT_GRID, texture=tex256_png),
                                dict(mipmaps=False, lights=NINE_SUN)),
    }
    for tag, (parts, opts) in cases.items():
        geo, mats, textures, insts, cams, worlds = parts
        scene = bake_scene(load_render_assets(geo, [], mats, textures), dev,
                           mipmaps=opts.get("mipmaps", "auto"))
        if "lights" in opts:
            scene = configure_lighting(scene, lights=opts["lights"])
        state = init_state(insts, cams, worlds, dev)
        if state.max_cameras == 1:
            check_pack(tag, state, scene, state.camera_pos[:, 0, :])
        check_pack(tag, state, scene, None)
        size = dict(height=opts.get("height", HEIGHT), width=opts.get("width", WIDTH))
        nine_scene = rc.output_mode(scene) == "nine"
        filters = (("nearest", "bilinear") if rc.is_textured(scene) and not nine_scene
                   else ("nearest",))
        for watertight, shadows, raster, filt in itertools.product(
                (False, True), (False, True), (False, True), filters):
            if nine_scene and watertight and shadows:
                continue  # the 9-output mode's K10 entries without the shadows'
            clear_plain()
            key = (watertight, shadows, raster, filt)
            if filt == filters[0]:
                kw = rc.pack_inputs(state, scene, raster=raster, texture_filter=filt,
                                    near=0.001 if raster else 0.1, shadows=shadows,
                                    watertight=watertight, **size)
                # The four resident visits (K1, K3, K4 on resident rows,
                # K1-none), each seeded (K9) too in the raytrace conventions;
                # the other filter takes the same tensors (and seed), so its
                # variants share the plain sweeps and the replayed walks.
                visits0 = resident_visits(kw, state, scene, none=True)
            visits = [dict(v, texture=filt) if v["texture"] in shade_filters else v
                      for v in visits0]
            out = [check_render(tag, vkw, memo=key) for vkw in visits][0]
            if not raster:
                if filt == filters[0]:
                    seed = seed_for(out[0])
                for vkw in visits:
                    check_render(tag, dict(vkw, seed=seed), memo=key + ("seed",))
            if nine_scene and shadows and not raster:
                # The 9-output route's shadows (the epilogue's compute_lit)
                # on the ordered and binned visits' outputs: darker somewhere,
                # brighter nowhere, depth and segmask the unshadowed ones.
                for vkw in visits[1:3]:
                    o = rc.render_resident(**vkw)
                    f_sh = rc.frames_from_core(state, *o, scene=scene, shadows=True)
                    f_lit = rc.frames_from_core(state, *o, scene=scene)
                    darker = f_lit.rgb.int() - f_sh.rgb.int()
                    emit({"phase": "nine_shadows", "case": tag, "kernel": variant(vkw),
                          "shadowed_pixels": int((darker > 0).any(-1).sum())})
                    if (not bool((darker > 10).any()) or bool((darker < 0).any())
                            or not torch.equal(f_lit.depth, f_sh.depth)
                            or not torch.equal(f_lit.segmask, f_sh.segmask)):
                        raise AssertionError(f"{tag} {variant(vkw)}: the epilogue's shadows "
                                             "do not show")
            if not shadows and filt == filters[0] and not nine_scene:
                # The 9-output mode on K1's and K1-none's sweeps (the scene's
                # own rows: prep, raw or K10's), seeded too.
                nine = dict(visits[0], texture="nine", mats=None, pool=None, fb_rows=None)
                nines = [nine, dict(nine, clusters=None)]
                # The shaded checks' seed (the same depth), so that the plain
                # sweeps are theirs.
                for n in nines:
                    check_render(tag, n, memo=key + ("nine",))
                if not raster:
                    for n in nines:
                        check_render(tag, dict(n, seed=seed), memo=key + ("nine", "seed"))
            if not watertight and filt == filters[0]:
                # K12, shaded and in the 9-output mode, on the raw rows.
                kw_b = rc.pack_inputs(state, scene, raster=raster, near=0.001 if raster else 0.1,
                                      shadows=shadows, accel="mxu", **size)
                for nine in (False, True):
                    check_render(tag, dict(kw_b, nine=nine), memo=key + ("mxu", nine))
                if shadows and not raster and tag.startswith("occluder"):
                    # The shadow epilogue on the card: K12's 9-output mode,
                    # then compute_lit; the shadow darkens some pixels.
                    kw_rt = dict(size, shadows=True, accel="mxu")
                    dark = rc.raytrace(state, scene, **kw_rt).rgb.int()
                    lit = rc.raytrace(state, scene, **dict(kw_rt, shadows=False)).rgb.int()
                    if not bool(((lit - dark) > 10).any()) or bool(((lit - dark) < 0).any()):
                        raise AssertionError(f"{tag}: the mxu route's shadow does not show")
            kw = visits[0]
            if tag.startswith("occluder") and shadows and not raster:
                # The shadow falls on the ground: some lit pixels go dark.
                lit = check_render(tag, dict(kw, geo=kw["geo"][:-len("_shadows")]),
                                   memo=key + ("lit",))
                darker = lit[2].view(torch.uint8).int() - out[2].view(torch.uint8).int()
                if not bool((darker > 10).any()) or bool((darker < 0).any()):
                    raise AssertionError(f"{tag}: the shadow does not show")
            if tag.startswith("seam") and watertight and not raster:
                # No pixel strictly inside the quad misses through the
                # diagonal (tests/test_watertight_pallas.py:138-154).
                lo, hi = int(math.ceil(HEIGHT / 3)) + 2, int(HEIGHT * 2 / 3) - 2
                inner = out[1][0, lo:hi, lo:hi]
                emit({"phase": "seam", "case": tag, "shadows": shadows,
                      "interior_pixels": int(inner.numel()),
                      "cracks": int((inner < 0).sum())})
                if bool((inner < 0).any()):
                    raise AssertionError(f"{tag}: crack pixels inside the quad")

    # K7 on the mip scenes of tests/test_mips.py, every variant.
    gradient_png = png_texture("gradient_256", gradient_texture(), scenes)
    sun = [((1.0, 1.0, 0.0), (1.0, 1.0, 1.0))]
    mip_cases = {
        "mip64_gradient": ("gradient", {}),
        "mip64_gradient_64x256": ("gradient", dict(width=256)),
        "mip64_gradient_2cams": ("gradient_2cams", {}),
        "mip64_overflow": ("overflow", {}),
        "mip64_seam_48x48": ("seam", dict(height=48, width=48)),
        "mip64_closeup_32x32": ("closeup", dict(height=32, width=32)),
    }
    totals = {"clamped_nearest": 0, "clamped_bilinear": 0, "blend_killed": 0}
    for tag, (kind, size) in mip_cases.items():
        geo, mats, textures, insts, cams, worlds = mip_scene(kind, SMALL_WORLDS, cfg_mod,
                                                             gradient_png)
        scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
        if not rc.has_mips(scene):
            raise AssertionError(f"{tag}: the 256x256 texture baked no mip chains")
        state = init_state(insts, cams, worlds, dev)
        size = dict(dict(height=HEIGHT, width=WIDTH), **size)
        for shadows in (False, True):
            lit = configure_lighting(scene, lights=sun) if shadows else scene
            for raster in (False, True):
                for filt in MIP_FILTERS:
                    kw = rc.pack_inputs(state, lit, raster=raster, texture_filter=filt,
                                        near=0.001 if raster else 0.1, shadows=shadows,
                                        **size)
                    k_h = check_k7(tag, kw)
                    if not shadows and not raster and filt == "trilinear":
                        for k, v in level_stats(tag, kw, k_h).items():
                            if k in totals:
                                totals[k] += v
                # Trilinear (both K7 launches at work) through the three
                # resident visits, without and with K10, each seeded (K9) too
                # in the raytrace conventions.
                for watertight in (False, True):
                    kw = rc.pack_inputs(state, lit, raster=raster, texture_filter="trilinear",
                                        near=0.001 if raster else 0.1, shadows=shadows,
                                        watertight=watertight, **size)
                    visits = resident_visits(kw, state, lit, none=True)
                    clear_plain()
                    key = (shadows, raster, watertight)
                    k_h = [check_k7(tag, vkw, memo=key) for vkw in visits][0]
                    if not raster:
                        seed = seed_for(k_h[0])
                        for vkw in visits:
                            check_k7(tag, dict(vkw, seed=seed), memo=key + ("seed",))
    emit({"phase": "k7_levels", "case": "all", **totals})
    if not (totals["clamped_bilinear"] and totals["blend_killed"]):
        raise AssertionError(f"the mip scenes did not exercise the clamp and the kill: {totals}")

    # K3 + K5, the streamed route: every variant bitwise against its plain
    # version at 64 worlds on bench.py's big-mesh scene with per-world
    # orders (also with two cameras, a 32x32 texture and a 256x256
    # mip-mapped one), on the streamed scenes of the JAX tests and on the
    # tie scene. The first scene that runs a variant gives its timing inputs.
    streamed_cases = {
        "bigmesh64": bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True),
        "bigmesh64_2cams": bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True, num_cams=2),
        "bigmesh64_tex32": bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True,
                                         texture=tex_png),
        "bigmesh64_2cams_tex32": bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True,
                                               num_cams=2, texture=tex_png),
        "bigmesh64_mip256": bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True,
                                          texture=gradient_png),
        # Baked without mips: the 9-output mode on K3 + K5, K4 and K11.
        "bigmesh64_tex256": bigmesh_scene(SMALL_WORLDS, cfg_mod, scenes, vary=True,
                                          texture=tex256_png),
        "cloud64": streamed_test_scene("cloud", SMALL_WORLDS, cfg_mod),
        "instances64": streamed_test_scene("instances64", SMALL_WORLDS, cfg_mod),
        "hetero64": streamed_test_scene("hetero", SMALL_WORLDS, cfg_mod),
        "two_cams64": streamed_test_scene("two_cams", SMALL_WORLDS, cfg_mod),
        "tie64": streamed_test_scene("tie", SMALL_WORLDS, cfg_mod),
    }
    # K10's streamed variants on the varied terrain (untextured, 32x32 and
    # 256x256 mip textures) and the tie scene; K9's (seeded, raytraced) on
    # the terrain scenes and the tie scene.
    wt_streamed = ("bigmesh64", "bigmesh64_tex32", "bigmesh64_mip256", "bigmesh64_tex256",
                   "tie64")
    seeded_streamed = ("bigmesh64", "bigmesh64_2cams", "bigmesh64_tex32",
                       "bigmesh64_2cams_tex32", "bigmesh64_mip256", "bigmesh64_tex256", "tie64")
    no_mips = ("bigmesh64_tex256",)
    streamed_kw = {}

    seeds = {}

    def check_seeded(tag, kw, depth, memo):
        """The variant seeded (K9) by seed_for(depth) (one seed per scene
        and mode, shared by its two visits, its texture filters, whose depth
        is the same, and their plain version), against the seeded plain
        version; its first inputs time it."""
        mode = tuple(x for x in memo if x not in MIP_FILTERS)
        if mode not in seeds:
            seeds[mode] = seed_for(depth)
        kw = dict(kw, seed=seeds[mode])
        out = (check_k7 if is_k7(kw) else check_render)(tag, kw, memo=memo + ("seed",))
        streamed_kw.setdefault(handoff_name(kw) if is_k7(kw) else variant(kw), kw)
        return kw, out

    def walk_matches(tag, kw, out):
        """K11's replayed walk (walk_replay.dmxu_walk) renders the kernel's
        depth and segmask, bitwise (raytraced: the replay writes t and
        idx // seg_div, as the raytrace export does; in the 9-output mode
        the kernel's t, and its idx so divided)."""
        if kw["raster"]:
            return
        walk = walks(kw)
        seg = out[1]
        if kw.get("texture") == "nine":
            seg = torch.where(out[2] >= 0, out[2] // kw["seg_div"], -1)
        same = torch.equal(walk["depth"], out[0]) and torch.equal(walk["segmask"], seg)
        emit({"phase": "walk_vs_kernel", "case": tag, "kernel": handoff_name(kw) if is_k7(kw)
              else variant(kw), "pixel_tests": walk["pixel_tests"], "bitwise": same})
        if not same:
            raise AssertionError(f"{tag} {variant(kw)}: the replayed walk differs")

    def check_dmxu(tag, kw, kw_route, memo, seed_it):
        """K11 on ``kw`` against its plain version (prep rows: the plain
        outputs and seed of ``memo``'s mode, the route's own; raw rows each
        view's D, A, Q, t_num: their own) and, prep, against the route's
        kernel (K5 or K4) on ``kw_route``, bitwise; seeded too (K9)."""
        memo = memo if kw["geo"] == "prep" else memo + ("dmxu",)
        out = check_k7(tag, kw, memo=memo)[:2] if is_k7(kw) else check_render(tag, kw, memo=memo)
        streamed_kw.setdefault(handoff_name(kw) if is_k7(kw) else variant(kw), kw)
        walk_matches(tag, kw, out)
        if kw_route is not None:
            k11, other = rc.render_resident(**kw), rc.render_resident(**kw_route)
            same = all(torch.equal(a, b) for a, b in zip(k11, other))
            emit({"phase": "dmxu_vs_k4" if binned(kw) else "dmxu_vs_k5", "case": tag,
                  "kernel": variant(kw), "rowskip": kw["rowskip"], "bitwise": same})
            if not same:
                raise AssertionError(f"{tag} {variant(kw)}: K11 differs from {variant(kw_route)}")
        if seed_it:
            walk_matches(tag, *check_seeded(tag, kw, out[0], memo))
        return out

    for tag, parts in streamed_cases.items():
        geo, mats, textures, insts, cams, worlds = parts
        scene = bake_scene(load_render_assets(geo, [], mats, textures), dev,
                           mipmaps=False if tag in no_mips else "auto")
        state = init_state(insts, cams, worlds, dev)
        if not rc.is_streamed(state, scene):
            raise AssertionError(f"{tag}: the scene fits the resident budget")
        mip = rc.has_mips(scene)
        nine_scene = rc.output_mode(scene) == "nine"
        # The mip scene under trilinear only (every filter took 100 s of the
        # run): the hand-off entries
        # are one for every filter, trilinear runs both K7 launches in full,
        # and the filters' shade_mip entries are held on the mip scenes above.
        filters = (("trilinear",) if mip else ("nearest", "bilinear")
                   if rc.is_textured(scene) and not nine_scene else ("nearest",))
        # The two visits of a mode last: they share its plain outputs and
        # seeds; a mode's second filter takes the first's tensors (and seed),
        # so that its variants share the plain sweeps and the replayed walks.
        packed = {}
        for watertight, shadows, raster, filt, accel in itertools.product(
                (False, True) if tag in wt_streamed else (False,), (False, True),
                (False, True), filters, ("clusters", "binned")):
            if nine_scene and watertight and shadows:
                continue  # the 9-output mode's K10 entries without the shadows'
            if accel == "clusters":
                clear_plain()
                if filt == filters[0]:
                    seeds.clear()
                    packed.clear()
            key = (watertight, shadows, raster, filt)
            lit = (configure_lighting(scene, lights=[((0.5, 1.0, 0.0), (1.0, 1.0, 1.0))])
                   if shadows and tag == "cloud64" else
                   configure_lighting(scene, lights=NINE_SUN) if shadows and nine_scene
                   else scene)  # tests/test_shadows.py:176
            if filt == filters[0]:
                opts = dict(raster=raster, texture_filter=filt, near=0.001 if raster else 0.1,
                            height=HEIGHT, width=WIDTH, accel=accel)
                packed[accel] = (
                    rc.pack_inputs(state, lit, shadows=shadows, watertight=watertight, **opts),
                    rc.pack_inputs(state, lit, deferred_mxu=True, **opts)
                    if not shadows and not watertight else None)
            kw, kw_m = (None if k is None else dict(k, texture=filt)
                        if k["texture"] in shade_filters else k for k in packed[accel])
            out = check_k7(tag, kw, memo=key)[:2] if mip else check_render(tag, kw, memo=key)
            streamed_kw.setdefault(handoff_name(kw) if mip else variant(kw), kw)
            seed_it = tag in seeded_streamed and not raster and (not mip or filt == "trilinear")
            if seed_it:
                check_seeded(tag, kw, out[0], key)
            # K11 (deferred_mxu) in the same mode.
            dmxu_mode = kw_m is not None
            if dmxu_mode:
                check_dmxu(tag, kw_m, kw if kw["geo"] == "prep" else None, key, seed_it)
            if (mip or nine_scene) and not shadows and not watertight:
                # The one-camera mip scene on the raw rows too (and K11's);
                # the 9-output scene's K11 on raw rows (its K3 + K5 and K4
                # take them under shadows).
                raw_rows = pack_cuda.pack_rows(state, lit)
                if mip:
                    kw = dict(kw, rows=raw_rows, geo="raw", ranges=None)
                    raw_out = check_k7(tag, kw, memo=key + ("raw",))
                    streamed_kw.setdefault(handoff_name(kw), kw)
                    if seed_it:
                        check_seeded(tag, kw, raw_out[0], key + ("raw",))
                check_dmxu(tag, dict(kw_m, rows=raw_rows, geo="raw"), None,
                           key + ("raw",), seed_it)
            if nine_scene and shadows and not raster and accel == "clusters":
                # The 9-output route's shadows (the epilogue's compute_lit)
                # on K3 + K5's outputs.
                f_sh = rc.frames_from_core(state, *out, scene=lit, shadows=True)
                f_lit = rc.frames_from_core(state, *out, scene=lit)
                darker = f_lit.rgb.int() - f_sh.rgb.int()
                emit({"phase": "nine_shadows", "case": tag, "kernel": variant(kw),
                      "shadowed_pixels": int((darker > 0).any(-1).sum())})
                if (not bool((darker > 10).any()) or bool((darker < 0).any())
                        or not torch.equal(f_lit.depth, f_sh.depth)):
                    raise AssertionError(f"{tag} {variant(kw)}: the epilogue's shadows do "
                                         "not show")
            if tag == "tie64" and not raster:
                # The quad's pixels tie between instances 0 and 1: instance
                # 0 wins them; instance 1 keeps the small triangle in front
                # (binned: on row-sorted rows too).
                tie = {v: int((out[1] == v).sum()) for v in (0, 1)}
                emit({"phase": "tie", "shadows": shadows, "watertight": watertight,
                      "binned": accel == "binned", "pixels": tie})
                if tie[0] <= tie[1]:
                    raise AssertionError(f"tie64: the ties did not go to instance 0: {tie}")

    # K11's row gate (rowskip: 256 wide, the TPU tiling's 2 tiles across) on
    # both walks: the varied terrain with one and two cameras at 64x256, each
    # K11 entry against its plain version, its rowskip=False launch and (prep)
    # the route's kernel, seeded too.
    for tag in ("bigmesh64", "bigmesh64_2cams"):
        geo, mats, textures, insts, cams, worlds = streamed_cases[tag]
        scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
        state = init_state(insts, cams, worlds, dev)
        for raster in (False, True):
            clear_plain()
            seeds.clear()
            for accel in ("clusters", "binned"):
                opts = dict(raster=raster, near=0.001 if raster else 0.1,
                            height=ROWSKIP_SIZE[0], width=ROWSKIP_SIZE[1], accel=accel)
                kw_m = rc.pack_inputs(state, scene, deferred_mxu=True, **opts)
                case = f"{tag}_{ROWSKIP_SIZE[0]}x{ROWSKIP_SIZE[1]}"
                if not kw_m["rowskip"]:
                    raise AssertionError(f"{case}: K11's row gate is off")
                kw_r = rc.pack_inputs(state, scene, **opts)
                out = check_dmxu(case, kw_m, kw_r if kw_r["geo"] == "prep" else None,
                                 (raster,), not raster)
                off = rc.render_resident(**dict(kw_m, rowskip=False))
                same = all(torch.equal(a, b) for a, b in zip(out, off))
                emit({"phase": "rowskip_off", "case": case, "kernel": variant(kw_m),
                      "bitwise": same})
                if not same:
                    raise AssertionError(f"{case} {variant(kw_m)}: rowskip=False differs")
                if tag == "bigmesh64" and not raster and accel == "clusters":
                    extra_timing.append((variant(kw_m), case, kw_m))

    # K4 on 4 worlds of the binned terrain at 128x128 (tools/tpu_binned_bench.py's
    # scene, the terrains turned apart): every geometry variant, raytraced
    # and rasterized, bitwise against its plain version and against K5 on
    # the same inputs. And the seam scene made streamed (the crack quad, a
    # cloud behind the camera): no crack under bins either.
    terrain_cfg = scenes.binned_terrain_config(TERRAIN_CHECK_WORLDS, 128, 128)
    t_scene = bake_scene(load_render_assets(terrain_cfg.rcfg.geo_cfg, [],
                                            terrain_cfg.rcfg.additional_mats, []), dev)
    t_state = init_state(terrain_cfg.rcfg.instances, terrain_cfg.rcfg.cameras,
                         terrain_cfg.rcfg.worlds, dev)
    yaw = torch.arange(TERRAIN_CHECK_WORLDS, device=dev, dtype=torch.float32) * 0.1
    t_state.instance_rot[:, 0] = torch.stack(
        [torch.cos(yaw), 0 * yaw, 0 * yaw, torch.sin(yaw)], dim=-1)
    sun = [((0.5, 1.0, -1.0), (1.0, 1.0, 1.0))]
    for shadows, watertight, raster in itertools.product((False, True), (False, True),
                                                         (False, True)):
        lit = configure_lighting(t_scene, lights=sun) if shadows else t_scene
        opts = dict(height=128, width=128, raster=raster, near=0.001 if raster else 0.1,
                    shadows=shadows, watertight=watertight)
        pairs = [(rc.pack_inputs(t_state, lit, accel="binned", **opts),
                  rc.pack_inputs(t_state, lit, accel="clusters", **opts))]
        if pairs[0][0]["geo"] == "prep":  # the raw sweep on the terrain too
            raw_rows = pack_cuda.pack_rows(t_state, lit)
            pairs.append(tuple(dict(kw, rows=raw_rows, geo="raw", ranges=None)
                               for kw in pairs[0]))
        clear_plain()
        for kw, kw5 in pairs:
            memo = ("terrain4", kw["geo"])
            k4 = check_render("terrain4_128", kw, memo=memo)
            k5 = rc.render_resident(**kw5)
            same = all(torch.equal(x, y) for x, y in zip(k4, k5))
            emit({"phase": "k4_vs_k5", "case": "terrain4_128", "kernel": variant(kw),
                  "bitwise": same})
            if not same:
                raise AssertionError(f"terrain4_128 {variant(kw)}: K4 differs from K5")
            streamed_kw.setdefault(variant(kw), kw)
            if not shadows and not watertight:
                # K11 on the same rows unsorted: against the plain version
                # (prep: K4's) and against K4.
                kw_m = rc.pack_inputs(t_state, lit, accel="binned", deferred_mxu=True, **opts)
                if kw["geo"] == "raw":
                    kw_m = dict(kw_m, rows=kw["rows"], geo="raw")
                check_dmxu("terrain4_128", kw_m, kw if kw["geo"] == "prep" else None, memo,
                           False)
    # The 9-output mode on the same 4 worlds textured with the 256x256
    # checker, baked without mips: K4 on the row-sorted prep rows and on raw
    # rows, bitwise against the plain version and against K5, and K11's
    # binned visit on the same rows unsorted, with and without its row gate
    # (forced on at 128², where the TPU tiling has one tile across), against
    # the plain version and (prep) K4.
    nine_cfg = scenes.binned_terrain_config(TERRAIN_CHECK_WORLDS, 128, 128,
                                            texture=tex256_png)
    n_scene = bake_scene(load_render_assets(nine_cfg.rcfg.geo_cfg, [],
                                            nine_cfg.rcfg.additional_mats,
                                            list(nine_cfg.rcfg.additional_textures)), dev,
                         mipmaps=False)
    for raster in (False, True):
        opts = dict(height=128, width=128, raster=raster, near=0.001 if raster else 0.1)
        kws = (rc.pack_inputs(t_state, n_scene, accel="binned", **opts),
               rc.pack_inputs(t_state, n_scene, accel="clusters", **opts),
               rc.pack_inputs(t_state, n_scene, accel="binned", deferred_mxu=True, **opts))
        if kws[0]["texture"] != "nine" or kws[0]["ranges"] is None:
            raise AssertionError("terrain4_128_tex256: not the 9-output mode on ranges")
        raw_rows = pack_cuda.pack_rows(t_state, n_scene)
        clear_plain()
        for geo in ("prep", "raw"):
            if geo == "raw":
                kws = tuple(dict(k, rows=raw_rows, geo="raw", ranges=None) for k in kws)
            kw, kw5, kw_m = kws
            memo = ("terrain4_tex256", geo)
            k4 = check_render("terrain4_128_tex256", kw, memo=memo)
            same = all(torch.equal(x, y) for x, y in zip(k4, rc.render_resident(**kw5)))
            emit({"phase": "k4_vs_k5", "case": "terrain4_128_tex256", "kernel": variant(kw),
                  "bitwise": same})
            if not same:
                raise AssertionError(f"terrain4_128_tex256 {variant(kw)}: K4 differs from K5")
            streamed_kw.setdefault(variant(kw), kw)
            for rowskip in (True, False):
                check_dmxu("terrain4_128_tex256", dict(kw_m, rowskip=rowskip),
                           kw if geo == "prep" else None, memo, False)
    parts = seam_scene(SMALL_WORLDS, cfg_mod, fill=True)
    seam_state = init_state(*parts[3:], dev)
    seam_sc = bake_scene(load_render_assets(parts[0], [], [], []), dev)
    for shadows in (False, True):
        lit = configure_lighting(seam_sc, lights=sun) if shadows else seam_sc
        kw = rc.pack_inputs(seam_state, lit, height=HEIGHT, width=WIDTH, watertight=True,
                            shadows=shadows, accel="binned")
        if not binned(kw):
            raise AssertionError("seam64_streamed: the scene did not take the binned route")
        out = check_render("seam64_streamed", kw)
        lo, hi = int(math.ceil(HEIGHT / 3)) + 2, int(HEIGHT * 2 / 3) - 2
        inner = out[1][0, lo:hi, lo:hi]
        emit({"phase": "seam", "case": "seam64_streamed", "shadows": shadows, "binned": True,
              "interior_pixels": int(inner.numel()), "cracks": int((inner < 0).sum())})
        if bool((inner < 0).any()):
            raise AssertionError("seam64_streamed: crack pixels inside the quad")

    # ---- 4. the paths --------------------------------------------------- #
    def reset_counts():
        rc.render_resident.launches = 0
        rc.render_resident.variant_launches = dict.fromkeys(rc.RENDER_VARIANTS
                                                            + rc.MIP_VARIANTS, 0)
        rc.render_batched.launches = 0
        rc.render_batched.variant_launches = dict.fromkeys(rc.BATCHED_VARIANTS, 0)
        rc.shade_mip.launches = 0
        rc.shade_mip.variant_launches = dict.fromkeys(rc.SHADE_MIP_VARIANTS, 0)
        pack_cuda.pack_rows.layout_launches = dict.fromkeys(pack_cuda.LAYOUTS, 0)

    def drive(path, mode, n_worlds, textured, timed_steps, num_cams=1, cfg=None, moved=0,
              size=HEIGHT, record=None, **opts):
        """One path through MadronaRenderer: construct (which primes one
        step), then warm-up and timed steps, each after moving world 0's
        instance ``moved`` (the demo's cube) through the exported position
        tensor. Every view of world 0 that saw it must change and every view
        of world 1 stay bit-identical. Returns the renderer, the step times,
        the launch counts of the run, the constructor's time and the
        variant's name. The scene is the demo scene unless ``cfg`` names
        another, at ``size``²; ``opts`` (shadows, watertight, ssaa,
        warmstart) go to MadronaRenderer. With ``record`` (a list), each
        step's state and exported depth, segmask and rgb are appended to it.
        Under warmstart each step launches K9's variant once, or twice when
        it repairs."""
        if cfg is None:
            cfg = scenes.demo_config(n_worlds, mode, WIDTH, HEIGHT, dynamic=True,
                                     textured=textured, tex_size=TEX_SIZE,
                                     num_cams=num_cams)
        C = num_cams
        reset_counts()
        t0 = time.perf_counter()
        r = m.MadronaRenderer(0, n_worlds, mode, size, size, **opts,
                              **scenes.renderer_kwargs(cfg))
        torch.cuda.synchronize()
        ctor_s = time.perf_counter() - t0
        raster = mode == m.RenderMode.Rasterizer
        pos = r.instance_position_tensor().to_torch()
        step_s = []
        for i in range(WARMUP_STEPS + timed_steps):
            depth0 = r.depth_tensor().to_torch()[:2 * C].clone()
            rgb0 = r.rgb_tensor().to_torch()[:2 * C].clone()
            if raster:  # the cube shows in the depth of the views that see it
                sees = torch.ones(C, dtype=torch.bool, device=dev)
            else:
                sees = (r.segmask_tensor().to_torch()[:C] == moved).flatten(1).any(1)
            # The instance moves along all three axes, so the depth of every
            # face of it any camera sees changes.
            pos[moved][0] += 0.03
            pos[moved][1] += 0.05
            pos[moved][2] += 0.02
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.step()
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                step_s.append(time.perf_counter() - t0)
            depth1 = r.depth_tensor().to_torch()[:2 * C]
            rgb1 = r.rgb_tensor().to_torch()[:2 * C]
            changed = (depth0[:C] != depth1[:C]).flatten(1).any(1)
            if not bool(sees.any()) or bool((sees & ~changed).any()):
                raise AssertionError(f"{path} step {i}: a view of world 0 that sees the "
                                     f"cube did not change ({sees.tolist()}, "
                                     f"{changed.tolist()})")
            if not (torch.equal(depth0[C:], depth1[C:]) and torch.equal(rgb0[C:], rgb1[C:])):
                raise AssertionError(f"{path} step {i}: world 1 changed without a mutation")
            if record is not None:
                record.append((r.state, r.depth_tensor().to_torch().clone(),
                               r.segmask_tensor().to_torch().clone(),
                               r.rgb_tensor().to_torch().clone()))
        counts = launch_counts()
        steps = 1 + WARMUP_STEPS + timed_steps
        kw = path_inputs(r)
        name = variant(dict(kw, seed=kw["cams"]) if r.cfg.warmstart else kw)
        pack_layout = pack_cuda.LAYOUTS[kw["geo"] != "prep"]
        expected = dict.fromkeys(kernel_names, 0)
        expected.update({part: steps for part in name.split("+")}, **{pack_layout: steps})
        launched = steps
        if r.cfg.warmstart and steps <= counts[name] <= 2 * steps:
            launched = expected[name] = counts[name]  # the repair passes
        if counts != expected or rc.render_resident.launches != launched:
            raise AssertionError(f"{path}: launches {counts} in {steps} steps, "
                                 f"expected {expected}")
        return r, step_s, counts, ctor_s, name

    def launch_counts():
        return dict(rc.render_resident.variant_launches, **rc.render_batched.variant_launches,
                    **rc.shade_mip.variant_launches, **pack_cuda.pack_rows.layout_launches)

    def path_inputs(r, **over):
        """The path's kernel inputs for the renderer's state (at ssaa x its
        view size)."""
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer
        kw = dict(height=r.cfg.batch_render_view_height * r.cfg.ssaa,
                  width=r.cfg.batch_render_view_width * r.cfg.ssaa, raster=raster,
                  near=r.cfg.raster_near_plane if raster else r.cfg.near_plane,
                  texture_filter=r.cfg.texture_filter, shadows=bool(r.cfg.shadows),
                  watertight=bool(r.cfg.watertight), accel=r.cfg.accel,
                  deferred_mxu=bool(r.cfg.deferred_mxu))
        kw.update(over)
        return rc.pack_inputs(r.state, r.scene, **kw)

    def full_size_checks(path, r, name):
        """The path's kernel on the last step's inputs (under SSAA, filtered
        down) reproduces the exported frames; K13 and the kernel equal their
        plain versions at full size."""
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer
        kw = path_inputs(r)
        k_out = rc.render_resident(**kw)
        if r.cfg.ssaa > 1:
            f = ssaa.downsample_frames(rc.frames_from_core(r.state, *k_out), r.cfg.ssaa)
            k_out = (f.depth.reshape(-1, HEIGHT, WIDTH), f.segmask.reshape(-1, HEIGHT, WIDTH),
                     f.rgb.contiguous().view(torch.int32).reshape(-1, HEIGHT, WIDTH))
        depth = r.depth_tensor().to_torch()
        depth = depth[..., 0] if raster else depth
        rgb = r.rgb_tensor().to_torch().contiguous().view(torch.int32).squeeze(-1)
        exported = [depth, rgb]
        if not raster:
            exported.insert(1, r.segmask_tensor().to_torch())
        produced = [k_out[0], k_out[2]] if raster else list(k_out)
        if not all(torch.equal(k, e) for k, e in zip(produced, exported)):
            raise AssertionError(f"{path}: {name} on the last step's inputs differs "
                                 "from the exports")
        if not torch.isfinite(depth).all() or not bool((depth > 0).any()):
            raise AssertionError(f"{path}: depth not finite or empty")
        check_pack(path, r.state, r.scene,
                   r.state.camera_pos[:, 0, :] if kw["geo"] == "prep" else None)
        check_render(path, kw)
        return kw

    def time_path(path, r, step_s, counts, ctor_s, extra):
        raster = r.cfg.render_mode == m.RenderMode.Rasterizer
        n_views = r.total_num_cameras
        step_ms = statistics.median(step_s) * 1e3
        emit({"phase": path, "card": card, "nvidia_smi": smi,
              "worlds": r.cfg.num_worlds, "views": n_views,
              "height": r.cfg.batch_render_view_height,
              "width": r.cfg.batch_render_view_width,
              "mode": "rasterizer" if raster else "raytracer",
              "textured": rc.is_textured(r.scene), "shadows": bool(r.cfg.shadows),
              "watertight": bool(r.cfg.watertight), "ssaa": r.cfg.ssaa,
              "ctor_s": ctor_s, "steps_timed": len(step_s), "step_ms_median": step_ms,
              "step_ms_min": min(step_s) * 1e3, "step_ms_max": max(step_s) * 1e3,
              "frames_per_s": n_views / (step_ms / 1e3),
              "prologue_ms": host_ms(lambda: path_inputs(r), TIMED_STEPS),
              "prologue_torch_ops": count_torch_ops(lambda: path_inputs(r)),
              "launches": counts, **extra,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})

    # Per kernel name: (inputs for its timing, launches on the paths).
    timing_kw, launches = {}, dict.fromkeys(kernel_names, 0)
    resident_kw = {}  # per resident terrain path: its last inputs for the other visits

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] += v

    def ssaa_timing(frames):
        """The SSAA filter (ops/ssaa.py: torch ops, not a kernel) on a path's
        supersampled frames: its device time beside its bound (the u8 rgb
        read once and the filtered u8 rgb written once, the depth and
        segmask centre samples being views; per subsample and channel a
        conversion and an add, per output pixel and channel the rounding
        add, the divide and the conversion, against the int32 rate),
        printed as a timing line outside the kernels line."""
        n_sub = frames.depth.numel()
        n_out = n_sub // (SSAA * SSAA)
        nbytes = 4 * (n_sub + n_out)
        ops = 4 * (2 * n_sub + 3 * n_out)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT32_OPS * 1e3
        row = {"name": "ssaa_downsample", "route": "torch ops",
               "source": "madrona_renderer_tpu_torch/ops/ssaa.py",
               "replaces": "madrona_renderer_tpu/ops/ssaa.py:36 (XLA ops, no Pallas kernel)",
               "ms": cuda_ms(lambda: ssaa.downsample_frames(frames, SSAA), KERNEL_REPS),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None, "views": int(n_out // (HEIGHT * WIDTH)),
               "bytes": nbytes, "ops": ops}
        emit({"phase": "timing", "inputs": "textured_4096w_ssaa2", **row})
        return row

    # main: untextured raytrace, 4096 worlds.
    r, step_s, counts, ctor_s, name = drive("main", m.RenderMode.Raytracer,
                                            NUM_WORLDS, False, TIMED_STEPS)
    seg = r.segmask_tensor().to_torch()
    if set(torch.unique(seg).tolist()) != {-1, 0, 1}:
        raise AssertionError(f"main: segmask values {torch.unique(seg).tolist()}")
    timing_kw[name] = full_size_checks("main", r, name)
    timing_kw["pack_rows"] = (r.state, r.scene)
    # The raw sweep on main's one-camera rows, against its plain version and
    # against the prep sweep that main runs (a few ulp of depth apart: the
    # determinant rounds otherwise), and timed: what the prep rows buy.
    kw_raw = dict(timing_kw[name], rows=pack_cuda.pack_rows(r.state, r.scene), geo="raw")
    raw_out = check_render("main_inputs", kw_raw)
    emit({"phase": "prep_vs_raw", "path": "main",
          **compare_outputs(raw_out, rc.render_resident(**timing_kw[name]))})
    extra_timing.append(("render_resident_raw", "main", kw_raw))
    # The raster variant of the untextured scene runs on no path: it is held
    # to its plain version and timed on the main path's inputs.
    kw_raster = path_inputs(r, raster=True, near=r.cfg.raster_near_plane)
    check_render("main_inputs", kw_raster)
    timing_kw[variant(kw_raster)] = kw_raster
    # K10's untextured variants run on no path: held to their plain versions
    # and timed on main's inputs.
    for shadows, raster in itertools.product((False, True), (False, True)):
        kw = path_inputs(r, watertight=True, shadows=shadows, raster=raster,
                         near=r.cfg.raster_near_plane if raster else r.cfg.near_plane)
        check_render("main_inputs", kw)
        timing_kw[variant(kw)] = kw
    time_path("main", r, step_s, counts, ctor_s, {})
    add_launches(counts)
    del r

    # textured_4096w: the 32x32 PNG checkerboard, nearest filtering.
    r, step_s, counts, ctor_s, name = drive("textured_4096w", m.RenderMode.Raytracer,
                                            NUM_WORLDS, True, TIMED_STEPS)
    timing_kw[name] = full_size_checks("textured_4096w", r, name)
    kw_bilinear = path_inputs(r, texture_filter="bilinear")
    check_render("textured_4096w_inputs", kw_bilinear)
    timing_kw[variant(kw_bilinear)] = kw_bilinear
    # The textured variants with shadows run on no path: held to their plain
    # versions and timed on these inputs with shadows on.
    for filt in ("nearest", "bilinear"):
        for raster in (False, True):
            kw = path_inputs(r, texture_filter=filt, shadows=True, raster=raster,
                             near=r.cfg.raster_near_plane if raster else r.cfg.near_plane)
            check_render("textured_4096w_inputs", kw)
            timing_kw[variant(kw)] = kw
    rgb = r.rgb_tensor().to_torch()[..., :3].reshape(-1, 3)
    n_colours = int(torch.unique(rgb, dim=0).shape[0])
    if n_colours < 8:
        raise AssertionError(f"textured_4096w: only {n_colours} colours: no texture shows")
    point_sampled_colours = n_colours
    time_path("textured_4096w", r, step_s, counts, ctor_s, {"distinct_colours": n_colours})
    add_launches(counts)
    del r

    # watertight_4096w: bench.py:314, textured_4096w through K10 (raw rows,
    # the Woop decision).
    r, step_s, counts, ctor_s, name = drive("watertight_4096w", m.RenderMode.Raytracer,
                                            NUM_WORLDS, True, TIMED_STEPS, watertight=True)
    kw = full_size_checks("watertight_4096w", r, name)
    timing_kw[name] = kw
    # Beside K1-raw on the same rows (the ε-slack decision): the frames it
    # gives and its time, timed in the same call.
    kw_eps = dict(kw, geo="raw")
    eps_out = check_render("watertight_4096w_inputs", kw_eps)
    emit({"phase": "wt_vs_eps", "path": "watertight_4096w",
          **compare_outputs(rc.render_resident(**kw), eps_out)})
    extra_timing.append(("render_resident_raw_tex_nearest", "watertight_4096w", kw_eps))
    # K10's other textured variants run on no path: held to their plain
    # versions and timed on these inputs.
    for filt, shadows, raster in itertools.product(("nearest", "bilinear"), (False, True),
                                                   (False, True)):
        kw = path_inputs(r, texture_filter=filt, shadows=shadows, raster=raster,
                         near=r.cfg.raster_near_plane if raster else r.cfg.near_plane)
        check_render("watertight_4096w_inputs", kw)
        timing_kw.setdefault(variant(kw), kw)
    time_path("watertight_4096w", r, step_s, counts, ctor_s, {})
    add_launches(counts)
    del r

    # textured_4096w_ssaa2: bench.py:309, textured_4096w at ssaa=2 (K6 at
    # 128x128, the box filter to 64x64).
    r, step_s, counts, ctor_s, name = drive("textured_4096w_ssaa2", m.RenderMode.Raytracer,
                                            NUM_WORLDS, True, TIMED_STEPS, ssaa=SSAA)
    kw = full_size_checks("textured_4096w_ssaa2", r, name)
    extra_timing.append((name, "textured_4096w_ssaa2", kw))
    # Antialiased edges carry colours the point-sampled render lacks.
    rgb = r.rgb_tensor().to_torch()[..., :3].reshape(-1, 3)
    n_colours = int(torch.unique(rgb, dim=0).shape[0])
    if n_colours <= point_sampled_colours:
        raise AssertionError(f"textured_4096w_ssaa2: {n_colours} colours, point-sampled "
                             f"{point_sampled_colours}: no edge is blended")
    # The filter (torch ops) on these frames, timed and bounded.
    frames = rc.frames_from_core(r.state, *rc.render_resident(**kw))
    ssaa_row = ssaa_timing(frames)
    time_path("textured_4096w_ssaa2", r, step_s, counts, ctor_s,
              {"render_height": HEIGHT * SSAA, "render_width": WIDTH * SSAA,
               "distinct_colours": n_colours,
               "point_sampled_colours": point_sampled_colours,
               "filter_ms": ssaa_row["ms"]})
    add_launches(counts)
    del r, frames

    # raster_256w_png: BASELINE config 2 with the texture as PNG.
    r, step_s, counts, ctor_s, name = drive("raster_256w_png", m.RenderMode.Rasterizer,
                                            RASTER_WORLDS, True, RASTER_TIMED_STEPS)
    if tuple(r.depth_tensor().to_torch().shape) != (RASTER_WORLDS, HEIGHT, WIDTH, 1):
        raise AssertionError("raster_256w_png: depth export shape")
    try:
        r.segmask_tensor()
    except RuntimeError:
        pass
    else:
        raise AssertionError("raster_256w_png: segmask_tensor() did not raise")
    timing_kw[name] = full_size_checks("raster_256w_png", r, name)
    kw_bilinear = path_inputs(r, texture_filter="bilinear")
    check_render("raster_256w_png_inputs", kw_bilinear)
    timing_kw[variant(kw_bilinear)] = kw_bilinear
    # K2+K6 on 64 of these worlds (fewer than the teams take by default),
    # nearest and bilinear, at every forced plan.
    for kw in (timing_kw[name], kw_bilinear):
        check_render("raster_64w_png_inputs", dict(
            kw, rows=kw["rows"][:SMALL_WORLDS], clusters=kw["clusters"][:SMALL_WORLDS],
            cams=kw["cams"][:SMALL_WORLDS]))
    time_path("raster_256w_png", r, step_s, counts, ctor_s, {})
    add_launches(counts)
    del r

    # multicam_1024w4c: bench.py's multi-camera row, 1024 worlds x 4 views.
    r, step_s, counts, ctor_s, name = drive(
        "multicam_1024w4c", m.RenderMode.Raytracer, MULTICAM_WORLDS, False, TIMED_STEPS,
        num_cams=MULTICAM_CAMS)
    n_views = MULTICAM_WORLDS * MULTICAM_CAMS
    if tuple(r.rgb_tensor().to_torch().shape) != (n_views, HEIGHT, WIDTH, 4):
        raise AssertionError("multicam_1024w4c: rgb export shape")
    views = r.depth_tensor().to_torch()[:MULTICAM_CAMS]
    if any(torch.equal(views[0], views[c]) for c in range(1, MULTICAM_CAMS)):
        raise AssertionError("multicam_1024w4c: two cameras of world 0 render the same view")
    timing_kw[name] = full_size_checks("multicam_1024w4c", r, name)
    extra_timing.append(("pack_rows_raw", "multicam_1024w4c", (r.state, r.scene)))
    kw_raster = path_inputs(r, raster=True, near=r.cfg.raster_near_plane)
    check_render("multicam_1024w4c_inputs", kw_raster)
    timing_kw[variant(kw_raster)] = kw_raster
    time_path("multicam_1024w4c", r, step_s, counts, ctor_s, {})
    add_launches(counts)
    del r
    # The textured raw variants run on no path: held to their plain versions
    # and timed on the textured multicam scene at the same size.
    parts = demo_scene(MULTICAM_WORLDS, True, scenes, cfg_mod, textured=True,
                       num_cams=MULTICAM_CAMS)
    geo, mats, textures, insts, cams, worlds = parts
    tex_scene = bake_scene(load_render_assets(geo, [], mats, textures), dev)
    tex_state = init_state(insts, cams, worlds, dev)
    for filt in ("nearest", "bilinear"):
        for raster in (False, True):
            kw = rc.pack_inputs(tex_state, tex_scene, height=HEIGHT, width=WIDTH,
                                raster=raster, near=0.001 if raster else 0.1,
                                texture_filter=filt)
            check_render("multicam_1024w4c_tex32", kw)
            timing_kw[variant(kw)] = kw

    # shadows_4096w: main with one shadow ray per pixel and light.
    r, step_s, counts, ctor_s, name = drive("shadows_4096w", m.RenderMode.Raytracer,
                                            NUM_WORLDS, False, TIMED_STEPS, shadows=True)
    kw = full_size_checks("shadows_4096w", r, name)
    timing_kw[name] = kw
    # K13's raw layout runs on both new paths; it is timed on the larger.
    timing_kw["pack_rows_raw"] = (r.state, r.scene)
    # Against the unshadowed render of the same rows (the raw variant): the
    # shadow darkens some pixels and changes nothing but rgb.
    lit = rc.render_resident(**dict(kw, geo="raw"))
    shadowed = (r.depth_tensor().to_torch(), r.segmask_tensor().to_torch(),
                r.rgb_tensor().to_torch().contiguous().view(torch.int32).squeeze(-1))
    if not (torch.equal(lit[0], shadowed[0]) and torch.equal(lit[1], shadowed[1])):
        raise AssertionError("shadows_4096w: depth or segmask differ from the unshadowed render")
    darker = lit[2].view(torch.uint8).int() - shadowed[2].view(torch.uint8).int()
    if not bool((darker > 0).any()) or bool((darker < 0).any()):
        raise AssertionError("shadows_4096w: shadows must darken some pixels and brighten none")
    shadowed_px = int((darker > 0).any(-1).sum())
    kw_raster = path_inputs(r, raster=True, near=r.cfg.raster_near_plane)
    check_render("shadows_4096w_inputs", kw_raster)
    timing_kw[variant(kw_raster)] = kw_raster
    # The 9-output route's shadow epilogue (compute_lit, torch ops) on these
    # full-size inputs: K1's 9-output mode on the same raw rows, then
    # frames_from_core with shadows; its rgb against the path's K8 render
    # (the same shadow rays, traced otherwise: a report).
    kw9 = dict(kw, geo="raw", texture="nine")
    outs9 = check_render("shadows_4096w_inputs", kw9)
    timing_kw.setdefault(variant(kw9), kw9)

    def shadow_epilogue():
        return rc.frames_from_core(r.state, *outs9, scene=r.scene, far=r.cfg.far_plane,
                                   fov_y_degrees=r.cfg.fov_y_degrees, shadows=True)

    f9 = shadow_epilogue()
    n_pix, S9 = int(outs9[0].numel()), int(kw["rows"].shape[2])
    lights = int(r.scene.light_dir.shape[0])
    ep_bytes = n_pix * (36 + 4) + NUM_WORLDS * S9 * 4 * 40
    ep_ops = (n_pix * lights * S9 * EPILOGUE_OPS_PER_TEST
              + NUM_WORLDS * lights * S9 * EPILOGUE_OPS_PER_TRIANGLE)
    ep_bound, ep_by = roofline(ep_bytes, ep_ops)
    emit({"phase": "timing", "inputs": "shadows_4096w", "name": "shadow_epilogue",
          "route": "torch ops", "source": "madrona_renderer_tpu_torch/ops/raytrace_ref.py",
          "replaces": "madrona_renderer_tpu/ops/raytrace_ref.py:422 (XLA ops, no Pallas "
                      "kernel)",
          "ms": cuda_ms(shadow_epilogue, 3), "bound_ms": ep_bound, "bound_by": ep_by,
          "library_ms": None, "views": NUM_WORLDS, "bytes": ep_bytes, "ops": ep_ops,
          "rgb_max_lsb_vs_k8": int((f9.rgb.reshape(shadowed[2].shape + (4,)).int()
                                    - shadowed[2].view(torch.uint8).reshape(
                                        shadowed[2].shape + (4,)).int()).abs().max())})
    del outs9, f9
    time_path("shadows_4096w", r, step_s, counts, ctor_s,
              {"shadowed_pixels": shadowed_px})
    add_launches(counts)
    del r

    # textured256_4096w: bench.py's paged-texture row, a 256x256 checker
    # that bakes mip chains (K7), nearest filtering.
    paged_cfg = paged_tex_config(NUM_WORLDS, scenes, cfg_mod)
    r, step_s, counts, ctor_s, name = drive("textured256_4096w", m.RenderMode.Raytracer,
                                            NUM_WORLDS, True, TIMED_STEPS, cfg=paged_cfg)
    if not rc.has_mips(r.scene):
        raise AssertionError("textured256_4096w: mipmaps='auto' baked no mip chains")
    bake = {"levels": int(r.scene.tex_mip_offset.shape[1]), "fb_rows": r.scene.fb_rows,
            "pool_texels": int(r.scene.tex_data.shape[0]),
            "fit_level": r.scene.tex_fit_level.tolist()}
    emit({"phase": "textured256_bake", **bake})
    kw = full_size_checks("textured256_4096w", r, name)
    timing_kw[handoff_name(kw)] = kw
    timing_kw["shade_mip_nearest"] = kw
    k_h = check_k7("textured256_4096w", kw)
    stats = level_stats("textured256_4096w", kw, k_h)
    # Every K7 variant on the path's inputs, against its plain version and
    # timed (both launches); the raw rows for the raw sweep without shadows.
    raw_rows = pack_cuda.pack_rows(r.state, r.scene)
    k7_timing = []
    for geo in rc._GEO_CODES:
        for raster in (False, True):
            for filt in MIP_FILTERS:
                kw = path_inputs(r, texture_filter=filt, raster=raster,
                                 shadows=geo.endswith("_shadows"),
                                 watertight=geo.startswith("raw_wt"),
                                 near=r.cfg.raster_near_plane if raster else r.cfg.near_plane)
                if geo == "raw":
                    kw = dict(kw, rows=raw_rows, geo="raw")
                check_render("textured256_4096w_inputs", kw)
                k7_timing.append(kw)
                timing_kw.setdefault(handoff_name(kw), kw)
                if geo == "prep" and not raster:
                    timing_kw[f"shade_mip_{filt}"] = kw
                    timing_kw[rc.mip_name(filt)] = kw
    # The minified cube samples a coarse level of the chain.
    if not any(stats["pixels_per_level"][1:]):
        raise AssertionError(f"textured256_4096w: every hit sampled level 0: {stats}")
    rgb = r.rgb_tensor().to_torch()[..., :3].reshape(-1, 3)
    n_colours = int(torch.unique(rgb, dim=0).shape[0])
    time_path("textured256_4096w", r, step_s, counts, ctor_s,
              {"distinct_colours": n_colours, **bake, **stats})
    add_launches(counts)
    del r

    def device_share(r, step_s):
        dev_ms = device_ms(r.step)
        med = statistics.median(step_s) * 1e3
        return {"step_device_ms": dev_ms,
                "idle_share": None if dev_ms is None else max(0.0, 1.0 - dev_ms / med)}

    # bigmesh_512w: bench.py's big-mesh row, past the resident budget: the
    # streamed route (K3 + K5), with what the card makes of its entry (a
    # streamed_occupancy line) and the step's device time.
    r, step_s, counts, ctor_s, name = drive(
        "bigmesh_512w", m.RenderMode.Raytracer, BIGMESH_WORLDS, False, TIMED_STEPS,
        cfg=scenes.bigmesh_config(BIGMESH_WORLDS, WIDTH, HEIGHT))
    kw = full_size_checks("bigmesh_512w", r, name)
    if not streamed(kw):
        raise AssertionError("bigmesh_512w: the terrain did not take the streamed route")
    timing_kw[name] = kw
    # The walk this run's data makes, replayed: the frames of the exports,
    # and a fraction of the index-order sweep's triangle tests.
    walk = walks(kw)
    blocks = BIGMESH_WORLDS * (HEIGHT // 16) * (WIDTH // 16)
    S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
    if not (torch.equal(walk["depth"], r.depth_tensor().to_torch())
            and torch.equal(walk["segmask"], r.segmask_tensor().to_torch())):
        raise AssertionError("bigmesh_512w: the replayed walk differs from the exports")
    if not 0 < walk["triangle_visits"] < blocks * S:
        raise AssertionError(f"bigmesh_512w: {walk['triangle_visits']} triangle tests")
    bake = {"tris_per_world": S, "clusters_per_world": CC,
            "valid_clusters_per_world": int((kw["clusters"][0, 6] > 0).sum()),
            "triangle_share_tested": walk["triangle_visits"] / (blocks * S),
            **{k: v for k, v in walk.items() if k not in ("depth", "segmask")},
            **device_share(r, step_s)}
    emit({"phase": "streamed_occupancy", "case": "bigmesh_512w", **rc.streamed_occupancy(kw)})
    time_path("bigmesh_512w", r, step_s, counts, ctor_s, bake)
    add_launches(counts)
    del r
    cold_step_s = step_s

    def work_of(walk):
        return {k: walk[k] for k in ("gated", "slab_tests", "cluster_visits",
                                     "triangle_visits")}

    # bigmesh_512w_warm: bench.py:322-324 (opt-in; rollout :188-215),
    # bigmesh_512w's scene with warmstart=True: each step seeded (K9 on the
    # streamed ordered route) by the previous frame's depth and repaired where
    # it missed. Every step's frames bitwise a cold render's of the same
    # state; the A/B is bigmesh_512w's cold steps above, in this call.
    record = []
    r, step_s, counts, ctor_s, name = drive(
        "bigmesh_512w_warm", m.RenderMode.Raytracer, BIGMESH_WORLDS, False, TIMED_STEPS,
        cfg=scenes.bigmesh_config(BIGMESH_WORLDS, WIDTH, HEIGHT), record=record,
        warmstart=True)
    for i, (state, depth, seg, rgb) in enumerate(record):
        cold = rc.render_resident(**rc.pack_inputs(state, r.scene, height=HEIGHT, width=WIDTH))
        warm = (depth, seg, rgb.contiguous().view(torch.int32).squeeze(-1))
        if not all(torch.equal(c, w) for c, w in zip(cold, warm)):
            raise AssertionError(f"bigmesh_512w_warm step {i}: warm frames differ from cold")
    emit({"phase": "warm_vs_cold", "path": "bigmesh_512w_warm", "steps": len(record),
          "bitwise": True})
    # The last step's main pass: its seed from the step before, and its walk
    # against the cold walk of the same state.
    prev = record[-2][1]
    far = torch.tensor(r.cfg.far_plane, dtype=torch.float32, device=dev)
    seed = torch.where(prev > 0, torch.minimum(prev * 1.01, far), far).contiguous()
    # K9 on these inputs against the seeded plain version, bitwise.
    kw = path_inputs(r)
    seeded_kw = dict(kw, seed=seed)
    check_render("bigmesh_512w_warm", seeded_kw, keep=True)
    emit({"phase": "streamed_occupancy", "case": "bigmesh_512w_warm",
          **rc.streamed_occupancy(seeded_kw)})
    warm_walk, last_cold_walk = walks(seeded_kw), walks(kw)
    timing_kw[name] = seeded_kw
    steps = 1 + WARMUP_STEPS + TIMED_STEPS
    time_path("bigmesh_512w_warm", r, step_s, counts, ctor_s, {
        "route": name, "repair_passes": counts[name] - steps,
        "cold_step_ms_median": statistics.median(cold_step_s) * 1e3,
        "cold_step_ms_min": min(cold_step_s) * 1e3, "cold_step_ms_max": max(cold_step_s) * 1e3,
        "step_device_ms": device_ms(r.step),
        "walk_seeded": work_of(warm_walk), "walk_cold": work_of(last_cold_walk)})
    add_launches(counts)
    del r, record

    # The resident terrain paths: bench.py's big-mesh scene at a 27 grid (S
    # = 2,928 slots: resident, 366 clusters of 8): 4096 worlds at 64²
    # ("auto" orders: K3 on resident rows) and 1024 at 128² ("auto" bins: K4
    # on resident rows), world 0's cube moved each step. Every visit (K1's
    # index order included) on the last step's inputs bitwise equal to the
    # plain version and to the exports; the A/B: each timed step's inputs
    # through the three visits at the kernel entry.
    for path, n_worlds, res, visit in RESIDENT_PATHS:
        record = []
        r, step_s, counts, ctor_s, name = drive(
            path, m.RenderMode.Raytracer, n_worlds, False, TIMED_STEPS, moved=1, size=res,
            cfg=scenes.bigmesh_config(n_worlds, res, res, grid=RESIDENT_GRID), record=record)
        kw = path_inputs(r)
        if route(kw) != rc.Route(False, visit):
            raise AssertionError(f"{path}: took {route(kw)}, not the resident {visit} visit")
        visits = resident_visits(kw, r.state, r.scene)
        exported = (record[-1][1], record[-1][2],
                    record[-1][3].contiguous().view(torch.int32).squeeze(-1))
        for v, vkw in zip(("index", "ordered", "binned"), visits):
            out = check_render(path, vkw, keep=True)
            if not all(torch.equal(o, e) for o, e in zip(out, exported)):
                raise AssertionError(f"{path}: the {v} visit differs from the exports")
        emit({"phase": "visits_vs_k1", "case": path, "visits": 3, "bitwise": True})
        emit({"phase": "resident_occupancy", "case": path, **rc.resident_occupancy(kw)})
        if not torch.isfinite(exported[0]).all() or not bool((exported[0] > 0).any()):
            raise AssertionError(f"{path}: depth not finite or empty")
        check_pack(path, r.state, r.scene, r.state.camera_pos[:, 0, :])
        timing_kw[name] = next(vkw for vkw in visits if route(vkw) == route(kw))
        ab = {"index": [], "ordered": [], "binned": []}
        for state, *_ in record[WARMUP_STEPS:]:
            vkws = resident_visits(rc.pack_inputs(state, r.scene, height=res, width=res), state,
                                   r.scene)
            for v, vkw in zip(ab, vkws):
                ab[v].append(cuda_ms(lambda vkw=vkw: rc.render_resident(**vkw), 1))
            del vkws
        walk_work = {v: work_of(walks(vkw)) for v, vkw in zip(ab, visits)}
        resident_kw[path] = [vkw for vkw in visits if route(vkw) != route(kw)]
        extra = {"route": name, "tris_per_world": int(kw["rows"].shape[2]),
                 "clusters_per_world": int(kw["clusters"].shape[2]),
                 "bin_tile": visits[2]["bin_tile"],
                 "step_device_ms": device_ms(r.step),
                 **{f"ab_{v}_kernel_ms_median": statistics.median(t) for v, t in ab.items()},
                 **{f"walk_{v}": w for v, w in walk_work.items()}}
        time_path(path, r, step_s, counts, ctor_s, extra)
        add_launches(counts)
        del r, record, kw, visits
        torch.cuda.empty_cache()

    # The binned terrain paths: tools/tpu_binned_bench.py's scene (32 worlds
    # of the 224-grid terrain, S = 100,352, 3,136 clusters a world) at 128²
    # and 256² with accel="auto", and bench.py:505-546's health anchor at
    # 512² with accel="binned", each step turning every terrain in place as
    # the tool's rollout does; then the same steps with accel="clusters"
    # (K5), the tool's A/B.
    from madrona_renderer_tpu_torch.ops.quat import quat_multiply, quat_normalize

    def drive_tool(path, cfg, res, accel, half=PAGED_HALF_ANGLE, record=None, **opts):
        """One path through MadronaRenderer in the tools' loop: every
        instance turned by dq (half-angle ``half``) about z in place through
        the exported rotation tensor before each step, every view of world 0
        changing each step (``opts``: further MadronaRenderer options). With
        ``record`` (a list), each timed step's state is appended to it.
        Returns the renderer, the step times, the launch counts, the
        constructor's time and the variant's name."""
        reset_counts()
        t0 = time.perf_counter()
        r = m.MadronaRenderer(0, cfg.num_worlds, cfg.render_mode, res, res, accel=accel,
                              **opts, **scenes.renderer_kwargs(cfg))
        torch.cuda.synchronize()
        ctor_s = time.perf_counter() - t0
        rot = r.instance_rotation_tensor().to_torch()
        h = torch.tensor(half, dtype=torch.float32)
        dq = torch.stack([torch.cos(h), 0 * h, 0 * h, torch.sin(h)])  # the host mirror's
        C = r.state.max_cameras
        step_s = []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            depth0 = r.depth_tensor().to_torch()[:C].clone()
            rot.copy_(quat_normalize(quat_multiply(dq, rot)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.step()
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                step_s.append(time.perf_counter() - t0)
                if record is not None:
                    record.append(r.state)
            if bool((depth0 == r.depth_tensor().to_torch()[:C]).flatten(1).all(1).any()):
                raise AssertionError(f"{path} step {i}: a view of the turned world 0 did "
                                     "not change")
        counts = launch_counts()
        steps = 1 + WARMUP_STEPS + TIMED_STEPS
        kw = path_inputs(r)
        name = variant(kw)
        expected = dict.fromkeys(kernel_names, 0)
        expected.update({part: steps for part in name.split("+")},
                        **{pack_cuda.LAYOUTS[kw["geo"] != "prep" if "geo" in kw else 1]: steps})
        if counts != expected:
            raise AssertionError(f"{path}: launches {counts} in {steps} steps, "
                                 f"expected {expected}")
        return r, step_s, counts, ctor_s, name

    def binning(r, res, bin_tile):
        """The binned prologue's own work on the renderer's state: the bins
        (order, membership, compaction), the 8-row spans, and the row sort
        with the row gather; their device times (CUDA events back to back,
        and the profiler's kernel time) and bytes."""
        state, scene = r.state, r.scene
        eff_fov = torch.where(state.camera_fov > 0, state.camera_fov, r.cfg.fov_y_degrees)
        cl_lo, cl_hi, cl_valid, _ = rc.world_clusters(state, scene)
        views, CC = TERRAIN_WORLDS, int(cl_valid.shape[1])
        tx = -(-res // bin_tile)

        def bins():
            order = rc.camera_cluster_order(cl_lo, cl_hi, cl_valid, state.camera_pos)
            rc.camera_cluster_rowspans(cl_lo, cl_hi, cl_valid, state, eff_fov, res, g_rows=8)
            return rc.band_cluster_bins(cl_lo, cl_hi, cl_valid, state, eff_fov, res, res,
                                        tx * tx, tx, bin_tile, bin_tile, order=order)

        rows = pack_cuda.pack_rows(state, scene, state.camera_pos[:, 0, :])

        def row_sort():
            from madrona_renderer_tpu_torch.ops.raytrace_ref import planar_soup_parts
            p = planar_soup_parts(state, scene, what="geo")
            planes = [tuple(x.reshape(views, -1) for x in p[k]) for k in ("v0", "e1", "e2")]
            perm, lo, hi = rc.cluster_row_sort(*planes, p["valid"].reshape(views, -1), state,
                                               eff_fov, res, rows.shape[2] // CC, 8,
                                               -(-res // 8))
            rc.row_sorted(rows, perm)
            return torch.stack([lo, hi], dim=-1)

        b, rg = bins(), row_sort()
        return {"bin_tile": bin_tile, "bins_bytes": b.numel() * 4, "ranges_bytes": rg.numel() * 4,
                "bins_ms": cuda_ms(bins, 5), "bins_device_ms": device_ms(bins),
                "row_sort_ms": cuda_ms(row_sort, 5), "row_sort_device_ms": device_ms(row_sort)}

    terrain_timing = []
    terrain_steps = {}  # each terrain path's step times (K11's path takes 512²'s as its A/B)
    for path, res, accel in TERRAIN_PATHS:
        r, step_s, counts, ctor_s, name = drive_tool(
            path, scenes.binned_terrain_config(TERRAIN_WORLDS, res, res), res, accel)
        if name != "render_binned":
            raise AssertionError(f"{path}: the terrain took {name}, not the binned route")
        add_launches(counts)
        kw = path_inputs(r)
        k4 = rc.render_resident(**kw)
        exported = (r.depth_tensor().to_torch(), r.segmask_tensor().to_torch(),
                    r.rgb_tensor().to_torch().contiguous().view(torch.int32).squeeze(-1))
        if not all(torch.equal(k, e) for k, e in zip(k4, exported)):
            raise AssertionError(f"{path}: K4 on the last step's inputs differs from the exports")
        if not torch.isfinite(exported[0]).all() or not bool((exported[0] > 0).any()):
            raise AssertionError(f"{path}: depth not finite or empty")
        # K4 against K5 on the same state, bitwise; at 128² against the
        # plain version too (the index-order sweep: 20-70 s at 256² and 512²).
        kw5 = path_inputs(r, accel="clusters")
        k5 = rc.render_resident(**kw5)
        same = all(torch.equal(x, y) for x, y in zip(k4, k5))
        emit({"phase": "k4_vs_k5", "case": path, "kernel": name, "bitwise": same})
        emit({"phase": "streamed_occupancy", "case": f"{path} (accel clusters)",
              **rc.streamed_occupancy(kw5)})
        emit({"phase": "binned_occupancy", "case": path, **rc.binned_occupancy(kw)})
        if not same:
            raise AssertionError(f"{path}: K4 differs from K5 at full size")
        check_pack(path, r.state, r.scene, r.state.camera_pos[:, 0, :])
        if res == 128:
            check_render(path, kw)  # with the forced plans and the parent design
        else:
            check_plans(path, kw, k4)
        walk = walks(kw)
        if not (torch.equal(walk["depth"], exported[0]) and torch.equal(walk["segmask"], exported[1])):
            raise AssertionError(f"{path}: the replayed binned walk differs from the exports")
        cost = binning(r, res, kw["bin_tile"])
        step_dev = device_ms(r.step)
        work = {k: v for k, v in walk.items() if k not in ("depth", "segmask")}
        extra = {"accel": accel, "route": name, "tris_per_world": int(kw["rows"].shape[2]),
                 "clusters_per_world": int(kw["clusters"].shape[2]), **cost,
                 "step_device_ms": step_dev,
                 "k4_ms": graph_ms(lambda: rc.render_resident(**kw), KERNEL_REPS),
                 "k5_ms": graph_ms(lambda: rc.render_resident(**kw5), KERNEL_REPS // 10),
                 **work}
        if res == 128:
            timing_kw[name] = kw
        terrain_timing.append((path, res, kw, kw5))
        # The A/B: the same steps through the ordered walk (K5).
        r5, step5, counts5, _, name5 = drive_tool(
            path + "_clusters", scenes.binned_terrain_config(TERRAIN_WORLDS, res, res), res,
            "clusters")
        add_launches(counts5)
        extra.update(clusters_route=name5,
                     clusters_step_ms_median=statistics.median(step5) * 1e3,
                     clusters_step_ms_min=min(step5) * 1e3,
                     clusters_step_ms_max=max(step5) * 1e3)
        del r5
        terrain_steps[path] = step_s
        time_path(path, r, step_s, counts, ctor_s, extra)
        del r, k4, k5
        torch.cuda.empty_cache()


    # ---- the ninth slice's paths: K12 (accel="mxu"), K1-none (accel=
    # "none") and the 9-output route with its epilogue -------------------- #
    def run_kernel(kw):
        return (rc.render_batched if is_batched(kw) else rc.render_resident)(**kw)

    def frames_of(r, outs):
        """The route's epilogue on the kernel's outputs (frames_from_core)."""
        return rc.frames_from_core(r.state, *outs, scene=r.scene, far=r.cfg.far_plane,
                                   fov_y_degrees=r.cfg.fov_y_degrees,
                                   texture_filter=r.cfg.texture_filter,
                                   shadows=bool(r.cfg.shadows))

    def flat(f, h, w):
        return (f.rgb.reshape(-1, h, w, 4), f.depth.reshape(-1, h, w),
                f.segmask.reshape(-1, h, w))

    def core_checks(path, r, res, memo=None):
        """The path's kernel on the last step's inputs, through the epilogue,
        reproduces the exported frames; K13 and the kernel equal their plain
        versions at full size, bitwise (``memo``: the plain outputs' key for
        another visit's check on the same inputs)."""
        kw = path_inputs(r)
        outs = run_kernel(kw)
        exported = (r.rgb_tensor().to_torch(), r.depth_tensor().to_torch(),
                    r.segmask_tensor().to_torch())
        if not all(torch.equal(a, b) for a, b in zip(flat(frames_of(r, outs), res, res),
                                                      exported)):
            raise AssertionError(f"{path}: the kernel and the epilogue on the last step's "
                                 "inputs differ from the exports")
        if not torch.isfinite(exported[1]).all() or not bool((exported[1] > 0).any()):
            raise AssertionError(f"{path}: depth not finite or empty")
        prep = not is_batched(kw) and kw["geo"] == "prep"
        check_pack(path, r.state, r.scene, r.state.camera_pos[:, 0, :] if prep else None)
        check_render(path, kw, keep=True, memo=memo)
        return kw, outs

    def ab_of(prefix, step_s):
        return {f"{prefix}_step_ms_median": statistics.median(step_s) * 1e3,
                f"{prefix}_step_ms_min": min(step_s) * 1e3,
                f"{prefix}_step_ms_max": max(step_s) * 1e3}

    # mxu_4096w, mxu_4096w_128: tools/tpu_accel_compare.py's defaults (the
    # demo scene, bench.build(4096, "rt", res, res)) with accel="mxu" (K12),
    # and the same steps through "auto" (K1) beside them; each timed step's
    # inputs through both kernels at the kernel entry.
    k1_128 = {}  # K1 at 128x128: the last step's inputs, the "auto" steps' launches
    for res in MXU_RESOLUTIONS:
        path = "mxu_4096w" if res == HEIGHT else f"mxu_4096w_{res}"
        cfg = scenes.demo_config(NUM_WORLDS, m.RenderMode.Raytracer, res, res)
        record = []
        r, step_s, counts, ctor_s, name = drive_tool(path, cfg, res, "mxu",
                                                     half=TOOL_HALF_ANGLE, record=record)
        if name != "render_batched":
            raise AssertionError(f"{path}: took {name}, not K12")
        kw, outs = core_checks(path, r, res)
        k1_kw = path_inputs(r, accel="auto")
        if res == HEIGHT:
            k1_out = rc.render_resident(**k1_kw)
            timing_kw[name] = kw
            # K12 against K1 on the same state: different arithmetic (the
            # factorisation against the pack-time prep rows), so a report,
            # not a check.
            f12, f1 = frames_of(r, outs), rc.frames_from_core(r.state, *k1_out)
            d12, d1 = f12.depth, f1.depth
            rel = ((d12 - d1).abs() / torch.clamp_min(d1.abs(), 1e-30))[(d1 > 0) & (d12 > 0)]
            emit({"phase": "mxu_vs_k1", "path": path,
                  "rgb_max_lsb": int((f12.rgb.int() - f1.rgb.int()).abs().max()),
                  "depth_max_rel": float(rel.max()) if rel.numel() else 0.0,
                  "seg_mismatches": int((f12.segmask != f1.segmask).sum()),
                  "pixels": int(d1.numel())})
        else:
            # K1 at 128x128 (the "auto" steps' kernel): against its plain
            # version, and at every forced plan (check_index_plans); its
            # timing row is the kernels line's 128x128 K1 row.
            k1_out = check_render(path + "_auto", k1_kw, keep=True)
            k1_128["kw"] = k1_kw
            extra_timing.append((name, path, kw))
        ab = {"k12": [], "k12_parent": [], "k1": []}
        for state in record:
            kb = rc.pack_inputs(state, r.scene, height=res, width=res, accel="mxu")
            k1 = rc.pack_inputs(state, r.scene, height=res, width=res)
            ab["k12"].append(cuda_ms(lambda kb=kb: rc.render_batched(**kb), 1))
            ab["k12_parent"].append(cuda_ms(lambda kb=kb: on_plan(
                lambda: rc.render_batched(**kb), kb, 0), 1))
            ab["k1"].append(cuda_ms(lambda k1=k1: rc.render_resident(**k1), 1))
        extra = {"accel": "mxu", "route": name, **device_share(r, step_s),
                 "epilogue_ms": cuda_ms(lambda: frames_of(r, outs), 5),
                 **{f"ab_{k}_kernel_ms_median": statistics.median(v) for k, v in ab.items()}}
        add_launches(counts)
        del record, outs, k1_out
        r1, step1, counts1, _, name1 = drive_tool(path + "_auto", cfg, res, "auto",
                                                  half=TOOL_HALF_ANGLE)
        add_launches(counts1)
        if res != HEIGHT:
            k1_128["launches"] = counts1[name1]
        extra.update(auto_route=name1, **ab_of("auto", step1))
        del r1
        time_path(path, r, step_s, counts, ctor_s, extra)
        del r
        torch.cuda.empty_cache()

    # none_4096w: tools/tpu_opt_probe.py:69-72 ("brute (accel=none)", 4096 x
    # 64²): K1-none, its frames bitwise K1's ("clusters") on every timed
    # step's state, and the same steps through "clusters" beside them.
    cfg = scenes.demo_config(NUM_WORLDS, m.RenderMode.Raytracer, WIDTH, HEIGHT)
    record = []
    r, step_s, counts, ctor_s, name = drive_tool("none_4096w", cfg, HEIGHT, "none",
                                                 half=TOOL_HALF_ANGLE, record=record)
    if name != "render_none":
        raise AssertionError(f"none_4096w: took {name}, not K1-none")
    kw, _ = core_checks("none_4096w", r, HEIGHT)
    timing_kw[name] = kw
    ab = {"none": [], "clusters": []}
    for state in record:
        kn = rc.pack_inputs(state, r.scene, height=HEIGHT, width=WIDTH, accel="none")
        kc = rc.pack_inputs(state, r.scene, height=HEIGHT, width=WIDTH, accel="clusters")
        if not all(torch.equal(a, b) for a, b in zip(rc.render_resident(**kn),
                                                     rc.render_resident(**kc))):
            raise AssertionError("none_4096w: K1-none's frames differ from K1's")
        ab["none"].append(cuda_ms(lambda kn=kn: rc.render_resident(**kn), 1))
        ab["clusters"].append(cuda_ms(lambda kc=kc: rc.render_resident(**kc), 1))
    emit({"phase": "none_vs_k1", "path": "none_4096w", "steps": len(record), "bitwise": True})
    extra = {"accel": "none", "route": name, **device_share(r, step_s),
             **{f"ab_{k}_kernel_ms_median": statistics.median(v) for k, v in ab.items()}}
    add_launches(counts)
    del record
    r1, step1, counts1, _, name1 = drive_tool("none_4096w_clusters", cfg, HEIGHT, "clusters",
                                              half=TOOL_HALF_ANGLE)
    add_launches(counts1)
    extra.update(clusters_route=name1, **ab_of("clusters", step1))
    del r1
    time_path("none_4096w", r, step_s, counts, ctor_s, extra)
    del r

    # textured_4096w_mxu: bench.py:291's scene (the 32x32 checker on the
    # cube) with accel="mxu": K12's 9-output mode and the planar epilogue.
    cfg = scenes.demo_config(NUM_WORLDS, m.RenderMode.Raytracer, WIDTH, HEIGHT, dynamic=True,
                             textured=True, tex_size=TEX_SIZE)
    r, step_s, counts, ctor_s, name = drive_tool("textured_4096w_mxu", cfg, HEIGHT, "mxu",
                                                 half=TOOL_HALF_ANGLE)
    if name != "render_batched_nine":
        raise AssertionError(f"textured_4096w_mxu: took {name}, not K12's 9-output mode")
    kw, outs = core_checks("textured_4096w_mxu", r, HEIGHT)
    timing_kw[name] = kw
    n_colours = int(torch.unique(r.rgb_tensor().to_torch()[..., :3].reshape(-1, 3),
                                 dim=0).shape[0])
    if n_colours < 8:
        raise AssertionError(f"textured_4096w_mxu: only {n_colours} colours: no texture shows")
    time_path("textured_4096w_mxu", r, step_s, counts, ctor_s, {
        "accel": "mxu", "route": name, "distinct_colours": n_colours,
        **device_share(r, step_s), "epilogue_ms": cuda_ms(lambda: frames_of(r, outs), 5)})
    add_launches(counts)
    del r, outs

    # tex256_cliff_4096w: tools/tpu_paged_tex_bench.py:167 (tex256_cliff_r2:
    # the 256x256 texture baked with mipmaps=False, 4096 x 64²): K1's
    # 9-output mode and the planar epilogue; beside it the tool's
    # tex256_paged row (the same scene with mips: K7) in the same loop.
    cfg = paged_tex_config(NUM_WORLDS, scenes, cfg_mod)
    r, step_s, counts, ctor_s, name = drive_tool("tex256_cliff_4096w", cfg, HEIGHT, "auto",
                                                 mipmaps=False)
    if name != "render_resident_nine" or rc.has_mips(r.scene):
        raise AssertionError(f"tex256_cliff_4096w: took {name}, not K1's 9-output mode")
    kw, outs = core_checks("tex256_cliff_4096w", r, HEIGHT)
    timing_kw[name] = kw
    extra = {"route": name, "pool_texels": int(r.scene.tex_data.shape[0]),
             **device_share(r, step_s), "epilogue_ms": cuda_ms(lambda: frames_of(r, outs), 5)}
    add_launches(counts)
    del outs
    r7, step7, counts7, _, name7 = drive_tool("tex256_cliff_4096w_mips", cfg, HEIGHT, "auto")
    add_launches(counts7)
    extra.update(mips_route=name7, **ab_of("mips", step7))
    del r7
    time_path("tex256_cliff_4096w", r, step_s, counts, ctor_s, extra)
    del r
    torch.cuda.empty_cache()

    # ---- K11's paths (deferred_mxu) ------------------------------------ #
    def same_frames(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def exports(r):
        return (r.depth_tensor().to_torch(), r.segmask_tensor().to_torch(),
                r.rgb_tensor().to_torch().contiguous().view(torch.int32).squeeze(-1))

    # dmxu_32w_512: tools/tpu_dmxu_bench.py's defaults (32 worlds of the
    # 224-grid terrain at 512², accel="binned", every instance turned by dq
    # of half-angle 0.01 about z each step) with deferred_mxu=True: K11 on
    # the binned walk with its row gate (the TPU tiling has 4 tiles across).
    # Each timed step's inputs through K4 too (dmxu_vs_k4, bitwise, and both
    # timed at the kernel entry), the rowskip=False launch on the last
    # step's inputs, the tool's 128² correctness check (no row gate there);
    # the same steps through K4 are terrain_32w_512's, in this call.
    path = f"dmxu_{TERRAIN_WORLDS}w_{DMXU_RES}"
    record = []
    cfg = scenes.binned_terrain_config(TERRAIN_WORLDS, DMXU_RES, DMXU_RES)
    r, step_s, counts, ctor_s, name = drive_tool(path, cfg, DMXU_RES, "binned", record=record,
                                                 deferred_mxu=True)
    if name != "render_binned_dmxu":
        raise AssertionError(f"{path}: took {name}, not K11 on the binned walk")
    add_launches(counts)
    kw = path_inputs(r)
    exported = exports(r)
    if kw["rowskip"] != (mips.tile_geometry(DMXU_RES, DMXU_RES)[1] > 1):
        raise AssertionError(f"{path}: K11's row gate is {kw['rowskip']}")
    if not same_frames(rc.render_resident(**kw), exported):
        raise AssertionError(f"{path}: K11 on the last inputs differs from the exports")
    if not torch.isfinite(exported[0]).all() or not bool((exported[0] > 0).any()):
        raise AssertionError(f"{path}: depth not finite or empty")
    check_pack(path, r.state, r.scene, r.state.camera_pos[:, 0, :])
    # At 512² K11 is held to its replayed walk (torch ops), to its launch
    # without the row gate and, every step, to K4 (the index-order plain
    # sweep takes about a minute there, as for terrain_32w_512); against
    # the plain version at the tool's 128² check below.
    walk_matches(path, kw, exported)
    kw_off = dict(kw, rowskip=False)
    same = same_frames(rc.render_resident(**kw_off), exported)
    emit({"phase": "rowskip_off", "case": path, "kernel": name, "bitwise": same})
    if not same:
        raise AssertionError(f"{path}: rowskip=False differs")
    # The forced plans and the parent design at full size, the row gate on
    # and off, and the entry's occupancy.
    check_plans(path, kw, exported)
    check_plans(f"{path}_rowskip_off", kw_off, exported)
    emit({"phase": "binned_occupancy", "case": path, **rc.binned_occupancy(kw)})
    ab = {"k11": [], "k4": []}
    for i, state in enumerate(record):
        km = rc.pack_inputs(state, r.scene, height=DMXU_RES, width=DMXU_RES, accel="binned",
                            deferred_mxu=True)
        k4 = rc.pack_inputs(state, r.scene, height=DMXU_RES, width=DMXU_RES, accel="binned")
        same = same_frames(rc.render_resident(**km), rc.render_resident(**k4))
        emit({"phase": "dmxu_vs_k4", "case": path, "step": i, "bitwise": same})
        if not same:
            raise AssertionError(f"{path} step {i}: K11's frames differ from K4's")
        ab["k11"].append(cuda_ms(lambda km=km: rc.render_resident(**km), 1))
        ab["k4"].append(cuda_ms(lambda k4=k4: rc.render_resident(**k4), 1))
        del km, k4
    # The tool's correctness check at 128² (one TPU tile across: no row
    # gate), K11 and K4 on the last state against one plain output.
    km, k4 = path_inputs(r, height=128, width=128), path_inputs(r, height=128, width=128,
                                                                deferred_mxu=False)
    clear_plain()
    same = same_frames(check_render(f"{path}_128", km, keep=True, memo=(path,)),
                       check_render(f"{path}_128", k4, memo=(path,)))
    emit({"phase": "dmxu_vs_k4", "case": f"{path}_128", "rowskip": km["rowskip"],
          "bitwise": same})
    if not same or km["rowskip"] or not km["dmxu"]:
        raise AssertionError(f"{path} at 128²: K11 (no row gate) differs from K4")
    clear_plain()
    # Its kernels-line row on the 128² inputs (their plain time is the
    # check's); at 512² with and without the row gate, lines of their own
    # without a plain time.
    timing_kw[name] = km
    full_timing = [(path, kw), (f"{path}_rowskip_off", kw_off)]
    k4_steps = terrain_steps[DMXU_K4_PATH]
    extra = {"accel": "binned", "deferred_mxu": True, "route": name, "rowskip": kw["rowskip"],
             "tris_per_world": int(kw["rows"].shape[2]),
             "clusters_per_world": int(kw["clusters"].shape[2]), **device_share(r, step_s),
             **{k: v for k, v in walks(kw).items() if k not in ("depth", "segmask")},
             **{f"ab_{k}_kernel_ms_median": statistics.median(v) for k, v in ab.items()},
             "k4_route": f"render_binned ({DMXU_K4_PATH}'s steps)", **ab_of("k4", k4_steps)}
    time_path(path, r, step_s, counts, ctor_s, extra)
    del r, record, kw, km, k4
    torch.cuda.empty_cache()

    # bigmesh_512w_dmxu: bigmesh_512w with deferred_mxu=True: K11 on the
    # ordered walk (64², no row gate: one TPU tile across), every step's
    # state through K5 too (bitwise the exported frames: dmxu_vs_k5, both
    # timed at the kernel entry on the timed steps); bigmesh_512w's steps
    # above are the same loop through K5.
    path = "bigmesh_512w_dmxu"
    record = []
    r, step_s, counts, ctor_s, name = drive(
        path, m.RenderMode.Raytracer, BIGMESH_WORLDS, False, TIMED_STEPS,
        cfg=scenes.bigmesh_config(BIGMESH_WORLDS, WIDTH, HEIGHT), record=record,
        deferred_mxu=True)
    if name != "render_streamed_dmxu":
        raise AssertionError(f"{path}: took {name}, not K11 on the ordered walk")
    kw = full_size_checks(path, r, name)
    if kw["rowskip"]:
        raise AssertionError(f"{path}: the row gate is on at 64²")
    timing_kw[name] = kw
    walk_matches(path, kw, exports(r))
    emit({"phase": "streamed_occupancy", "case": path, **rc.streamed_occupancy(kw)})
    ab = {"k11": [], "k11_parent": [], "k5": []}
    for i, (state, depth, seg, rgb) in enumerate(record):
        k5 = rc.pack_inputs(state, r.scene, height=HEIGHT, width=WIDTH)
        same = same_frames(rc.render_resident(**k5),
                           (depth, seg, rgb.contiguous().view(torch.int32).squeeze(-1)))
        if not same:
            raise AssertionError(f"{path} step {i}: K11's frames differ from K5's")
        if i >= WARMUP_STEPS:
            km = rc.pack_inputs(state, r.scene, height=HEIGHT, width=WIDTH, deferred_mxu=True)
            ab["k11"].append(cuda_ms(lambda km=km: rc.render_resident(**km), 1))
            ab["k11_parent"].append(cuda_ms(lambda km=km: on_plan(
                lambda: rc.render_resident(**km), km, 0), 1))
            ab["k5"].append(cuda_ms(lambda k5=k5: rc.render_resident(**k5), 1))
    emit({"phase": "dmxu_vs_k5", "case": path, "steps": len(record), "bitwise": True})
    extra = {"deferred_mxu": True, "route": name, "rowskip": False, **device_share(r, step_s),
             **{f"walk_{k}": v for k, v in work_of(walks(kw)).items()},
             "pixel_tests": walks(kw)["pixel_tests"],
             **{f"ab_{k}_kernel_ms_median": statistics.median(v) for k, v in ab.items()},
             "k5_route": "render_streamed (bigmesh_512w's steps)", **ab_of("k5", cold_step_s)}
    time_path(path, r, step_s, counts, ctor_s, extra)
    add_launches(counts)
    del r, record, kw
    torch.cuda.empty_cache()

    # ---- the 9-output mode's paths on the culled visits: the terrains
    # textured with the 256x256 checker, no mips ----------------------- #
    def nine_ab(path, record, scene, res, a, b):
        """Each recorded step's state through the visits ``a`` and ``b``
        (pack_inputs options) at the kernel entry: the nine outputs bitwise
        equal; the medians of each launch's device time on the timed steps."""
        ab = {"a": [], "b": []}
        for i, (state, *_) in enumerate(record):
            ka = rc.pack_inputs(state, scene, height=res, width=res, **a)
            kb = rc.pack_inputs(state, scene, height=res, width=res, **b)
            if not same_frames(rc.render_resident(**ka), rc.render_resident(**kb)):
                raise AssertionError(f"{path} step {i}: {variant(ka)} and {variant(kb)} "
                                     "differ")
            ab["a"].append(cuda_ms(lambda ka=ka: rc.render_resident(**ka), 1))
            ab["b"].append(cuda_ms(lambda kb=kb: rc.render_resident(**kb), 1))
            del ka, kb
        emit({"phase": "nine_ab", "case": path, "steps": len(record), "bitwise": True})
        return [statistics.median(t[WARMUP_STEPS:]) for t in (ab["a"], ab["b"])]

    # bigmesh_512w_tex256: bigmesh_512w's scene with the terrain textured
    # (uvs xy / 8) by the 256x256 checker baked without mips: the 9-output
    # mode on K3 + K5 and the planar epilogue; then the same steps with
    # deferred_mxu=True (K11's 9-output mode), every step's state through
    # both at the kernel entry (the nine planes bitwise, both timed).
    path = "bigmesh_512w_tex256"
    cfg = scenes.bigmesh_config(BIGMESH_WORLDS, WIDTH, HEIGHT, texture=tex256_png)
    r, step_s, counts, ctor_s, name = drive(path, m.RenderMode.Raytracer, BIGMESH_WORLDS,
                                            True, TIMED_STEPS, cfg=cfg, mipmaps=False)
    if name != "render_streamed_nine" or rc.has_mips(r.scene):
        raise AssertionError(f"{path}: took {name}, not K3 + K5's 9-output mode")
    clear_plain()
    kw, outs = core_checks(path, r, HEIGHT, memo=(path,))
    timing_kw[name] = kw
    emit({"phase": "streamed_occupancy", "case": path, **rc.streamed_occupancy(kw)})
    kw_m = path_inputs(r, deferred_mxu=True)
    check_render(path, kw_m, keep=True, memo=(path,))
    clear_plain()
    timing_kw[variant(kw_m)] = kw_m
    extra = {"route": name, "pool_texels": int(r.scene.tex_data.shape[0]),
             "tris_per_world": int(kw["rows"].shape[2]), **device_share(r, step_s),
             "epilogue_ms": cuda_ms(lambda: frames_of(r, outs), 5)}
    add_launches(counts)
    del outs
    record = []
    rm, step_m, counts_m, _, name_m = drive(path + "_dmxu", m.RenderMode.Raytracer,
                                            BIGMESH_WORLDS, True, TIMED_STEPS, cfg=cfg,
                                            record=record, mipmaps=False, deferred_mxu=True)
    if name_m != "render_streamed_dmxu_nine":
        raise AssertionError(f"{path}: deferred_mxu took {name_m}, not K11's 9-output mode")
    add_launches(counts_m)
    k11_ms, k5_ms = nine_ab(path, record, r.scene, HEIGHT, dict(deferred_mxu=True), {})
    extra.update(dmxu_route=name_m, **ab_of("dmxu", step_m), ab_k11_kernel_ms_median=k11_ms,
                 ab_k5_kernel_ms_median=k5_ms)
    del rm, record
    time_path(path, r, step_s, counts, ctor_s, extra)
    del r
    torch.cuda.empty_cache()

    # resident_terrain_4096w_64_tex256: resident_terrain_4096w_64's scene
    # (the 27-grid terrain) textured the same way: the 9-output mode on K3
    # on resident rows; every timed step's state through K4 on resident
    # rows too (accel="binned", the nine planes bitwise, both timed).
    path = "resident_terrain_4096w_64_tex256"
    res = HEIGHT
    cfg = scenes.bigmesh_config(NUM_WORLDS, res, res, grid=RESIDENT_GRID, texture=tex256_png)
    record = []
    r, step_s, counts, ctor_s, name = drive(path, m.RenderMode.Raytracer, NUM_WORLDS, True,
                                            TIMED_STEPS, moved=1, size=res, cfg=cfg,
                                            record=record, mipmaps=False)
    if name != "render_resident_ordered_nine":
        raise AssertionError(f"{path}: took {name}, not K3's 9-output mode on resident rows")
    clear_plain()
    kw, outs = core_checks(path, r, res, memo=(path,))
    timing_kw[name] = kw
    emit({"phase": "resident_occupancy", "case": path, **rc.resident_occupancy(kw)})
    kw_b = path_inputs(r, accel="binned")
    check_render(path, kw_b, keep=True, memo=(path,))
    clear_plain()
    resident_kw[path] = [kw_b]
    k3_ms, k4_ms = nine_ab(path, record, r.scene, res, {}, dict(accel="binned"))
    extra = {"route": name, "binned_route": variant(kw_b),
             "tris_per_world": int(kw["rows"].shape[2]),
             "clusters_per_world": int(kw["clusters"].shape[2]), **device_share(r, step_s),
             "epilogue_ms": cuda_ms(lambda: frames_of(r, outs), 5),
             "ab_ordered_kernel_ms_median": k3_ms, "ab_binned_kernel_ms_median": k4_ms}
    add_launches(counts)
    del outs, record
    time_path(path, r, step_s, counts, ctor_s, extra)
    del r
    torch.cuda.empty_cache()

    # ---- timings of every kernel at its path's full-size inputs --------- #
    def k13_row(layout, state, scene):
        cam = state.camera_pos[:, 0, :].contiguous() if layout == "pack_rows" else None
        bound_ms, bound_by, nbytes, ops = k13_bound(state, scene, layout)
        return {
            "name": layout, "route": "cuda",
            "source": "madrona_renderer_tpu_torch/csrc/pack_rows.cu",
            "replaces": "madrona_renderer_tpu/ops/pack_pallas.py:374",
            "launches": launches[layout], "max_abs_err": max_err[layout],
            "ms": graph_ms(lambda: pack_cuda.pack_rows(state, scene, cam), KERNEL_REPS),
            "wrapper_ms": cuda_ms(lambda: pack_cuda.pack_rows(state, scene, cam), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: rc._pack_rows_planar(state, scene, cam), 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "worlds": int(state.instance_obj.shape[0]), "bytes": nbytes, "ops": ops,
        }

    def bound_of(kw):
        """The render kernel's bound on these inputs and the work it counts,
        from its walk replayed (K1's index order included; K1-none and K12
        test every triangle)."""
        if is_batched(kw):
            return k12_bound(kw), {}
        if route(kw) == rc.NONE:
            return none_bound(kw), {}
        walk = walks(kw)
        work = {k: walk[k] for k in ("triangle_visits", "shadow_triangle_visits",
                                     "cluster_visits", "clusters_streamed", "pixel_tests")
                if k in walk}
        bound = dmxu_bound if dmxu(kw) else k5_bound if streamed(kw) else resident_bound
        return bound(kw, walk), work

    def plain_ms(checked, name, kw, once, fn):
        """The plain version's time on these inputs: the check's, where it
        ran on them; else one cold call (``once``: the walks' inputs, seconds
        long) or two warm ones."""
        for checked_kw, ms in checked.get(name, ()):
            if checked_kw is kw:
                return ms
        return cuda_ms(fn, 1, warm=False) if once else cuda_ms(fn, 2)

    def source_of(kw):
        if is_batched(kw):
            return "madrona_renderer_tpu_torch/csrc/render_batched.cu"
        lib = rc.library_of(route(kw), seeded(kw), kw.get("texture"), dmxu(kw), kw["geo"])
        return f"madrona_renderer_tpu_torch/csrc/{lib}.cu"

    def replaces_of(kw):
        """The TPU kernel's launch: K12's (:4671), the non-culled one
        (:4911), the culled one (:4872)."""
        line = 4671 if is_batched(kw) else 4911 if route(kw) == rc.NONE else 4872
        return f"madrona_renderer_tpu/ops/raytrace_pallas.py:{line}"

    def plan_split(kw):
        """The streamed binned walk's plan on these inputs: its tile groups
        (0: render_body's 16x16 blocks) and blocks a view; K1's index visit's
        tile groups; {} off them."""
        if not is_batched(kw) and route(kw) in (rc.INDEX, rc.NONE):
            return {"groups": index_plan_of(kw).groups}
        if is_batched(kw) or not (binned(kw) and streamed(kw)):
            return {}
        S, CC = int(kw["rows"].shape[2]), int(kw["clusters"].shape[2])
        plan = rc.binned_plan(kw["geo"], S // CC, kw["n_lights"], int(kw["cams"].shape[0]),
                              kw["height"], kw["width"], kw["bin_tile"], dmxu(kw))
        return {"groups": plan.groups, "blocks_per_view": plan.parts}

    # The entries whose path's inputs the index visit's teams take, timed in
    # turns with their parent design (render_body's 16x16 blocks): K8, K10,
    # K1-none, K1's 9-output mode, K1-raw, K2+K6 (raster_256w_png's
    # inputs) and K2 (main's inputs rasterized).
    team_paths = {"render_resident_raw_shadows": "shadows_4096w",
                  "render_resident_raw_wt_tex_nearest": "watertight_4096w",
                  "render_none": "none_4096w",
                  "render_resident_nine": "tex256_cliff_4096w",
                  "render_resident_raw": "multicam_1024w4c",
                  "render_resident_raster_tex_nearest": "raster_256w_png",
                  "render_resident_raster": "main"}

    def team_ab(name, kw, row):
        """The A/B line of a team entry on its path's inputs (``row``: its
        timing row): teams, parent, parent, teams."""
        if name not in team_paths:
            return
        turns = {"teams": [], "parent": []}
        for which in ("teams", "parent", "parent", "teams"):
            turns[which].append(graph_ms(
                lambda: on_index_plan(lambda: run_kernel(kw),
                                      None if which == "teams" else 0), KERNEL_REPS))
        emit({"phase": "timing", "inputs": team_paths[name], "name": name, "ab": "parent",
              "groups": plan_split(kw).get("groups"), "ms_turns": turns,
              "ms": statistics.mean(turns["parent"]),
              "teams_ms": statistics.mean(turns["teams"]),
              "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]})

    def render_row(name, kw, plain=True, bound=True, reps=None):
        """A render variant's timing line; ``plain`` and ``bound`` False leave
        out the plain version's time and the replayed walk (None), for the
        terrain at 256² and 512², where the index-order sweep takes 20-70 s,
        and for K5 on the terrain, whose walk's replay takes minutes. This
        slice's kernels take ``reps`` launches a graph and their plain
        version once, cold."""
        (bound_ms, bound_by, nbytes, ops), work = (
            bound_of(kw) if bound else ((None, None, None, None), {}))
        if reps is None:
            reps = KERNEL_REPS if binned(kw) or not streamed(kw) or bound else KERNEL_REPS // 10
        once = streamed(kw) or is_new(kw) or is_batched(kw)
        plain_fn = rc.render_batched_plain if is_batched(kw) else rc.render_resident_plain
        return {
            "name": name, "route": "cuda", "source": source_of(kw),
            "replaces": replaces_of(kw),
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": graph_ms(lambda: run_kernel(kw), reps),
            "wrapper_ms": cuda_ms(lambda: run_kernel(kw), reps),
            "plain_ms": plain_ms(plain_of, name, kw, once,
                                 lambda: plain_fn(**kw)) if plain else None,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "views": int(kw["cams"].shape[0]), **work, "bytes": nbytes, "ops": ops,
            **plan_split(kw),
        }

    def handoff_row(name, kw, reps=KERNEL_REPS):
        """K7's first launch alone (the render kernel's mip hand-off)."""
        (bound_ms, bound_by, nbytes, ops), work = bound_of(kw)
        once = streamed(kw) or is_new(kw)
        return {
            "name": name, "route": "cuda", "source": source_of(kw),
            "replaces": replaces_of(kw),
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": graph_ms(lambda: handoff(kw), reps),
            "wrapper_ms": cuda_ms(lambda: handoff(kw), reps),
            "plain_ms": plain_ms(handoff_plain_of, name, kw, once,
                                 lambda: handoff(kw, plain=True)),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "views": int(kw["cams"].shape[0]), **work, "bytes": nbytes, "ops": ops,
            # The hand-off always runs the parent's 16x16 blocks on the index order.
            **({"groups": 0} if route(kw) == rc.INDEX else plan_split(kw)),
        }

    def shade_row(name, kw):
        """K7's second launch alone, on the card's hand-off."""
        _, _, code, hf = handoff(kw)
        bound_ms, bound_by, nbytes, ops = shade_mip_bound(kw, code)
        return {
            "name": name, "route": "cuda",
            "source": "madrona_renderer_tpu_torch/csrc/shade_mip.cu",
            "replaces": "madrona_renderer_tpu/ops/raytrace_pallas.py:3203",
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": graph_ms(lambda: shade(kw, code, hf), KERNEL_REPS),
            "wrapper_ms": cuda_ms(lambda: shade(kw, code, hf), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: shade(kw, code, hf, plain=True), 5),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "views": int(code.shape[0]), "bytes": nbytes, "ops": ops,
        }

    def k7_rows(kw):
        """K7 on these inputs against its corrected bound (k7_bound): the
        two launches together (the hand-off and shade_mip, the parent
        design), and where the plan folds them, the folded entry too,
        both timed in turns (folded, pair, pair, folded): (the folded
        entry's row or None, the pair's row)."""
        walk = walks(kw)
        code = handoff(kw)[2]
        bound_ms, bound_by, nbytes, ops = k7_bound(kw, walk, code)
        del code
        folds = rc.mip_plan(**kw).groups > 0
        pair = lambda: on_index_plan(lambda: rc.render_resident(**kw), 0)
        times = {"folded": [], "pair": []}
        for which in (("folded", "pair", "pair", "folded") if folds else ("pair",)):
            fn = (lambda: rc.render_resident(**kw)) if which == "folded" else pair
            times[which].append(graph_ms(fn, KERNEL_REPS))
        common = {"route": "cuda", "replaces": "madrona_renderer_tpu/ops/raytrace_pallas.py:4872",
                  "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                  "views": int(kw["cams"].shape[0]), "triangle_visits": walk["triangle_visits"],
                  "bytes": nbytes, "ops": ops}
        name = pair_name(kw)
        pair_row = {
            "name": name,
            "source": "madrona_renderer_tpu_torch/csrc/render_resident.cu + "
                      "madrona_renderer_tpu_torch/csrc/shade_mip.cu",
            "launches": min(launches[part] for part in name.split("+")),
            "max_abs_err": max(max_err[part] for part in name.split("+")),
            "ms": statistics.mean(times["pair"]), "ms_turns": times["pair"],
            "wrapper_ms": cuda_ms(pair, KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: rc.render_resident_plain(**kw), 2), **common}
        if not folds:
            return None, pair_row
        folded = rc.mip_name(kw["texture"])
        folded_row = {
            "name": folded, "source": "madrona_renderer_tpu_torch/csrc/render_mip.cu",
            "launches": launches[folded], "max_abs_err": max_err[folded],
            "ms": statistics.mean(times["folded"]), "ms_turns": times["folded"],
            "wrapper_ms": cuda_ms(lambda: rc.render_resident(**kw), KERNEL_REPS),
            "plain_ms": pair_row["plain_ms"], "pair_ms": pair_row["ms"],
            "groups": rc.mip_plan(**kw).groups, **common}
        return folded_row, dict(pair_row, ab_of=folded)

    # The streamed variants bigmesh_512w does not run are timed on the
    # 64-world inputs of their first kernel_vs_plain scene, NEW_KERNEL_REPS
    # launches a graph.
    small = {name for name in streamed_kw if name not in timing_kw}
    for name, kw in streamed_kw.items():
        timing_kw.setdefault(name, kw)
    rows = []
    for layout in pack_cuda.LAYOUTS:
        rows.append(k13_row(layout, *timing_kw[layout]))
        emit({"phase": "timing", **rows[-1]})
    for name in rc.VARIANTS + rc.BINNED_VARIANTS:
        kw = timing_kw[name]
        reps = NEW_KERNEL_REPS if name in small else KERNEL_REPS
        rows.append(handoff_row(name, kw, reps) if is_k7(kw) else render_row(name, kw,
                                                                                reps=reps))
        team_ab(name, kw, rows[-1])
        if name == "render_resident":
            # K1 at 64x64 (main's inputs) and, a row of its own named
            # render_resident@128, at 128x128 (mxu_4096w_128's "auto"
            # inputs), each with its launches.
            rows[-1]["launches"] -= k1_128["launches"]
            emit({"phase": "timing", **rows[-1]})
            rows.append(dict(render_row(name, k1_128["kw"]), name=f"{name}@128",
                             inputs="mxu_4096w_128_auto", launches=k1_128["launches"]))
        emit({"phase": "timing", **rows[-1]})
    # The eighth and ninth slices' kernels (K3 and K4 on resident rows, K9,
    # K1-none, the 9-output mode, K12): a path's own on its full-size inputs,
    # the others on the 64-world inputs of their first kernel_vs_plain
    # scene, NEW_KERNEL_REPS launches a graph.
    for name in (rc.RESIDENT_ORDERED_VARIANTS + rc.RESIDENT_BINNED_VARIANTS
                 + rc.SEEDED_VARIANTS + rc.NONE_VARIANTS + rc.NINE_VARIANTS
                 + rc.BATCHED_VARIANTS):
        kw = timing_kw.get(name) or first_kw[name]
        reps = KERNEL_REPS if name in timing_kw else NEW_KERNEL_REPS
        rows.append(handoff_row(name, kw, reps) if is_k7(kw) else render_row(name, kw,
                                                                                reps=reps))
        team_ab(name, kw, rows[-1])
        emit({"phase": "timing", **rows[-1]})
    # K11, and the culled visits' 9-output entries: a path's own on its
    # full-size inputs, the others on the 64-world inputs (4 worlds at 128²
    # for the binned terrain's) of their first kernel_vs_plain scene.
    for name in rc.DMXU_VARIANTS + rc.CULLED_NINE_VARIANTS:
        kw = timing_kw.get(name) or first_kw[name]
        reps = NEW_KERNEL_REPS if name in small or name not in timing_kw else KERNEL_REPS
        rows.append(handoff_row(name, kw, reps) if is_k7(kw) else render_row(name, kw,
                                                                                reps=reps))
        emit({"phase": "timing", **rows[-1]})
    for name in rc.SHADE_MIP_VARIANTS:
        rows.append(shade_row(name, timing_kw[name]))
        emit({"phase": "timing", **rows[-1]})
    # K7 folded (csrc/render_mip.cu) on textured256_4096w's inputs, each
    # filter a row, timed in turns with the two launches it replaces (their
    # A/B line below).
    k7_pairs = []
    for name in rc.MIP_VARIANTS:
        folded_row, pair_row = k7_rows(timing_kw[name])
        if folded_row is None:
            raise AssertionError(f"textured256_4096w: {name}'s inputs take no folded plan")
        rows.append(folded_row)
        k7_pairs.append(pair_row)
        emit({"phase": "timing", **rows[-1]})
    # L1-L3 on the tool's inputs; their library call is the one PyTorch
    # operator that computes each (x * 2, the broadcast add, sum(-1) and its
    # broadcast view).
    library = {"ladder_copy": lambda x: x * 2.0,
               "ladder_grid_smem": lambda s, x: x + s,
               "ladder_fori_smem": lambda t: t[:, 0].sum(-1)[:, None, None].expand(-1, 8, 128)}
    replaces = {"ladder_copy": "tools/tpu_ladder.py:43",
                "ladder_grid_smem": "tools/tpu_ladder.py:64",
                "ladder_fori_smem": "tools/tpu_ladder.py:94"}
    for name in ladder.KERNELS:
        args = probes[name]
        bound_ms, bound_by, nbytes, ops = ladder_bound(name, args)
        rows.append({
            "name": name, "route": "cuda", "source": "madrona_renderer_tpu_torch/csrc/ladder.cu",
            "replaces": replaces[name], "launches": ladder_launches[name],
            "max_abs_err": max_err[name],
            "ms": graph_ms(lambda: ladder.WRAPPERS[name](*args), KERNEL_REPS),
            "wrapper_ms": cuda_ms(lambda: ladder.WRAPPERS[name](*args), KERNEL_REPS),
            "plain_ms": cuda_ms(lambda: ladder.PLAIN[name](*args), KERNEL_REPS),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(lambda: library[name](*args), KERNEL_REPS),
            "blocks": int(args[-1].shape[0]), "bytes": nbytes, "ops": ops})
        emit({"phase": "timing", **rows[-1]})
    for row in k7_pairs:
        emit({"phase": "timing", "inputs": "textured256_4096w", **row})
    for kw in k7_timing:
        if not rc.mip_plan(**kw).groups:  # the folded ones' pairs are above
            emit({"phase": "timing", "inputs": "textured256_4096w", **k7_rows(kw)[1]})
    for name, path, inputs in extra_timing:
        row = k13_row(name, *inputs) if name in pack_cuda.LAYOUTS else render_row(name, inputs)
        emit({"phase": "timing", "inputs": path, **row})
    # The resident terrain paths' A/B: the visits the path does not take, on
    # its last inputs (the plain times of their checks there).
    for path, visits in resident_kw.items():
        for vkw in visits:
            emit({"phase": "timing", "inputs": path, **render_row(variant(vkw), vkw)})
    # K11 on its terrain path's 512² inputs, with and without the row gate.
    for path, kw in full_timing:
        emit({"phase": "timing", "inputs": path, "rowskip": kw["rowskip"],
              **render_row(variant(kw), kw, plain=False)})
    # K4 on the larger terrain paths and K5 on each (the tool's A/B), on the
    # same inputs; K5's walk is not replayed there (minutes at these sizes).
    for path, res, kw, kw5 in terrain_timing:
        if res != 128:
            emit({"phase": "timing", "inputs": path,
                  **render_row(variant(kw), kw, plain=False)})
        emit({"phase": "timing", "inputs": path,
              **render_row(variant(kw5), kw5, plain=False, bound=False)})

    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
