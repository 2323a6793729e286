"""PyTorch port: the seeded search window (K9) and the warm start built on it
(ops/warmstart.py) == the JAX package's.

A seed bounds each pixel's hit t from above (``raytrace(seed_t=)``): a valid
bound changes nothing, an undershooting one turns the pixel into a miss,
as in the JAX ``render_core`` (tests/test_seed_depth.py). The warm start
renders seeded by a previous depth and repairs the pixels that missed under
a finite seed; its frames are bitwise a cold render's for any seed
(tests/test_warmstart.py), through ``Manager(warmstart=True)`` too. On the
CPU the kernel's plain version renders (its best t starts at
min(seed, far)); ``ops/walk_replay`` replays the walks with the seed, which
the frames must not notice and the work must.

Scenes: tools/tpu_binned_bench.py's terrain at a 48 grid (2 worlds, 4,608
triangles a world: the streamed route, ordered or binned), bench.py's
big-mesh terrain at a 12 grid (resident, ordered), the demo scene (resident,
index order); each built once a worker. Bars: bitwise where the claim is
"unchanged" (seeds, warm start, Manager); against the JAX package's seeded
frames the parity bar of tests/test_pallas_parity.py (rgb ±1 LSB, depth
1e-5, segmask exact).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu_torch.ops import quat as t_quat
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.ops import walk_replay
from madrona_renderer_tpu_torch.ops.warmstart import raytrace_prepass, raytrace_warmstart
from madrona_renderer_tpu_torch.runners.scenes import demo_config

from tests.torch_helpers import assert_frames_close, carry_over, one_thread, spec_from_config, \
    terrain_spec

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


def _terrain48():
    from tpu_binned_bench import build_scene

    return build_scene(2, 48)


SCENES = {
    "terrain48": _terrain48,
    "terrain12": lambda: terrain_spec(grid=12).build_jax(),
    "demo": lambda: spec_from_config(demo_config(4, tm.RenderMode.Raytracer, 64, 64,
                                                 dynamic=True)).build_jax(),
}
# The warm start's size and visit (tests/test_warmstart.py renders 128²
# binned; 64² keeps the CPU's plain sweeps short and still bins).
KW = dict(height=64, width=64, accel="binned")


@functools.cache
def _built(name):
    """(JAX state and scene, the port's), once a worker."""
    j_state, j_scene = SCENES[name]()
    return (j_state, j_scene), carry_over(j_state, j_scene)


@functools.cache
def _cold(name, size, accel):
    _, (t_state, t_scene) = _built(name)
    return trc.raytrace(t_state, t_scene, height=size, width=size, accel=accel)


def _assert_equal(a, b):
    for f in ("rgb", "depth", "segmask"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _turned(state, angle):
    """Every instance turned about z by ``angle`` (the tests' stale seed)."""
    dq = torch.tensor([np.cos(angle), 0.0, 0.0, np.sin(angle)], dtype=torch.float32)
    rot = t_quat.quat_normalize(t_quat.quat_multiply(dq, state.instance_rot))
    return dataclasses.replace(state, instance_rot=rot)


# ---------------------------------------------------------------- K9 ----
@pytest.mark.parametrize("name,accel,size", [
    ("terrain48", "binned", 64), ("terrain48", "clusters", 64),
    ("terrain12", "auto", 64), ("demo", "auto", 64),
])
def test_exact_seed_is_bitwise_noop(name, accel, size):
    """tests/test_seed_depth.py:27-51: a seed just above each hit (and far
    on misses) changes nothing, on the streamed binned and ordered visits,
    the resident ordered visit and K1's index order."""
    _, (t_state, t_scene) = _built(name)
    f0 = _cold(name, size, accel)
    route = trc.visit_route(t_state, t_scene, size, size, accel)
    assert route.visit == {"binned": "binned", "clusters": "ordered"}.get(
        accel, "ordered" if name == "terrain12" else "index")
    seed = torch.where(f0.depth > 0, f0.depth * 1.0001, 1000.0)
    _assert_equal(trc.raytrace(t_state, t_scene, height=size, width=size, accel=accel,
                               seed_t=seed), f0)


def test_far_seed_is_bitwise_noop():
    """tests/test_seed_depth.py:54-60."""
    _, (t_state, t_scene) = _built("terrain48")
    f1 = trc.raytrace(t_state, t_scene, seed_t=torch.full((2, 1, 64, 64), 1000.0), **KW)
    _assert_equal(f1, _cold("terrain48", 64, "binned"))


@pytest.mark.parametrize("name,accel,size", [("terrain48", "clusters", 64),
                                             ("terrain12", "auto", 32)])
def test_undershooting_seed_is_jax_miss(name, accel, size):
    """tests/test_seed_depth.py:63-73: a seed at half of each hit's depth
    turns every hit into a miss; a seed exactly at the hit's t too (a hit
    must lie strictly inside the window, even where the walk's tie rule
    would take an equal t); the port's frames equal the JAX Pallas kernel's
    on the same seeds."""
    (j_state, j_scene), (t_state, t_scene) = _built(name)
    f0 = trc.raytrace(t_state, t_scene, height=size, width=size, accel=accel)
    hit0 = f0.segmask >= 0
    assert hit0.any()
    for seed in (f0.depth * 0.5, f0.depth.clone()):
        f1 = trc.raytrace(t_state, t_scene, height=size, width=size, accel=accel,
                          seed_t=seed)
        assert not (f1.segmask >= 0)[hit0].any()
    half = f0.depth * 0.5
    f1 = trc.raytrace(t_state, t_scene, height=size, width=size, accel=accel, seed_t=half)
    j1 = j_pallas(j_state, j_scene, height=size, width=size, accel=accel, interpret=True,
                  seed_t=jnp.asarray(half.numpy()))
    assert_frames_close(j1, f1)


def test_seeded_walks_render_the_seeded_frames_with_less_work():
    """The replays of the streamed ordered and binned walks and the
    resident ordered walk, seeded just above each hit: the plain version's
    seeded frames, bitwise, and no more triangle tests than cold (fewer on
    the streamed terrain; on the resident one each hit's cluster spans the
    pixels that reach it, and the seed cuts no test)."""
    cases = [("terrain48", "clusters", 32), ("terrain48", "binned", 32),
             ("terrain12", "auto", 32)]
    for name, accel, size in cases:
        _, (t_state, t_scene) = _built(name)
        kw = trc.pack_inputs(t_state, t_scene, height=size, width=size, accel=accel)
        depth0, _, _ = trc.render_resident_plain(**kw)
        seed = torch.where(depth0 > 0, depth0 * 1.0001, 1000.0)
        depth, seg, _ = trc.render_resident_plain(**kw, seed=seed)
        walk = (walk_replay.resident_walk if kw["spans"] is None
                else walk_replay.binned_walk if kw["bins"] is not None
                else walk_replay.streamed_walk)
        with one_thread():
            cold, warm = walk(**kw), walk(**kw, seed=seed)
        assert torch.equal(warm["depth"], depth) and torch.equal(warm["segmask"], seg), name
        assert warm["triangle_visits"] <= cold["triangle_visits"], (name, accel)
        if name == "terrain48":
            assert warm["triangle_visits"] < cold["triangle_visits"], accel


# ---------------------------------------------------------- warm start ----
def test_exact_prev_depth_bitwise():
    """tests/test_warmstart.py:49-53."""
    _, (t_state, t_scene) = _built("terrain48")
    f0 = _cold("terrain48", 64, "binned")
    _assert_equal(raytrace_warmstart(t_state, t_scene, prev_depth=f0.depth, **KW), f0)


def test_stale_prev_depth_bitwise():
    """tests/test_warmstart.py:56-72: the scene turns after the depth was
    taken; silhouettes go through the repair pass."""
    _, (t_state, t_scene) = _built("terrain48")
    moved = _turned(t_state, 0.05)
    f0 = trc.raytrace(moved, t_scene, **KW)
    fw = raytrace_warmstart(moved, t_scene, prev_depth=_cold("terrain48", 64, "binned").depth,
                            **KW)
    _assert_equal(fw, f0)


@pytest.mark.parametrize("seedval", [0.0, 1e-3, 0.5, 999.0, 1000.0, 2000.0])
def test_garbage_seeds_bitwise(seedval):
    """tests/test_warmstart.py:75-81."""
    _, (t_state, t_scene) = _built("terrain48")
    fw = raytrace_warmstart(t_state, t_scene, prev_depth=torch.full((2, 1, 64, 64), seedval),
                            **KW)
    _assert_equal(fw, _cold("terrain48", 64, "binned"))


def test_adversarial_random_seeds_bitwise():
    """tests/test_warmstart.py:84-91, the seeds made with numpy."""
    _, (t_state, t_scene) = _built("terrain48")
    rng = np.random.default_rng(0)
    prev = torch.from_numpy(rng.uniform(0.0, 1200.0, size=(2, 1, 64, 64)).astype(np.float32))
    _assert_equal(raytrace_warmstart(t_state, t_scene, prev_depth=prev, **KW),
                  _cold("terrain48", 64, "binned"))


@pytest.mark.parametrize("factor,angle", [(4, 0.0), (8, 0.0), (8, 0.07)])
def test_prepass_bitwise(factor, angle):
    """tests/test_warmstart.py:120-146: the coarse prepass as the seed, on
    the scene as built and turned."""
    _, (t_state, t_scene) = _built("terrain48")
    state = _turned(t_state, angle) if angle else t_state
    f0 = trc.raytrace(state, t_scene, **KW) if angle else _cold("terrain48", 64, "binned")
    _assert_equal(raytrace_prepass(state, t_scene, factor=factor, **KW), f0)
    with pytest.raises(ValueError, match="factor"):
        raytrace_prepass(state, t_scene, factor=1, **KW)


@pytest.mark.parametrize("scene", ["demo", "terrain12", "demo_ssaa2"])
def test_manager_warmstart_bitwise_over_steps(scene):
    """tests/test_warmstart.py:94-117: Manager(warmstart=True) steps
    bit-identically to the cold Manager under in-place mutation (the demo;
    the resident terrain, ordered; the demo at ssaa=2, seeded by the
    upsampled depth); step_state takes a previous depth."""
    from madrona_renderer_tpu_torch.runners.scenes import bigmesh_config

    def config(warm):
        if scene == "terrain12":
            return bigmesh_config(2, 32, 32, grid=12, warmstart=warm, device="cpu")
        return demo_config(4, tm.RenderMode.Raytracer, 32, 32, dynamic=True, warmstart=warm,
                           ssaa=2 if scene == "demo_ssaa2" else 1, device="cpu")

    def run(warm):
        r = tm.Manager(config(warm))
        out = []
        for i in range(3):
            pos = r.instance_position_tensor().to_torch()
            pos[0][2] += 0.5 * (i + 1)
            r.step()
            out.append(tuple(t.to_torch().clone() for t in (r.rgb_tensor(), r.depth_tensor(),
                                                            r.segmask_tensor())))
        return r, out

    _, cold = run(False)
    r, warm = run(True)
    for c, w in zip(cold, warm):
        for a, b in zip(c, w):
            assert torch.equal(a, b)
    _, frames, _ = r.step_state(r.state, prev_depth=torch.zeros_like(r.frames.depth))
    _assert_equal(frames, r.render_state(r.state))


def test_manager_warmstart_gates():
    """tests/test_warmstart.py:149-162: the rasterizer raises (no segmask to
    drive the repair pass), as does more than one device (not ported yet)."""
    with pytest.raises(NotImplementedError, match="Raytracer"):
        tm.Manager(demo_config(2, tm.RenderMode.Rasterizer, 16, 16, warmstart=True,
                               device="cpu"))
    with pytest.raises(NotImplementedError, match="item 15"):
        tm.Manager(demo_config(2, tm.RenderMode.Raytracer, 16, 16, warmstart=True,
                               num_devices=2, device="cpu"))
