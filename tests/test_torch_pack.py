"""PyTorch port: the render prologue == the JAX package's input pack.

Seeded random states (random quaternions, scales with a mirrored axis,
positions, some instances disabled, per-camera fov/znear) go through the
JAX pack functions and the port's. JAX runs op by op under
``jax.disable_jit()``, so XLA:CPU cannot contract a multiply-add into an
FMA; the float tolerance |Δ| ≤ 1e-6·max(1, |x|) then only has to cover
rounding differences of library functions (tan, sqrt); integer-valued rows
are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.core.state import SimState as JSimState
from madrona_renderer_tpu.ops import raytrace_pallas as jrp
from madrona_renderer_tpu.ops.pack_pallas import pack_rows_pallas
from madrona_renderer_tpu.ops.raytrace_ref import planar_soup_parts as j_parts
from madrona_renderer_tpu.runners.scenes import demo_config
from madrona_renderer_tpu_torch.convert import scene_from_numpy, state_from_numpy
from madrona_renderer_tpu_torch.ops import pack_cuda
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.ops.raytrace_ref import planar_soup_parts as t_parts

from tests.torch_helpers import carry_over, random_spec, spec_from_config, to_numpy


def _close(a, b, what):
    a = np.asarray(a, np.float32)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    tol = 1e-6 * np.maximum(1.0, np.abs(a))
    bad = np.abs(a - b) > tol
    assert not bad.any(), (what, np.abs(a - b).max())


def _random_state(scene, n_worlds, n_inst, seed):
    rng = np.random.default_rng(seed)
    W, I = n_worlds, n_inst

    def quats(shape):
        q = rng.normal(size=shape + (4,))
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)

    scale = rng.uniform(0.5, 2.0, size=(W, I, 3)).astype(np.float32)
    scale[0, 0, 1] *= -1.0  # a mirrored axis (normal transform sign)
    valid = np.ones((W, I), np.float32)
    valid[W - 1, I - 1] = 0.0
    d = dict(
        instance_pos=(rng.normal(size=(W, I, 3)) * 3).astype(np.float32),
        instance_rot=quats((W, I)),
        instance_scale=scale,
        instance_obj=rng.integers(0, scene.num_objects, size=(W, I)).astype(np.int32),
        instance_valid=valid,
        camera_pos=(rng.normal(size=(W, 1, 3)) * 3 + [0, -12, 0]).astype(np.float32),
        camera_rot=quats((W, 1)),
        camera_valid=np.ones((W, 1), np.float32),
        camera_fov=rng.choice([0.0, 60.0, 110.0], size=(W, 1)).astype(np.float32),
        camera_znear=rng.choice([0.0, 0.5], size=(W, 1)).astype(np.float32),
        time=np.zeros((W,), np.float32),
    )
    return JSimState(**{k: jnp.asarray(v) for k, v in d.items()}), state_from_numpy(d)


SCENES = {
    "demo": lambda: spec_from_config(
        demo_config(2, RenderMode.Raytracer, 64, 64)).build_jax()[1],
    "demo_textured": lambda: spec_from_config(demo_config(
        2, RenderMode.Raytracer, 64, 64, textured=True, tex_size=32)).build_jax()[1],
    "random3": lambda: random_spec(3).build_jax()[1],
    "random11": lambda: random_spec(11).build_jax()[1],
}


@pytest.fixture(params=[(name, seed) for name in sorted(SCENES) for seed in (0, 1)],
                ids=lambda p: f"{p[0]}-seed{p[1]}")
def states(request):
    name, seed = request.param
    j_scene = SCENES[name]()
    t_scene = scene_from_numpy(to_numpy(j_scene))
    j_state, t_state = _random_state(j_scene, 3, 3, seed)
    return j_state, j_scene, t_state, t_scene


def test_planar_soup_parts(states):
    j_state, j_scene, t_state, t_scene = states
    with jax.disable_jit():
        jp = j_parts(j_state, j_scene)
    tp = t_parts(t_state, t_scene)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        if k == "mat":
            np.testing.assert_array_equal(np.asarray(jp[k]), tp[k].numpy())
        elif isinstance(jp[k], tuple):
            for c, (a, b) in enumerate(zip(jp[k], tp[k])):
                _close(a, b, f"{k}[{c}]")
        else:
            _close(jp[k], tp[k], k)


def test_pack_rows_planar_split_prep(states):
    j_state, j_scene, t_state, t_scene = states
    with jax.disable_jit():
        a = np.asarray(jrp._pack_rows_planar(
            j_state, j_scene, cam_pos=j_state.camera_pos[:, 0, :], split=True))
    b = trc._pack_rows_planar(t_state, t_scene, t_state.camera_pos[:, 0, :])
    assert a.shape == tuple(b.shape) == (3, 40, 3 * j_scene.tris_per_object)
    b = b.numpy()
    for r in range(10):  # prep rows D, A, Q, t_num
        _close(a[:, r], b[:, r], f"prep row {r}")
    for r in range(16, 36):  # attribute rows
        _close(a[:, r], b[:, r], f"attr row {r}")
    # Material ids are integers carried as floats: exact.
    np.testing.assert_array_equal(a[:, 31], b[:, 31])
    # Padding rows are zero in both.
    for r in list(range(10, 16)) + list(range(36, 40)):
        assert not a[:, r].any() and not b[:, r].any()


def test_pack_cams(states):
    j_state, j_scene, t_state, t_scene = states
    H, W = 24, 40
    with jax.disable_jit():
        eff_fov = jnp.where(j_state.camera_fov > 0, j_state.camera_fov, 90.0)
        eff_near = jnp.where(j_state.camera_znear > 0, j_state.camera_znear, 0.1)
        far = jnp.full_like(eff_near, 1000.0)
        a = np.asarray(jrp._pack_cams(j_state, j_scene, W, H, eff_fov, eff_near,
                                      far, far))
    t_fov = torch.where(t_state.camera_fov > 0, t_state.camera_fov, 90.0)
    t_near = torch.where(t_state.camera_znear > 0, t_state.camera_znear, 0.1)
    t_far = torch.full_like(t_near, 1000.0)
    b = trc._pack_cams(t_state, t_scene, W, H, t_fov, t_near, t_far, t_far)
    assert a.shape[0] == b.shape[0] and a.shape[2] == b.shape[1]
    _close(a[:, 0], b, "camera rows")


def test_world_clusters_and_pack(states):
    j_state, j_scene, t_state, t_scene = states
    with jax.disable_jit():
        jw = jrp.world_clusters(j_state, j_scene)
        a = np.asarray(jrp._pack_clusters(*jw))
    tw = trc.world_clusters(t_state, t_scene)
    for k, (x, y) in enumerate(zip(jw, tw)):
        _close(x, y, f"world_clusters[{k}]")
    b = trc._pack_clusters(*tw).numpy()
    assert a.shape == b.shape
    _close(a[:, :6], b[:, :6], "cluster bounds")
    # valid and count rows: exact.
    np.testing.assert_array_equal(a[:, 6:], b[:, 6:])



def _pack_kernel_scene(textured):
    from tests.test_pack_kernel import _scene

    return _scene(4, textured=textured)


PACK_KERNEL_SCENES = {
    "demo4_dynamic": lambda: spec_from_config(demo_config(
        4, RenderMode.Raytracer, 64, 64, dynamic=True)).build_jax(),
    "demo4_dynamic_textured": lambda: spec_from_config(demo_config(
        4, RenderMode.Raytracer, 64, 64, dynamic=True, textured=True,
        tex_size=32)).build_jax(),
    "pack_kernel_scene": lambda: _pack_kernel_scene(False),
    "pack_kernel_scene_textured": lambda: _pack_kernel_scene(True),
}


@pytest.mark.parametrize("name", sorted(PACK_KERNEL_SCENES))
def test_pack_rows_kernel_cpu_route_matches_jax_pack_kernel(name):
    """K13's wrapper on CPU tensors (its plain version) against the JAX
    package's Pallas pack kernel, split with the camera origin, in interpret
    mode: the real lanes of its geometry and attribute blocks, untextured
    and textured (the density row), at the bar above. The scenes are the
    demo's and tests/test_pack_kernel.py's (several objects, ragged
    instance lists, non-uniform scales). On the random quaternions of the
    ``states`` fixture the interpret-mode kernel itself strays from the JAX
    package's XLA pack by a few ulp in the cancelling cross products, which
    the port matches at the bar (test_pack_rows_planar_split_prep). The CPU
    route launches no kernel."""
    j_state, j_scene = PACK_KERNEL_SCENES[name]()
    t_state, t_scene = carry_over(j_state, j_scene)
    geo, attrs = pack_rows_pallas(j_state, j_scene, cam_pos=j_state.camera_pos[:, 0, :],
                                  split=True, interpret=True)
    W, I = t_state.instance_obj.shape
    S = I * j_scene.tris_per_object
    a = np.concatenate([np.asarray(geo)[:, :, :S], np.asarray(attrs)[:, :, :S]], axis=1)
    before = dict(pack_cuda.pack_rows.layout_launches)
    b = pack_cuda.pack_rows(t_state, t_scene, t_state.camera_pos[:, 0, :])
    assert pack_cuda.pack_rows.layout_launches == before
    assert a.shape == tuple(b.shape) == (W, pack_cuda.N_ROWS, S)
    b = b.numpy()
    for r in list(range(10)) + list(range(16, 36)):
        _close(a[:, r], b[:, r], f"row {r}")
    np.testing.assert_array_equal(a[:, 31], b[:, 31])  # material ids
    for r in list(range(10, 16)) + list(range(36, 40)):
        assert not a[:, r].any() and not b[:, r].any()


def test_pack_rows_planar_split_raw(states):
    """The raw layout (no camera origin): rows 0-8 v0, e1·valid, e2·valid
    bitwise against the JAX package's op-by-op split pack, row 9 the
    validity bitwise against its 32-row pack's row 9 (the JAX split layout
    leaves it zero; the watertight sweep ANDs it in), the attribute rows at
    the bar above."""
    j_state, j_scene, t_state, t_scene = states
    with jax.disable_jit():
        a = np.asarray(jrp._pack_rows_planar(j_state, j_scene, cam_pos=None, split=True))
        a32 = np.asarray(jrp._pack_rows_planar(j_state, j_scene))
    b = trc._pack_rows_planar(t_state, t_scene)
    assert a.shape == tuple(b.shape) == (3, 40, 3 * j_scene.tris_per_object)
    b = b.numpy()
    np.testing.assert_array_equal(a[:, :9], b[:, :9])
    np.testing.assert_array_equal(a[:, 10:16], b[:, 10:16])
    np.testing.assert_array_equal(a32[:, 9], b[:, 9])
    assert not a[:, 9].any() and b[:, 9].any()
    for r in range(16, 36):
        _close(a[:, r], b[:, r], f"attr row {r}")
    np.testing.assert_array_equal(a[:, 31], b[:, 31])
    for r in list(range(10, 16)) + list(range(36, 40)):
        assert not b[:, r].any()
    # Disabled instances keep their vertices and lose their edges.
    assert (b[2, 0:3, -j_scene.tris_per_object:] != 0).any()
    assert not b[2, 3:9, -j_scene.tris_per_object:].any()


@pytest.mark.parametrize("name", sorted(PACK_KERNEL_SCENES) + ["random_quaternions"])
def test_pack_rows_raw_cpu_route_matches_jax_pack_kernel(name):
    """K13's wrapper without a camera origin (the raw layout, its plain
    version on the CPU) against the JAX package's Pallas pack kernel with
    ``cam_pos=None`` in interpret mode, at the bar above: the demo, the
    pack-kernel scenes and a random-quaternion state. Row 9, the validity,
    is held against the JAX 32-row pack's row 9 (the Pallas split layout
    leaves it zero)."""
    if name == "random_quaternions":
        j_scene = SCENES["random3"]()
        j_state, t_state = _random_state(j_scene, 3, 3, 5)
        t_scene = scene_from_numpy(to_numpy(j_scene))
    else:
        j_state, j_scene = PACK_KERNEL_SCENES[name]()
        t_state, t_scene = carry_over(j_state, j_scene)
    geo, attrs = pack_rows_pallas(j_state, j_scene, cam_pos=None, split=True,
                                  interpret=True)
    W, I = t_state.instance_obj.shape
    S = I * j_scene.tris_per_object
    a = np.concatenate([np.asarray(geo)[:, :, :S], np.asarray(attrs)[:, :, :S]], axis=1)
    before = dict(pack_cuda.pack_rows.layout_launches)
    b = pack_cuda.pack_rows(t_state, t_scene)
    assert pack_cuda.pack_rows.layout_launches == before
    assert a.shape == tuple(b.shape) == (W, pack_cuda.N_ROWS, S)
    b = b.numpy()
    for r in list(range(9)) + list(range(16, 36)):
        _close(a[:, r], b[:, r], f"row {r}")
    np.testing.assert_array_equal(a[:, 31], b[:, 31])  # material ids
    np.testing.assert_array_equal(np.asarray(jrp._pack_rows_planar(j_state, j_scene))[:, 9],
                                  b[:, 9])
    assert not a[:, 9].any() and b[:, 9].any()
    for r in list(range(10, 16)) + list(range(36, 40)):
        assert not a[:, r].any() and not b[:, r].any()
