"""PyTorch port: asset import + scene bake + state init == the JAX package's.

Every field must be bitwise equal (the port keeps the JAX bake's numpy body
term for term), including tris_per_object and the cluster arrays; the
numpy hand-over (``convert``) must round-trip.
"""

import dataclasses

import numpy as np
import pytest

from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.runners.scenes import demo_config
from madrona_renderer_tpu_torch import convert
from madrona_renderer_tpu_torch.core.scene import SceneData as TSceneData
from madrona_renderer_tpu_torch.core.state import SimState as TSimState

from tests.torch_helpers import (
    carry_over, random_spec, spec_from_config, terrain_spec, to_numpy,
)

SPECS = {
    "demo3_dynamic": lambda: spec_from_config(
        demo_config(3, RenderMode.Raytracer, 64, 64, dynamic=True)),
    "random5": lambda: random_spec(5, n_worlds=2),
    "random9": lambda: random_spec(9, n_worlds=3),
    # bench.py's bigmesh scene: a streamed bake (t_pad rounded to 128,
    # 32-triangle clusters).
    "terrain72": lambda: terrain_spec(n_worlds=2, grid=72),
}


def _assert_bitwise(jx, tx):
    jd = to_numpy(jx)
    for f in dataclasses.fields(tx):
        a = jd[f.name]
        b = getattr(tx, f.name)
        if f.name == "fb_rows":
            assert a == b
            continue
        b = b.numpy()
        assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f.name


@pytest.mark.parametrize("name", sorted(SPECS))
def test_bake_and_state_bitwise(name):
    spec = SPECS[name]()
    j_state, j_scene = spec.build_jax()
    t_state, t_scene = spec.build_torch()
    _assert_bitwise(j_scene, t_scene)
    _assert_bitwise(j_state, t_state)
    assert t_scene.tris_per_object == j_scene.tris_per_object
    assert t_scene.cl_valid.shape == tuple(j_scene.cl_valid.shape)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_convert_round_trip(name):
    spec = SPECS[name]()
    j_state, j_scene = spec.build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    assert isinstance(t_state, TSimState) and isinstance(t_scene, TSceneData)
    _assert_bitwise(j_scene, t_scene)
    _assert_bitwise(j_state, t_state)
    # port → numpy → port is the identity.
    again = convert.scene_from_numpy(convert.to_numpy(t_scene))
    _assert_bitwise(j_scene, again)
    again = convert.state_from_numpy(convert.to_numpy(t_state))
    _assert_bitwise(j_state, again)


def test_streamed_bake_pads_and_clusters():
    """The terrain's object (10,368 triangles) is past the resident budget:
    the bake pads it to a multiple of 128 and cuts 32-triangle clusters,
    their valid-prefix counts ending where the triangles do."""
    t_state, t_scene = SPECS["terrain72"]().build_torch()
    assert t_scene.tris_per_object == 10368 and t_scene.tris_per_object % 128 == 0
    assert t_scene.cl_valid.shape[1] * 32 == t_scene.tris_per_object
    counts = t_scene.cl_count[0].numpy()
    assert (counts == 32).all() and int(t_scene.cl_count[1].sum()) == 12
    assert int(t_scene.cl_valid.sum()) == 324 + 1


def test_convert_rejects_mismatched_tris_per_object():
    j_state, j_scene = SPECS["random5"]().build_jax()
    d = to_numpy(j_scene)
    d["tris_per_object"] += 8
    with pytest.raises(ValueError, match="tris_per_object"):
        convert.scene_from_numpy(d)
