"""PyTorch port: frames == the JAX package's, on the very same state.

The port's ``raytrace`` (the plain PyTorch version of kernel K1 on the CPU)
against both JAX paths: the Pallas kernel in interpret mode and the jnp
reference. The bar is tests/test_pallas_parity.py's: rgb within ±1 LSB,
depth rtol = atol = 1e-5, segmask exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu.runners.scenes import demo_config
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc

from tests.torch_helpers import (
    IDENTITY, SceneSpec, assert_frames_close, carry_over, quad_xz, random_spec,
    spec_from_config,
)


def _cloud_spec():
    """A 300-triangle cloud in front of a wall: 38 clusters per world."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(-8, 8, size=(300, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(5, 30, size=300)
    tris = []
    for c in centers:
        tris += [c + rng.normal(size=3) * 0.5 for _ in range(3)]
    return SceneSpec(
        meshes=[np.asarray(tris, np.float32), quad_xz(50.0)],
        instances=[
            dict(position=[0, 0, 0], rotation=IDENTITY, object_id=0),
            dict(position=[0, 35, 0], rotation=IDENTITY, object_id=1),
        ],
        cameras=[dict(position=[0, 0, 0], rotation=IDENTITY)],
        worlds=[dict(num_instances=2, instance_offset=0, num_cameras=1,
                     camera_offset=0)],
        materials=[(0.7, 0.4, 0.2, 1.0)],
        mesh_materials=[0, -1],
    )


def _fov_znear_spec():
    """Three worlds, one camera each, with their own fov / znear."""
    insts = [
        dict(position=[0, 10, 0], rotation=IDENTITY, object_id=0),
        dict(position=[1, 4, 1], rotation=IDENTITY, scale=[0.2, 1, 0.2], object_id=0),
    ]
    return SceneSpec(
        meshes=[quad_xz(8.0)],
        instances=insts * 3,
        cameras=[
            dict(position=[0, 0, 0], rotation=IDENTITY),
            dict(position=[0, 0, 0], rotation=IDENTITY, fov_y_degrees=45.0, znear=5.0),
            dict(position=[0, -3, 0], rotation=IDENTITY, fov_y_degrees=120.0),
        ],
        worlds=[dict(num_instances=2, instance_offset=2 * w, num_cameras=1,
                     camera_offset=w) for w in range(3)],
    )


def _invalid_camera_spec():
    """World 1 has no camera: its slot renders black/0/-1."""
    spec = random_spec(21, n_worlds=3)
    spec.worlds[1]["num_cameras"] = 0
    return spec


CASES = {
    "demo4_dynamic_64": (lambda: spec_from_config(
        demo_config(4, RenderMode.Raytracer, 64, 64, dynamic=True)), 64, 64),
    "random0_32": (lambda: random_spec(0, n_worlds=2), 32, 32),
    "random1_32": (lambda: random_spec(1, n_worlds=2), 32, 32),
    "random2_32": (lambda: random_spec(2, n_worlds=2), 32, 32),
    "clusters38_32": (_cloud_spec, 32, 32),
    "fov_znear_48x64": (_fov_znear_spec, 48, 64),
    "invalid_camera_32": (_invalid_camera_spec, 32, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_raytrace_matches_jax(case):
    make, height, width = CASES[case]
    j_state, j_scene = make().build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    port = trc.raytrace(t_state, t_scene, height=height, width=width)
    ref = j_ref(j_state, j_scene, height=height, width=width)
    assert_frames_close(ref, port)
    pal = j_pallas(j_state, j_scene, height=height, width=width, interpret=True)
    assert_frames_close(pal, port)
    # The scene really renders something, and the fused export shapes hold.
    seg = port.segmask.numpy()
    assert (seg >= 0).any()
    assert port.rgb.shape == (*seg.shape, 4)
    if case == "invalid_camera_32":
        assert (seg[1] == -1).all() and (port.depth.numpy()[1] == 0).all()
        rgb = port.rgb.numpy()[1]
        assert (rgb[..., :3] == 0).all() and (rgb[..., 3] == 255).all()
    if case == "clusters38_32":
        assert t_scene.cl_valid.shape[1] * 2 >= 4
        assert set(np.unique(seg)) >= {0, 1}


def test_two_lights_and_unaligned_size_match_jax():
    """Two directional lights (the light sum and the wider camera row) at a
    size that is not a multiple of the kernel's 16×16 block."""
    from madrona_renderer_tpu.core.scene import configure_lighting as j_light
    from madrona_renderer_tpu_torch.core.scene import configure_lighting as t_light

    lights = [((1.0, -1.0, -0.05), (0.7, 0.7, 0.7)),
              ((-0.3, 0.2, -1.0), (0.3, 0.25, 0.2))]
    j_state, j_scene = spec_from_config(
        demo_config(3, RenderMode.Raytracer, 24, 40, dynamic=True)).build_jax()
    j_scene = j_light(j_scene, lights=lights)
    t_state, t_scene = carry_over(j_state, j_scene)
    relit = t_light(t_scene, lights=lights)
    assert np.array_equal(relit.light_dir.numpy(), np.asarray(j_scene.light_dir))
    assert np.array_equal(relit.light_color.numpy(), np.asarray(j_scene.light_color))
    port = trc.raytrace(t_state, relit, height=40, width=24)
    assert_frames_close(j_ref(j_state, j_scene, height=40, width=24), port)
    assert_frames_close(
        j_pallas(j_state, j_scene, height=40, width=24, interpret=True), port)


def test_unsupported_scenes_raise():
    """Scenes outside the slice raise NotImplementedError naming their item;
    a world with two cameras, which raised until item 7 was ported, renders
    like the JAX package, and so does a texel pool past the in-kernel
    route's 128×128 texels, which raised until the 9-output route was
    ported (its frames: the JAX package's 9-output route's), on the index
    sweep and, with 4+ clusters a world, on the ordered visit (K3 on
    resident rows), which raised until that visit's 9-output mode was
    ported."""
    import dataclasses

    spec = random_spec(3)
    spec.cameras.append(dict(spec.cameras[0], position=[0.5, -11.0, 1.0]))
    spec.worlds[0]["num_cameras"] = 2
    j_state, j_scene = spec.build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    port = trc.raytrace(t_state, t_scene, height=16, width=16)
    assert port.depth.shape == (1, 2, 16, 16)
    assert_frames_close(j_ref(j_state, j_scene, height=16, width=16), port)
    # A texel pool past the in-kernel route's 128×128 texels.
    j_state, j_scene = random_spec(3).build_jax()
    j_textured = dataclasses.replace(
        j_scene, tex_data=jnp.tile(j_scene.tex_data, (128 * 128 + 1, 1)))
    t_state, textured = carry_over(j_state, j_textured)
    assert trc.pack_inputs(t_state, textured, height=16, width=16)["texture"] == "nine"
    port = trc.raytrace(t_state, textured, height=16, width=16)
    assert_frames_close(j_pallas(j_state, j_textured, height=16, width=16, interpret=True),
                        port)
    big = spec_from_config(demo_config(2, RenderMode.Raytracer, 16, 16))
    big.meshes[0] = np.concatenate([big.meshes[0]] * 40)
    big.uvs[0] = np.concatenate([big.uvs[0]] * 40)
    j_state, j_scene = big.build_jax()
    j_textured = dataclasses.replace(
        j_scene, tex_data=jnp.tile(j_scene.tex_data, (128 * 128 + 1, 1)))
    b_state, b_textured = carry_over(j_state, j_textured)
    assert trc.visit_route(b_state, b_textured, 16, 16).visit == "ordered"
    kw = trc.pack_inputs(b_state, b_textured, height=16, width=16)
    assert kw["texture"] == "nine" and kw["order"] is not None
    port = trc.raytrace(b_state, b_textured, height=16, width=16)
    assert_frames_close(j_ref(j_state, j_textured, height=16, width=16), port)
