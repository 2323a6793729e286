"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Scenes are described once, built through both packages' real import /
bake / state code, and handed from the JAX package to the port as numpy
arrays (``madrona_renderer_tpu_torch.convert``), so both render the very
same state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

import madrona_renderer_tpu.config as jcfg
import madrona_renderer_tpu_torch.config as tcfg
from madrona_renderer_tpu.assets.importer import load_render_assets as j_load
from madrona_renderer_tpu.core.scene import bake_scene as j_bake
from madrona_renderer_tpu.core.state import init_state as j_init
from madrona_renderer_tpu_torch.assets.importer import load_render_assets as t_load
from madrona_renderer_tpu_torch.convert import scene_from_numpy, state_from_numpy
from madrona_renderer_tpu_torch.core.scene import bake_scene as t_bake
from madrona_renderer_tpu_torch.core.state import init_state as t_init
from madrona_renderer_tpu.runners.scenes import cube_mesh
from tools.tpu_bigmesh_bench import terrain_mesh


@contextlib.contextmanager
def one_thread():
    """torch's CPU ops on one thread inside the block: the walk replays
    (``ops/walk_replay.py``) issue thousands of small ops, which an intra-op
    thread pool slows several-fold when other test workers load the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def to_numpy(x) -> dict:
    """A JAX ``SceneData`` / ``SimState`` as the dict ``convert`` takes."""
    d = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        d[f.name] = v if isinstance(v, int) else np.asarray(v)
    if hasattr(x, "tris_per_object"):
        d["tris_per_object"] = x.tris_per_object
    return d


def carry_over(state, scene, device="cpu"):
    """JAX (state, scene) → the port's (state, scene) on ``device``."""
    return (state_from_numpy(to_numpy(state), device),
            scene_from_numpy(to_numpy(scene), device))


@dataclasses.dataclass
class SceneSpec:
    """A scene in plain values, buildable through either package."""

    meshes: list  # [V, 3] float vertex arrays, V//3 triangles each
    instances: list  # dicts of ImportedInstance fields
    cameras: list  # dicts of ImportedCamera fields
    worlds: list  # dicts of WorldInit fields
    materials: list = dataclasses.field(default_factory=list)  # colors
    mesh_materials: list = None
    uvs: list = None  # [V, 2] per mesh (zeros when None)
    textures: list = dataclasses.field(default_factory=list)  # PNG paths
    material_textures: list = None  # texture id per material (-1 none)

    def _geo(self, cfg):
        verts = np.concatenate([np.asarray(m, np.float32) for m in self.meshes])
        counts = [len(m) for m in self.meshes]
        offs = np.cumsum([0] + counts[:-1]).astype(np.uint32)
        mats = (np.full(len(self.meshes), -1, np.int32)
                if self.mesh_materials is None
                else np.asarray(self.mesh_materials, np.int32))
        uvs = (np.zeros((verts.shape[0], 2), np.float32) if self.uvs is None
               else np.concatenate([np.asarray(u, np.float32) for u in self.uvs]))
        return cfg.GeometryConfig(
            vertices=verts,
            uvs=uvs,
            indices=np.concatenate([np.arange(c, dtype=np.uint32) for c in counts]),
            mesh_vertex_offsets=offs,
            mesh_index_offsets=offs.copy(),
            mesh_materials=mats,
        )

    def _parts(self, cfg):
        tex = self.material_textures or [-1] * len(self.materials)
        return (
            self._geo(cfg),
            [cfg.AdditionalMaterial(color=tuple(c), texture_id=int(t))
             for c, t in zip(self.materials, tex)],
            [cfg.ImportedInstance(**i) for i in self.instances],
            [cfg.ImportedCamera(**c) for c in self.cameras],
            [cfg.WorldInit(**w) for w in self.worlds],
        )

    def build_jax(self):
        geo, mats, insts, cams, worlds = self._parts(jcfg)
        scene = j_bake(j_load(geo, [], mats, list(self.textures)))
        return j_init(insts, cams, worlds), scene

    def build_torch(self, device="cpu"):
        geo, mats, insts, cams, worlds = self._parts(tcfg)
        scene = t_bake(t_load(geo, [], mats, list(self.textures)), device)
        return t_init(insts, cams, worlds, device), scene


def spec_from_config(cfg) -> SceneSpec:
    """A ManagerConfig's raw-geometry scene (e.g. ``demo_config``) as a
    SceneSpec."""
    r = cfg.rcfg
    g = r.geo_cfg
    verts = np.asarray(g.vertices, np.float32)
    uvs = np.asarray(g.uvs, np.float32)
    offs = list(np.asarray(g.mesh_vertex_offsets, np.int64)) + [len(verts)]
    return SceneSpec(
        meshes=[verts[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)],
        uvs=[uvs[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)],
        textures=list(r.additional_textures),
        material_textures=[m.texture_id for m in r.additional_mats],
        instances=[dataclasses.asdict(i) for i in r.instances],
        cameras=[dataclasses.asdict(c) for c in r.cameras],
        worlds=[dataclasses.asdict(w) for w in r.worlds],
        materials=[tuple(m.color) for m in r.additional_mats],
        mesh_materials=list(np.asarray(g.mesh_materials)),
    )


IDENTITY = [1.0, 0.0, 0.0, 0.0]


def quad_xz(half, y=0.0):
    """Two triangles forming a quad in the XZ plane at ``y``, spanning
    [-half, half]² — a wall facing a camera that looks +Y."""
    a, b, c, d = [-half, y, -half], [half, y, -half], [half, y, half], [-half, y, half]
    return np.asarray([a, b, c, a, c, d], np.float32)


def quad_uvs(scale=1.0, shift=0.0):
    """UVs in ``quad_xz``'s corner order: u right (+x), v up (+z)."""
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
    return uv * scale + shift


def gradient_image(size=256):
    """tests/test_mips.py's smooth RGBA gradient texture."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    return np.stack([xx * 255, yy * 255, (xx + yy) * 127.5, np.full_like(xx, 255)],
                    axis=-1).astype(np.uint8)


def checker_image(size=256, cell=4):
    """tests/test_mips.py's black-and-white checker texture."""
    yy, xx = np.mgrid[0:size, 0:size]
    c = ((yy // cell + xx // cell) % 2).astype(np.uint8) * 255
    return np.stack([c, c, c, np.full_like(c, 255)], axis=-1)


def mip_spec(tex_path, uv_scale=7.3, extra_mesh=None, n_worlds=1, num_cams=1):
    """tests/test_mips.py's ``_scene``: a 120-unit textured floor 10 units
    ahead of a camera at the origin, uvs tiled ``uv_scale`` times, and an
    optional untextured extra mesh; with ``num_cams`` > 1, more cameras per
    world beside the first, turned a little."""
    meshes, uvs, mesh_mats = [quad_xz(60.0, 0.0)], [quad_uvs(uv_scale)], [0]
    instances = [dict(position=[0, 10, 0], rotation=IDENTITY, scale=[1, 1, 1],
                      object_id=0)]
    if extra_mesh is not None:
        meshes.append(extra_mesh)
        uvs.append(np.zeros((len(extra_mesh), 2), np.float32))
        mesh_mats.append(1)
        instances.append(dict(position=[0, 0, 0], rotation=IDENTITY,
                              scale=[1, 1, 1], object_id=1))
    cameras = [dict(position=[0.0, 0.0, 0.0], rotation=IDENTITY)]
    for c in range(1, num_cams):
        yaw = 0.15 * c
        cameras.append(dict(position=[0.7 * c, -0.5 * c, 0.3 * c],
                            rotation=[float(np.cos(yaw / 2)), 0.0, 0.0,
                                      float(np.sin(yaw / 2))]))
    n_inst = len(instances)
    return SceneSpec(
        meshes=meshes, uvs=uvs, mesh_materials=mesh_mats,
        instances=instances * n_worlds,
        cameras=cameras * n_worlds,
        worlds=[dict(num_instances=n_inst, instance_offset=n_inst * w,
                     num_cameras=num_cams, camera_offset=num_cams * w)
                for w in range(n_worlds)],
        materials=[(1, 1, 1, 1), (0.9, 0.4, 0.3, 1.0)],
        textures=[tex_path], material_textures=[0, -1],
    )


def two_quad_spec(tex_path, close_uv_lo, close_uv_hi):
    """tests/test_mips.py's ``_two_quad_scene``: a far floor with uvs tiled
    40 times behind a close-up quad whose uvs span [lo, hi], both textured
    with the same material."""
    span = close_uv_hi - close_uv_lo
    return SceneSpec(
        meshes=[quad_xz(60.0, 0.0), quad_xz(2.5, 4.0)],
        uvs=[quad_uvs(40.0), quad_uvs(span, close_uv_lo)],
        mesh_materials=[0, 0],
        instances=[dict(position=[0, 10, 0], rotation=IDENTITY, scale=[1, 1, 1],
                        object_id=0),
                   dict(position=[0, 0, 0], rotation=IDENTITY, scale=[1, 1, 1],
                        object_id=1)],
        cameras=[dict(position=[0, 0, 0], rotation=IDENTITY)],
        worlds=[dict(num_instances=2, instance_offset=0, num_cameras=1,
                     camera_offset=0)],
        materials=[(1, 1, 1, 1)], textures=[tex_path], material_textures=[0],
    )


def _unit(v):
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v)).tolist()


def random_spec(seed: int, n_worlds: int = 1) -> SceneSpec:
    """Random triangles, instances and one camera per world (the generator
    of tests/test_pallas_parity.py::test_parity_random_scenes, with one
    camera per world — the slice's scenes)."""
    rng = np.random.default_rng(seed)
    n_meshes = int(rng.integers(1, 4))
    meshes = [
        (rng.normal(size=(int(rng.integers(1, 7)) * 3, 3)) * 5).astype(np.float32)
        for _ in range(n_meshes)
    ]
    n_inst = int(rng.integers(1, 5))
    instances, cameras, worlds = [], [], []
    for w in range(n_worlds):
        for _ in range(n_inst):
            instances.append(dict(
                position=rng.normal(size=3).tolist(),
                rotation=_unit(rng.normal(size=4)),
                scale=rng.uniform(0.5, 2.0, size=3).tolist(),
                object_id=int(rng.integers(0, n_meshes)),
            ))
        cameras.append(dict(
            position=(rng.normal(size=3) * 3 + [0, -12, 0]).tolist(),
            rotation=_unit(rng.normal(size=4) * 0.2 + [1, 0, 0, 0]),
        ))
        worlds.append(dict(num_instances=n_inst, instance_offset=n_inst * w,
                           num_cameras=1, camera_offset=w))
    return SceneSpec(meshes, instances, cameras, worlds)


def terrain_spec(n_worlds=2, rotated=False, num_cams=1, grid=40):
    """tools/tpu_bigmesh_bench.py's scene at a ``grid``² terrain (40: 3,200
    terrain triangles, S = 6,400 per world): the terrain and the cube scaled 2,
    one camera at (0, 14, 6) pitched -0.25; ``rotated`` turns each world's
    terrain by a random quaternion, and extra cameras stand 1.5 apart."""
    rng = np.random.default_rng(3)
    ps, pc = math.sin(-0.125), math.cos(-0.125)
    insts, cams, worlds = [], [], []
    for w in range(n_worlds):
        rot = IDENTITY
        if rotated:
            q = rng.normal(size=4)
            rot = (q / np.linalg.norm(q)).tolist()
        insts += [dict(position=[0, 0, 0], rotation=list(rot), scale=[1, 1, 1], object_id=0),
                  dict(position=[0.3 * w, 0, 2.5], rotation=IDENTITY, scale=[2, 2, 2],
                       object_id=1)]
        cams += [dict(position=[1.5 * c, 14.0, 6.0], rotation=[0.0, 0.0, ps, pc])
                 for c in range(num_cams)]
        worlds.append(dict(num_instances=2, instance_offset=2 * w, num_cameras=num_cams,
                           camera_offset=num_cams * w))
    return SceneSpec(meshes=[terrain_mesh(grid), cube_mesh()[0]], instances=insts,
                     cameras=cams, worlds=worlds,
                     materials=[(0.35, 0.5, 0.3, 1.0), (0.9, 0.3, 0.2, 1.0)],
                     mesh_materials=[0, 1])


def assert_frames_close(ref, port):
    """The parity bar of tests/test_pallas_parity.py:21-31: rgb within ±1
    LSB, depth rtol = atol = 1e-5, segmask exact."""
    rgb_a = np.asarray(ref.rgb).astype(np.int16)
    rgb_b = port.rgb.cpu().numpy().astype(np.int16)
    assert rgb_a.shape == rgb_b.shape
    diff = np.abs(rgb_a - rgb_b)
    assert diff.max() <= 1, f"rgb diff {diff.max()}"
    np.testing.assert_allclose(
        np.asarray(ref.depth), port.depth.cpu().numpy(), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(ref.segmask),
                                  port.segmask.cpu().numpy())
