"""Built-in demo scene: a colored cube and a ground plane per world, one
camera — geometry generated in code, no asset files needed.

The port's copy of ``demo_config``, ``cube_mesh``, ``plane_mesh`` and
``demo_texture_png`` from the JAX package's ``runners/scenes.py`` (the
scenes of the ``bench.py`` rows), for their raw-geometry form, untextured
or with the PNG checkerboard. The KTX2 texture and the disk-asset variant
are ROADMAP Queue 1 item 18. ``terrain_mesh`` and ``bigmesh_config`` copy
``tools/tpu_bigmesh_bench.py``'s big-mesh scene (``bench.py``'s
``bigmesh_512w`` row), a mesh past the resident budget;
``binned_terrain_config`` copies ``tools/tpu_binned_bench.py``'s
100k-triangle terrain, the scene of the tile-binned visit (K4).
"""

from __future__ import annotations

import math
import os
import tempfile
from pathlib import Path
from typing import List

import numpy as np

from .._build import cache_root
from ..config import (
    AdditionalMaterial,
    GeometryConfig,
    ImportedCamera,
    ImportedInstance,
    ManagerConfig,
    RenderConfig,
    RenderMode,
    WorldInit,
)


def cube_mesh(half: float = 0.5):
    """Unit cube: 8 verts expanded to 24 (per-face UVs), 12 tris."""
    faces = []
    uvs = []
    # (axis, sign) for each face
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_axis, v_axis = [(1, 2), (0, 2), (0, 1)][axis]
            corners = []
            for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
                c = [0.0, 0.0, 0.0]
                c[axis] = sign * half
                c[u_axis] = du * half * sign
                c[v_axis] = dv * half
                corners.append(c)
            faces.extend([corners[0], corners[1], corners[2],
                          corners[0], corners[2], corners[3]])
            uvs.extend([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]])
    return np.asarray(faces, np.float32), np.asarray(uvs, np.float32)


def plane_mesh(half: float = 10000.0):
    a, b, c, d = (
        [-half, -half, 0.0],
        [half, -half, 0.0],
        [half, half, 0.0],
        [-half, half, 0.0],
    )
    verts = np.asarray([a, b, c, a, c, d], np.float32)
    uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32)
    return verts, uvs


def _geo_from(meshes: List[np.ndarray], uv_list: List[np.ndarray], mats: List[int]):
    verts = np.concatenate(meshes, axis=0)
    uvs = np.concatenate(uv_list, axis=0)
    counts = [len(v) for v in meshes]
    offs = np.cumsum([0] + counts[:-1]).astype(np.uint32)
    return GeometryConfig(
        vertices=verts,
        uvs=uvs,
        indices=np.concatenate([np.arange(c, dtype=np.uint32) for c in counts]),
        mesh_vertex_offsets=offs,
        mesh_index_offsets=offs.copy(),
        mesh_materials=np.asarray(mats, np.int32),
    )


# Generated demo assets live beside the kernel builds (in a source
# checkout: build/demo_assets/).
ASSET_DIR = cache_root() / "demo_assets"


def _publish_atomic(path: Path, data: bytes) -> None:
    """Write-once publish: concurrent readers never see a partial file."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".mrt_tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def demo_texture_png(size: int = 64) -> str:
    """Generate (once) and return the path of the demo checkerboard
    texture — the textured-scene analog of the reference's cube.png. The
    texels are the JAX package's ``demo_texture_png`` texels."""
    path = ASSET_DIR / f"mrt_demo_checker_{size}.png"
    if not path.exists():
        from ..assets.png import encode_png

        yy, xx = np.mgrid[0:size, 0:size]
        checker = ((yy // 8 + xx // 8) % 2).astype(np.float32)
        img = np.empty((size, size, 4), np.uint8)
        img[..., 0] = (255 * (0.35 + 0.6 * checker)).astype(np.uint8)
        img[..., 1] = (255 * (0.55 - 0.25 * checker)).astype(np.uint8)
        img[..., 2] = (255 * (0.25 + 0.5 * (1 - checker))).astype(np.uint8)
        img[..., 3] = 255
        ASSET_DIR.mkdir(parents=True, exist_ok=True)
        _publish_atomic(path, encode_png(img))
    return str(path)


def _yaw_pitch_quat(yaw: float, pitch: float):
    """(w, x, y, z) for yaw about Z composed with pitch about X."""
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    pc, ps = math.cos(pitch / 2), math.sin(pitch / 2)
    return [cy * pc, cy * ps, sy * ps, sy * pc]


def demo_config(
    num_worlds: int,
    render_mode: RenderMode,
    width: int,
    height: int,
    dynamic: bool = False,
    textured: bool = False,
    tex_size: int = 64,
    tex_format: str = "png",
    from_disk: bool = False,
    num_cams: int = 1,
    **extra,
) -> ManagerConfig:
    """Cube-on-a-plane scene, ``num_cams`` cameras per world (extra cameras
    orbit the cube at distinct yaw offsets), all worlds identical unless
    ``dynamic`` pre-seeds a per-world cube yaw so every world differs from
    step one. ``textured`` maps a generated ``tex_size``² checkerboard PNG
    onto the cube. ``tex_format='ktx2'`` and ``from_disk`` (ROADMAP Queue 1
    item 18) raise."""
    if textured and tex_format != "png":
        raise NotImplementedError(
            f"the {tex_format!r} demo texture is not ported yet (PNG only) — "
            "ROADMAP Queue 1 item 18"
        )
    if from_disk:
        raise NotImplementedError(
            "the disk-asset demo scene is not ported yet — ROADMAP Queue 1 "
            "item 18"
        )
    cube_v, cube_uv = cube_mesh()
    plane_v, plane_uv = plane_mesh()
    geo = _geo_from([cube_v, plane_v], [cube_uv, plane_uv], [0, 1])
    mats = [
        AdditionalMaterial(
            color=(0.9, 0.3, 0.2, 1.0),
            texture_id=0 if textured else -1,
            roughness=0.6,
        ),
        AdditionalMaterial(color=(0.25, 0.3, 0.35, 1.0), texture_id=-1, roughness=0.9),
    ]
    textures = [demo_texture_png(tex_size)] if textured else []
    instances = []
    cameras = []
    worlds = []
    for w in range(num_worlds):
        yaw = (w * 0.37) % (2 * math.pi) if dynamic else 0.0
        qw, qz = math.cos(yaw / 2), math.sin(yaw / 2)
        instances.append(
            ImportedInstance(
                position=[0.0, 0.0, 1.0],
                rotation=[qw, 0.0, 0.0, qz],
                scale=[2.0, 2.0, 2.0],
                object_id=0,
            )
        )
        instances.append(
            ImportedInstance(
                position=[0.0, 0.0, 0.0],
                rotation=[1.0, 0.0, 0.0, 0.0],
                scale=[1.0, 1.0, 1.0],
                object_id=1,
            )
        )
        # Camera north of the cube looking back (-Y), slightly above and
        # pitched down — this side faces the default light.
        pitch = -0.18
        ps, pc = math.sin(pitch / 2), math.cos(pitch / 2)
        cameras.append(
            ImportedCamera(
                position=[0.0, 8.0, 3.0],
                rotation=[0.0, 0.0, ps, pc],
            )
        )
        for c in range(1, num_cams):
            yaw_c = math.pi + c * (2 * math.pi / num_cams) + 0.19 * c
            cameras.append(
                ImportedCamera(
                    position=[8.0 * math.sin(yaw_c),
                              -8.0 * math.cos(yaw_c),
                              3.0 + 0.4 * c],
                    rotation=_yaw_pitch_quat(yaw_c, pitch),
                )
            )
        worlds.append(
            WorldInit(
                num_instances=2,
                instance_offset=2 * w,
                num_cameras=num_cams,
                camera_offset=num_cams * w,
            )
        )
    return ManagerConfig(
        gpu_id=0,
        num_worlds=num_worlds,
        render_mode=render_mode,
        batch_render_view_width=width,
        batch_render_view_height=height,
        headless_mode=True,
        rcfg=RenderConfig(
            geo_cfg=geo,
            additional_mats=mats,
            additional_textures=textures,
            instances=instances,
            cameras=cameras,
            worlds=worlds,
        ),
        **extra,
    )


def renderer_kwargs(cfg: ManagerConfig) -> dict:
    """A config's scene as ``MadronaRenderer`` keyword arguments (the
    reference binding's mesh_* / materials / instances / cameras / worlds)."""
    geo, rcfg = cfg.rcfg.geo_cfg, cfg.rcfg
    return dict(
        mesh_vertices=geo.vertices,
        mesh_uvs=geo.uvs,
        mesh_indices=geo.indices,
        mesh_vertex_offsets=geo.mesh_vertex_offsets,
        mesh_indices_offsets=geo.mesh_index_offsets,
        mesh_materials=geo.mesh_materials,
        materials=list(rcfg.additional_mats),
        texture_paths=list(rcfg.additional_textures),
        instances=list(rcfg.instances),
        cameras=list(rcfg.cameras),
        worlds=list(rcfg.worlds),
    )


def terrain_mesh(n: int = 72, extent: float = 40.0, amp: float = 1.5) -> np.ndarray:
    """``tools/tpu_bigmesh_bench.py``'s heightfield terrain: an n x n grid of
    quads over [-extent, extent]², 2·n² triangles ``[6n², 3]`` f32."""
    xs = np.linspace(-extent, extent, n + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = amp * (np.sin(gx * 0.3) * np.cos(gy * 0.23) + 0.3 * np.sin(gy * 0.7))
    v = np.stack([gx, gy, gz], axis=-1).astype(np.float32)
    a, b, c, d = v[:-1, :-1], v[1:, :-1], v[1:, 1:], v[:-1, 1:]
    return np.stack([a, b, c, a, c, d], axis=2).reshape(-1, 3)


def bigmesh_config(num_worlds: int, width: int = 64, height: int = 64,
                   grid: int = 72, texture: str | None = None, **extra) -> ManagerConfig:
    """``bench.py``'s ``bigmesh_512w`` scene (``tools/tpu_bigmesh_bench.py``
    :44-90): per world the ``grid``² terrain (10,368 triangles at 72) at the
    origin and the cube scaled 2 at (0, 0, 2.5), one camera at (0, 14, 6)
    pitched -0.25, raytraced. With a ``texture`` (an image path) the
    terrain's uvs are its xy / 8 and its material samples the texture."""
    terrain = terrain_mesh(grid)
    cube_v, _ = cube_mesh()
    uvs = [terrain[:, :2] / 8.0 if texture else np.zeros((len(terrain), 2), np.float32),
           np.zeros((len(cube_v), 2), np.float32)]
    geo = _geo_from([terrain, cube_v], uvs, [0, 1])
    mats = [AdditionalMaterial(color=(0.35, 0.5, 0.3, 1.0), texture_id=0 if texture else -1),
            AdditionalMaterial(color=(0.9, 0.3, 0.2, 1.0))]
    ps, pc = math.sin(-0.25 / 2), math.cos(-0.25 / 2)
    instances, cameras, worlds = [], [], []
    for w in range(num_worlds):
        instances.append(ImportedInstance(position=[0, 0, 0], rotation=[1, 0, 0, 0],
                                          scale=[1, 1, 1], object_id=0))
        instances.append(ImportedInstance(position=[0, 0, 2.5], rotation=[1, 0, 0, 0],
                                          scale=[2, 2, 2], object_id=1))
        cameras.append(ImportedCamera(position=[0.0, 14.0, 6.0], rotation=[0.0, 0.0, ps, pc]))
        worlds.append(WorldInit(num_instances=2, instance_offset=2 * w, num_cameras=1,
                                camera_offset=w))
    return ManagerConfig(
        gpu_id=0, num_worlds=num_worlds, render_mode=RenderMode.Raytracer,
        batch_render_view_width=width, batch_render_view_height=height,
        headless_mode=True,
        rcfg=RenderConfig(geo_cfg=geo, additional_mats=mats,
                          additional_textures=[texture] if texture else [],
                          instances=instances, cameras=cameras, worlds=worlds),
        **extra,
    )


def binned_terrain_config(num_worlds: int, width: int, height: int, grid: int = 224,
                          texture: str | None = None, **extra) -> ManagerConfig:
    """``tools/tpu_binned_bench.py``'s scene (:37-88, also ``bench.py``'s
    health anchor, :505-546): per world the ``grid``² sine terrain over
    [-24, 24]² with amplitude 2 (100,352 triangles at 224) at the origin,
    colour (0.35, 0.5, 0.3), and one camera at (0, 20, 8) with rotation
    (0, 0, sin(-0.175), cos(-0.175)), raytraced. With a ``texture`` (an
    image path) the terrain's uvs are its xy / 8 and it samples the
    texture."""
    terrain = terrain_mesh(grid, extent=24.0, amp=2.0)
    uvs = terrain[:, :2] / 8.0 if texture else np.zeros((len(terrain), 2), np.float32)
    geo = _geo_from([terrain], [uvs], [0])
    ps, pc = math.sin(-0.35 / 2), math.cos(-0.35 / 2)
    instances, cameras, worlds = [], [], []
    for w in range(num_worlds):
        instances.append(ImportedInstance(position=[0, 0, 0], rotation=[1, 0, 0, 0],
                                          scale=[1, 1, 1], object_id=0))
        cameras.append(ImportedCamera(position=[0.0, 20.0, 8.0], rotation=[0.0, 0.0, ps, pc]))
        worlds.append(WorldInit(num_instances=1, instance_offset=w, num_cameras=1,
                                camera_offset=w))
    return ManagerConfig(
        gpu_id=0, num_worlds=num_worlds, render_mode=RenderMode.Raytracer,
        batch_render_view_width=width, batch_render_view_height=height,
        headless_mode=True,
        rcfg=RenderConfig(geo_cfg=geo,
                          additional_mats=[AdditionalMaterial(color=(0.35, 0.5, 0.3, 1.0),
                                                              texture_id=0 if texture else -1)],
                          additional_textures=[texture] if texture else [],
                          instances=instances, cameras=cameras, worlds=worlds),
        **extra,
    )
