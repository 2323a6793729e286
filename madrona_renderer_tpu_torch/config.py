"""User-facing configuration types.

These mirror the reference Manager's config surface 1:1 in field naming and
semantics (reference ``src/mgr.hpp:36-88`` ``Manager::{GeometryConfig,
Config}`` and the value types bound in ``src/bindings.cpp:26-102``), expressed
as plain Python dataclasses — a copy of the JAX package's ``config.py``
with the PyTorch port's two differences in ``ManagerConfig`` (``device``
added, ``impl`` fixed at ``"auto"``). Everything here is *static*
configuration fixed at Manager construction: the Manager resolves every
flag once, in its constructor, like the reference, which compiles its
executor once (``src/mgr.cpp:453-492``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


class RenderMode(enum.Enum):
    """Which render backend produces the per-camera images.

    Mirrors ``Manager::RenderMode`` (reference ``src/mgr.hpp:31-34``).
    """

    Rasterizer = 0
    Raytracer = 1


@dataclass
class ImportedAsset:
    """A mesh asset loaded from disk plus an optional material override.

    Mirrors ``madRender::ImportedAsset`` (reference ``src/mgr.hpp:16-21``).
    ``mat_id`` indexes into the additional-materials list; -1 keeps the
    materials declared by the asset file itself (e.g. .mtl).
    """

    path: str
    mat_id: int = -1


@dataclass
class AdditionalMaterial:
    """Material record, one row of the material table.

    Mirrors ``madrona::imp::SourceMaterial`` as bound in the reference
    (``src/bindings.cpp:38-54``): RGBA base color, texture index (-1 = none,
    relative to the additional-textures list), roughness, metalness.
    """

    color: Sequence[float] = (1.0, 1.0, 1.0, 1.0)
    texture_id: int = -1
    roughness: float = 0.8
    metalness: float = 0.2


@dataclass
class ImportedInstance:
    """One static-geometry instance: TRS transform + object id.

    Mirrors ``madRender::ImportedInstance`` (reference ``src/sim.hpp:31-36``;
    bound at ``src/bindings.cpp:56-72``). ``rotation`` is (w, x, y, z).
    Object ids are ordered disk assets first, then raw meshes (reference
    ``scripts/test.py:7-9``).
    """

    position: Sequence[float]
    rotation: Sequence[float]
    scale: Sequence[float] = (1.0, 1.0, 1.0)
    object_id: int = 0


@dataclass
class ImportedCamera:
    """One camera: position + orientation quaternion (w, x, y, z).

    Mirrors ``madRender::ImportedCamera`` (reference ``src/sim.hpp:45-48``).
    The reference creates every view with fixed fov=90°, znear=1e-3
    (``attachEntityToView``, reference ``src/sim.cpp:168-171``); here both
    generalize to per-camera state. The defaults of 0.0 mean "inherit the
    render-call / mode default" (fov 90°; znear 0.1 raytrace, 1e-3 raster),
    which reproduces reference behavior exactly.
    """

    position: Sequence[float]
    rotation: Sequence[float]
    fov_y_degrees: float = 0.0  # 0 → inherit render-call fov
    znear: float = 0.0  # 0 → inherit mode default near plane


@dataclass
class WorldInit:
    """Which slice of the shared instance/camera arrays a world owns.

    Mirrors ``Sim::WorldInit`` (reference ``src/sim.hpp:76-82``). Worlds may
    alias the same slices (the reference smoke test points all 4 worlds at
    offset 0 — ``scripts/test.py:61-67``); in that case each world gets its
    own *copy* that then evolves independently, because per-world entities
    are initialized by copying from the shared array
    (reference ``src/sim.cpp:146-175``).
    """

    num_instances: int
    instance_offset: int
    num_cameras: int
    camera_offset: int


@dataclass
class GeometryConfig:
    """Raw in-memory mesh geometry (SoA), the "manual geometry" input path.

    Mirrors ``Manager::GeometryConfig`` (reference ``src/mgr.hpp:36-47``):
    flat vertex/uv/index pools plus per-mesh offsets and material ids. Mesh i
    owns vertices [offset[i], offset[i+1]) (last mesh runs to the end), same
    for indices — the slicing rule of ``importRawGeometry``
    (reference ``src/mgr.cpp:220-231``).
    """

    vertices: np.ndarray  # float32 [num_vertices, 3]
    uvs: np.ndarray  # float32 [num_vertices, 2]
    indices: np.ndarray  # uint32 [num_indices]
    mesh_vertex_offsets: np.ndarray  # uint32 [num_meshes]
    mesh_index_offsets: np.ndarray  # uint32 [num_meshes]
    mesh_materials: np.ndarray  # int32 [num_meshes], -1 = no material

    @property
    def num_meshes(self) -> int:
        return int(len(self.mesh_vertex_offsets))

    @staticmethod
    def empty() -> "GeometryConfig":
        return GeometryConfig(
            vertices=np.zeros((0, 3), np.float32),
            uvs=np.zeros((0, 2), np.float32),
            indices=np.zeros((0,), np.uint32),
            mesh_vertex_offsets=np.zeros((0,), np.uint32),
            mesh_index_offsets=np.zeros((0,), np.uint32),
            mesh_materials=np.zeros((0,), np.int32),
        )


@dataclass
class RenderConfig:
    """Aggregated scene description handed to the Manager.

    Mirrors ``Manager::Config::RenderConfig`` (reference ``src/mgr.hpp:64-87``).
    """

    geo_cfg: GeometryConfig = field(default_factory=GeometryConfig.empty)
    asset_paths: Sequence[ImportedAsset] = ()
    additional_mats: Sequence[AdditionalMaterial] = ()
    additional_textures: Sequence[str] = ()
    instances: Sequence[ImportedInstance] = ()
    cameras: Sequence[ImportedCamera] = ()
    worlds: Sequence[WorldInit] = ()


@dataclass
class ManagerConfig:
    """Top-level Manager configuration.

    Mirrors ``Manager::Config`` (reference ``src/mgr.hpp:49-88``). ``gpu_id``
    selects the card (``cuda:{gpu_id}``); ``-1`` or an out-of-range id falls
    back to ``cuda:0``. ``device`` names the torch device explicitly
    (``"cpu"`` runs the kernels' plain PyTorch versions, as the tests do);
    ``None`` means the card, and construction raises when there is none.

    Divergence from the reference (documented, intentional): the raytracer
    honors ``batch_render_view_height`` instead of silently rendering a
    square ``width``×``width`` image (reference quirk at
    ``src/mgr.cpp:130,443`` where the raycast resolution is taken from the
    width only).
    """

    gpu_id: int = 0
    num_worlds: int = 1
    render_mode: RenderMode = RenderMode.Raytracer
    batch_render_view_width: int = 64
    batch_render_view_height: int = 64
    headless_mode: bool = False
    rcfg: RenderConfig = field(default_factory=RenderConfig)

    # Raytracer clip range, fixed in the reference at executor build time
    # (src/mgr.cpp:476-478).
    near_plane: float = 0.1
    far_plane: float = 1000.0

    # Rasterizer view defaults from attachEntityToView (src/sim.cpp:168-171).
    fov_y_degrees: float = 90.0
    raster_near_plane: float = 0.001

    # Torch device; None = cuda:{gpu_id} (never a silent CPU fallback).
    device: Optional[str] = None
    # Kept for signature compatibility with the JAX package: the port picks
    # its implementation from the device (CUDA kernel on the card, plain
    # PyTorch on the CPU), so any value but "auto" raises.
    impl: str = "auto"
    # Texture filtering: "nearest" or "bilinear", and "trilinear" on scenes
    # baked with mip chains (GPU samplers filter linearly; nearest is the
    # default to keep golden images stable).
    texture_filter: str = "nearest"
    # Shadow rays: one any-hit ray per (pixel, light) per step — a
    # beyond-reference feature (the reference's lambert is unshadowed).
    shadows: bool = False
    # Watertight intersection (Woop et al.): the crack-free quality tier
    # (kernel K10). None and False both mean off: the port reads no
    # environment knobs.
    watertight: "bool | None" = None
    # Temporal depth warm-start: seeds each step's ray search windows
    # with the previous frame's depth (kernel K9's seed, ops/warmstart.py).
    warmstart: bool = False
    # Mip-mapped textures: True / False / "auto" (on iff the texel pool
    # exceeds the kernel's resident budget). The reference's hardware
    # samplers mip implicitly (src/mgr.cpp:352-354).
    mipmaps: "bool | str" = "auto"
    # The render route (port only: the JAX package's Manager never passes
    # one, its raytrace / rasterize take it): the JAX package's values
    # "auto", "none" (every triangle, K1-none), "clusters" (the ordered
    # walk), "binned" (the tile-binned visit) or "mxu" (the batched kernel
    # K12), passed through to raytrace / rasterize unchanged.
    accel: str = "auto"
    # The deferred matmul sweep K11 (port only: the JAX package reads
    # MRT_DEFERRED_MXU=1 from the environment, the port reads no knobs): on
    # the streamed visits without shadows or watertight it sweeps each
    # visited cluster's every slot and merges the cluster's first minimum;
    # elsewhere ignored, as the JAX package ignores the variable. Passed
    # through to raytrace / rasterize unchanged; the same frames.
    deferred_mxu: bool = False
    # Supersampled antialiasing: render each view at ssaa x resolution
    # and box-filter rgb back down (ops/ssaa.py). 1 = off (reference
    # behavior: one ray per pixel).
    ssaa: int = 1
    # Number of devices to shard the world axis over (1 or fewer: a single
    # device, as in the JAX Manager; more is ROADMAP Queue 1 item 15).
    num_devices: int = 1
