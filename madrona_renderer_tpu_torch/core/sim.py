"""World/ECS schema: the app-level simulation definition.

The analog of the reference's ``src/types.hpp`` + ``src/sim.{hpp,cpp}``:
archetype declarations, export slots, per-world entity spawn, and the step
taskgraph, expressed through :mod:`madrona_renderer_tpu_torch.ecs`.

Mapping to the reference:
  * ``Agent`` archetype (Position, Rotation, RenderCamera) →
    ``"agent"`` with position/rotation columns; the camera parameters
    (fov 90°, znear 1e-3 — ``attachEntityToView``, ``src/sim.cpp:168-171``)
    are config constants, not per-entity state, exactly as in the reference.
  * ``DummyRenderable`` (Position, Rotation, Scale, ObjectID, Renderable) →
    ``"renderable"`` with position/rotation/scale/object_id columns.
  * ``TimeSingleton`` → ``"time"`` singleton, advanced +0.05 per step
    (``timeUpdateSys``, ``src/sim.cpp:73-77``).
  * ``ExportID`` slots mirror ``src/sim.hpp:19-29`` (including the unused
    ``Action`` slot, kept for numbering parity).
"""

from __future__ import annotations

import enum
from typing import Sequence

import numpy as np

from ..config import ImportedCamera, ImportedInstance, WorldInit
from ..ecs.registry import ECSRegistry, Tables, VALID, component


class ExportID(enum.IntEnum):
    """Export slot ids (reference ``src/sim.hpp:19-29``)."""

    Action = 0  # declared but never used by the reference either
    RaycastRGB = 1
    RaycastDepth = 2
    RaycastSegmask = 3
    InstancePosition = 4
    InstanceRotation = 5
    CameraPosition = 6
    CameraRotation = 7
    NumExports = 8


class TaskGraphID(str, enum.Enum):
    """Graph names (reference ``src/sim.hpp:38-42``)."""

    Step = "step"
    Render = "render"


def register_types(max_instances: int, max_cameras: int) -> ECSRegistry:
    """Declare archetypes/singletons/exports (analog of
    ``Sim::registerTypes``, reference ``src/sim.cpp:42-71``)."""
    reg = ECSRegistry()
    reg.register_archetype(
        "renderable",
        [
            component("position", (3,), np.float32),
            component("rotation", (4,), np.float32, default=0),
            component("scale", (3,), np.float32, default=1),
            component("object_id", (), np.int32),
        ],
        capacity=max_instances,
    )
    reg.register_archetype(
        "agent",
        [
            component("position", (3,), np.float32),
            component("rotation", (4,), np.float32, default=0),
            # Per-view camera parameters. The reference pins these at
            # attachEntityToView(fov=90, znear=1e-3) (src/sim.cpp:168-171);
            # ours are per-entity state (0 = inherit the call-site default).
            component("fov", (), np.float32, default=0),
            component("znear", (), np.float32, default=0),
        ],
        capacity=max_cameras,
    )
    reg.register_singleton(component("time", (), np.float32))
    reg.export_column(ExportID.InstancePosition, "renderable", "position")
    reg.export_column(ExportID.InstanceRotation, "renderable", "rotation")
    reg.export_column(ExportID.CameraPosition, "agent", "position")
    reg.export_column(ExportID.CameraRotation, "agent", "rotation")
    return reg


def init_worlds(
    registry: ECSRegistry,
    instances: Sequence[ImportedInstance],
    cameras: Sequence[ImportedCamera],
    worlds: Sequence[WorldInit],
) -> Tables:
    """Per-world entity spawn from the shared imported arrays (analog of
    ``Sim::Sim``, reference ``src/sim.cpp:135-176``: each world copies its
    [offset, offset+count) slice; aliasing worlds diverge afterwards)."""
    tables = registry.build_tables(len(worlds))
    for w, winit in enumerate(worlds):
        for i in range(winit.num_instances):
            src = instances[winit.instance_offset + i]
            tables.spawn(
                "renderable",
                w,
                position=np.asarray(src.position, np.float32),
                rotation=np.asarray(src.rotation, np.float32),
                scale=np.asarray(src.scale, np.float32),
                object_id=np.int32(src.object_id),
            )
        for c in range(winit.num_cameras):
            src = cameras[winit.camera_offset + c]
            tables.spawn(
                "agent",
                w,
                position=np.asarray(src.position, np.float32),
                rotation=np.asarray(src.rotation, np.float32),
                fov=np.float32(getattr(src, "fov_y_degrees", 0.0)),
                znear=np.float32(getattr(src, "znear", 0.0)),
            )
    return tables
