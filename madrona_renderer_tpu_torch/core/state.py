"""Simulation state: the ECS table as tensors.

The reference's ECS stores per-world archetype tables whose exported columns
are live, contiguous, cross-world-concatenated device buffers (export usage:
reference ``src/mgr.cpp:186-193``; archetypes ``src/types.hpp:20-33``). Our
equivalent is a frozen dataclass of fixed-capacity SoA tensors — one per
component, shape ``[num_worlds, capacity, ...]`` plus a validity mask —
with the JAX package's field names, shapes and dtypes
(``madrona_renderer_tpu/core/state.py:41-56``).

World init semantics replicate ``Sim::Sim`` (reference ``src/sim.cpp:135-176``):
each world copies ``num_instances`` instances starting at ``instance_offset``
from the shared imported-instance array (worlds may alias the same slice and
then evolve independently), and likewise for cameras.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import ImportedCamera, ImportedInstance, WorldInit


@dataclass(frozen=True)
class SimState:
    """All mutable per-step simulation state. Shapes: W worlds, I instance
    capacity, C camera capacity."""

    instance_pos: torch.Tensor  # f32 [W, I, 3]
    instance_rot: torch.Tensor  # f32 [W, I, 4] (w, x, y, z)
    instance_scale: torch.Tensor  # f32 [W, I, 3]
    instance_obj: torch.Tensor  # i32 [W, I]
    instance_valid: torch.Tensor  # f32 [W, I] (1.0 live, 0.0 empty slot)
    camera_pos: torch.Tensor  # f32 [W, C, 3]
    camera_rot: torch.Tensor  # f32 [W, C, 4]
    camera_valid: torch.Tensor  # f32 [W, C]
    # Per-view camera parameters; 0.0 = inherit the render-call default.
    camera_fov: torch.Tensor  # f32 [W, C] (degrees, vertical)
    camera_znear: torch.Tensor  # f32 [W, C]
    # TimeSingleton analog: advanced +0.05 per step
    # (reference timeUpdateSys, src/sim.cpp:73-77).
    time: torch.Tensor  # f32 [W]

    @property
    def num_worlds(self) -> int:
        return int(self.instance_pos.shape[0])

    @property
    def max_instances(self) -> int:
        return int(self.instance_pos.shape[1])

    @property
    def max_cameras(self) -> int:
        return int(self.camera_pos.shape[1])

    @property
    def device(self) -> torch.device:
        return self.instance_pos.device


def _counts(worlds: Sequence[WorldInit]) -> Tuple[np.ndarray, np.ndarray]:
    inst = np.asarray([w.num_instances for w in worlds], np.int64)
    cams = np.asarray([w.num_cameras for w in worlds], np.int64)
    return inst, cams


def init_state(
    instances: Sequence[ImportedInstance],
    cameras: Sequence[ImportedCamera],
    worlds: Sequence[WorldInit],
    device: "torch.device | str",
) -> SimState:
    """Build the initial SimState via the ECS layer (host numpy), then one
    transfer to ``device`` — the analog of per-world ``Sim::Sim`` inside
    the executor ctor (reference ``src/sim.cpp:135-182``)."""
    from .sim import init_worlds, register_types
    from ..ecs.registry import VALID

    inst_counts, cam_counts = _counts(worlds)
    max_i = max(int(inst_counts.max(initial=1)), 1)
    max_c = max(int(cam_counts.max(initial=1)), 1)

    registry = register_types(max_i, max_c)
    tables = init_worlds(registry, instances, cameras, worlds)

    rend = tables.archetypes["renderable"]
    agent = tables.archetypes["agent"]
    # Empty rotation slots get identity quats (w=1) so padded math stays
    # finite.
    for rot, valid in ((rend["rotation"], rend[VALID]), (agent["rotation"], agent[VALID])):
        rot[..., 0] = np.where(valid > 0, rot[..., 0], 1.0)

    arrays = dict(
        instance_pos=rend["position"],
        instance_rot=rend["rotation"],
        instance_scale=rend["scale"],
        instance_obj=rend["object_id"],
        instance_valid=rend[VALID],
        camera_pos=agent["position"],
        camera_rot=agent["rotation"],
        camera_valid=agent[VALID],
        camera_fov=agent["fov"],
        camera_znear=agent["znear"],
        time=tables.singletons["time"],
    )
    return SimState(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})
