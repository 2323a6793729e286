"""ECS core: component/archetype registry over SoA array tables.

Re-creation of the engine ECS the reference builds on
(archetype registration and entity creation at reference
``src/sim.cpp:42-71,135-176``; typed component lists at
``src/types.hpp:20-33``; exported columns fetched by slot id at
``src/mgr.cpp:191-193``).

The translation (SURVEY.md §2.2 "ECS core" row):

  * an **archetype** is a set of named components; its table is one array
    per component, shape ``[num_worlds, capacity, *component_shape]``, plus
    a ``_valid`` mask column — fixed capacity instead of dynamic tables
    (the reference sizes its buffers from per-world maxima at init,
    ``src/mgr.cpp:378-388`` — the same number, made a static shape);
  * **entity creation** is a host-side init phase (``spawn``): the
    reference also creates all entities in the world constructor and never
    afterwards, so entity lifecycle at step time reduces to the validity
    mask. ``destroy`` flips the mask — id recycling and compaction sorts
    are unnecessary under static shapes (the reference needs
    ``RecycleEntitiesNode``/``SortArchetypeNode`` because its tables are
    dynamic, ``src/sim.cpp:106-119``);
  * **singletons** are per-world scalars ``[num_worlds, *shape]``
    (``TimeSingleton``, ``src/sim.hpp:50-52``);
  * **exported columns** are just the arrays themselves; ``export_column``
    records a slot → (archetype, component) mapping so callers can fetch
    by slot id exactly like ``getExported(slot)``.

Tables are plain nested dicts of numpy arrays during init;
``core.state.init_state`` turns them into tensors on the device once.
This module is numpy-only (a copy of the JAX package's registry without
its device hand-off).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple

import numpy as np

VALID = "_valid"


@dataclass(frozen=True)
class ComponentDef:
    """One component: trailing shape + dtype + fill value for empty slots."""

    name: str
    shape: Tuple[int, ...] = ()
    dtype: Any = np.float32
    default: Any = 0


def component(name: str, shape=(), dtype=np.float32, default=0) -> ComponentDef:
    return ComponentDef(name, tuple(shape), dtype, default)


@dataclass
class ArchetypeDef:
    name: str
    components: Tuple[ComponentDef, ...]
    capacity: int  # per-world entity capacity


class ECSRegistry:
    """Collects archetype/singleton/export declarations, then builds
    tables. Mirrors the role of ``ECSRegistry`` at reference
    ``src/sim.cpp:42-71``."""

    def __init__(self) -> None:
        self.archetypes: Dict[str, ArchetypeDef] = {}
        self.singletons: Dict[str, ComponentDef] = {}
        self.exports: Dict[int, Tuple[str, str]] = {}

    def register_archetype(
        self, name: str, components: Sequence[ComponentDef], capacity: int
    ) -> None:
        if name in self.archetypes:
            raise ValueError(f"archetype '{name}' already registered")
        self.archetypes[name] = ArchetypeDef(name, tuple(components), max(capacity, 1))

    def register_singleton(self, comp: ComponentDef) -> None:
        self.singletons[comp.name] = comp

    def export_column(self, slot: int, archetype: str, component: str) -> None:
        """Record an export slot (analog of ``exportColumn<A, C>(slot)``,
        reference ``src/sim.cpp:52-70``)."""
        if archetype not in self.archetypes:
            raise KeyError(f"unknown archetype '{archetype}'")
        if component not in [c.name for c in self.archetypes[archetype].components]:
            raise KeyError(f"archetype '{archetype}' has no component '{component}'")
        self.exports[slot] = (archetype, component)

    # ------------------------------------------------------------------ #
    def build_tables(self, num_worlds: int) -> "Tables":
        data: Dict[str, Dict[str, np.ndarray]] = {}
        for name, arch in self.archetypes.items():
            cols = {}
            for comp in arch.components:
                arr = np.empty((num_worlds, arch.capacity) + comp.shape, comp.dtype)
                arr[...] = comp.default
                cols[comp.name] = arr
            cols[VALID] = np.zeros((num_worlds, arch.capacity), np.float32)
            data[name] = cols
        singles = {}
        for name, comp in self.singletons.items():
            arr = np.empty((num_worlds,) + comp.shape, comp.dtype)
            arr[...] = comp.default
            singles[name] = arr
        return Tables(self, num_worlds, data, singles)


@dataclass
class Tables:
    """Host-side SoA tables during world init. ``spawn`` is the analog of
    ``ctx.makeEntity<A>()`` + ``ctx.get<C>(e) = v`` (reference
    ``src/sim.cpp:151-156``)."""

    registry: ECSRegistry
    num_worlds: int
    archetypes: Dict[str, Dict[str, np.ndarray]]
    singletons: Dict[str, np.ndarray]
    _counts: Dict[str, np.ndarray] = field(default_factory=dict)

    def spawn(self, archetype: str, world: int, **values) -> int:
        arch = self.archetypes[archetype]
        counts = self._counts.setdefault(
            archetype, np.zeros((self.num_worlds,), np.int64)
        )
        slot = int(counts[world])
        cap = arch[VALID].shape[1]
        if slot >= cap:
            raise IndexError(
                f"archetype '{archetype}' capacity {cap} exceeded in world {world}"
            )
        for key, val in values.items():
            if key not in arch:
                raise KeyError(f"archetype '{archetype}' has no component '{key}'")
            arch[key][world, slot] = val
        arch[VALID][world, slot] = 1.0
        counts[world] += 1
        return slot

    def destroy(self, archetype: str, world: int, slot: int) -> None:
        self.archetypes[archetype][VALID][world, slot] = 0.0

    def set_singleton(self, name: str, world: int, value) -> None:
        self.singletons[name][world] = value

    def column(self, archetype: str, component: str) -> np.ndarray:
        return self.archetypes[archetype][component]

    def exported(self, slot: int) -> np.ndarray:
        """Fetch a column by export slot (analog of ``getExported(slot)``,
        reference ``src/mgr.cpp:191``)."""
        arch, comp = self.registry.exports[slot]
        return self.archetypes[arch][comp]
