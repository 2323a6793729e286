"""Taskgraph: named graphs of dependency-ordered pure-function nodes.

Re-creates the reference's taskgraph layer (``TaskGraphManager::init(id)``,
``TaskGraphBuilder::addToGraph<NodeT>({deps})`` — reference
``src/sim.cpp:81-133``) as plain functions: a node is a function
``state -> state``; building a graph topologically sorts the nodes and
composes them into one function; "running" a graph is calling the composed
function (PyTorch runs it eagerly, one kernel launch after another —
SURVEY.md §2.2 "Taskgraph" row).

GPU-hygiene node types (``ResetTmpAllocNode``, ``RecycleEntitiesNode``,
``SortArchetypeNode``) have no equivalent here **by design**: static-shape
SoA tables need no allocator resets, no id recycling, and no world-id
compaction sorts (see ecs/registry.py docstring).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

Node = Callable  # (state, ctx) -> state


@dataclass(frozen=True)
class NodeID:
    graph: str
    index: int


@dataclass
class _NodeRecord:
    fn: Node
    deps: Sequence[NodeID]
    name: str


class TaskGraphBuilder:
    """Accumulates nodes with explicit dependencies for one graph."""

    def __init__(self, graph_name: str):
        self.graph_name = graph_name
        self._nodes: List[_NodeRecord] = []

    def add_to_graph(
        self,
        fn: Node,
        deps: Sequence[NodeID] = (),
        name: Optional[str] = None,
    ) -> NodeID:
        for d in deps:
            if d.graph != self.graph_name or d.index >= len(self._nodes):
                raise ValueError(f"bad dependency {d} for graph '{self.graph_name}'")
        self._nodes.append(_NodeRecord(fn, tuple(deps), name or fn.__name__))
        return NodeID(self.graph_name, len(self._nodes) - 1)

    def build(self) -> Callable:
        """Topo-sort (stable: declaration order already respects deps since
        deps must pre-exist) and compose into one ``state -> state`` fn."""
        nodes = list(self._nodes)

        def run(state, ctx=None):
            for rec in nodes:
                state = rec.fn(state, ctx) if ctx is not None else rec.fn(state)
            return state

        run.__name__ = f"taskgraph_{self.graph_name}"
        return run

    @property
    def node_names(self) -> List[str]:
        return [n.name for n in self._nodes]


class TaskGraphManager:
    """Named graph registry (analog of ``taskgraph_mgr.init(TaskGraphID)``,
    reference ``src/sim.cpp:129-133``)."""

    def __init__(self) -> None:
        self._builders: Dict[str, TaskGraphBuilder] = {}
        self._order: List[str] = []

    def init(self, graph_id: str) -> TaskGraphBuilder:
        if graph_id in self._builders:
            raise ValueError(f"graph '{graph_id}' already initialized")
        builder = TaskGraphBuilder(graph_id)
        self._builders[graph_id] = builder
        self._order.append(graph_id)
        return builder

    def build_all(self) -> Dict[str, Callable]:
        return {gid: b.build() for gid, b in self._builders.items()}

    def build_sequence(self, graph_ids: Optional[Sequence[str]] = None) -> Callable:
        """Compose several graphs into the per-step run order (the analog of
        ``CUDAImpl::run``'s back-to-back graph launches,
        reference ``src/mgr.cpp:177-185``)."""
        ids = list(graph_ids) if graph_ids is not None else list(self._order)
        fns = [self._builders[g].build() for g in ids]

        def run(state, ctx=None):
            for fn in fns:
                state = fn(state, ctx) if ctx is not None else fn(state)
            return state

        return run
