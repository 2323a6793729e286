"""ECS core + taskgraph (copies of the JAX package's numpy-only layers;
see SURVEY.md §2.2 rows "ECS core" and "Taskgraph")."""

from .registry import VALID, ComponentDef, ECSRegistry, Tables, component
from .taskgraph import NodeID, TaskGraphBuilder, TaskGraphManager

__all__ = [
    "VALID",
    "ComponentDef",
    "ECSRegistry",
    "NodeID",
    "Tables",
    "TaskGraphBuilder",
    "TaskGraphManager",
    "component",
]
