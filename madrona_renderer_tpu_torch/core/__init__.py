"""Core data model: sim schema, state, scene bake, frames."""
