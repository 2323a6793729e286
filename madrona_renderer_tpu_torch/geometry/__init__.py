"""Acceleration-structure bake (Morton clusters; see bvh.py)."""
