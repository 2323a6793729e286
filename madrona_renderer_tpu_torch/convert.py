"""Carry state across from the JAX package.

The JAX package's ``SceneData`` / ``SimState`` hand over as dicts of numpy
arrays, one per field (``{f.name: np.asarray(getattr(x, f.name))}``), plus
``tris_per_object`` and ``fb_rows`` for a scene. These functions put them on
a torch device as the port's dataclasses, so both packages can render the
very same state. Nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.scene import SceneData
from .core.state import SimState


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def scene_from_numpy(d: dict, device="cpu") -> SceneData:
    """``SceneData`` from the JAX scene's fields as numpy arrays."""
    kw = {}
    for f in dataclasses.fields(SceneData):
        if f.name == "fb_rows":
            kw[f.name] = int(d.get("fb_rows", f.default))
        else:
            kw[f.name] = _tensor(d[f.name], device)
    scene = SceneData(**kw)
    if "tris_per_object" in d and int(d["tris_per_object"]) != scene.tris_per_object:
        raise ValueError(
            f"tris_per_object {d['tris_per_object']} does not match v0's "
            f"{scene.tris_per_object}"
        )
    return scene


def state_from_numpy(d: dict, device="cpu") -> SimState:
    """``SimState`` from the JAX state's fields as numpy arrays."""
    return SimState(
        **{f.name: _tensor(d[f.name], device) for f in dataclasses.fields(SimState)}
    )


def to_numpy(x) -> dict:
    """The inverse: a port ``SceneData`` / ``SimState`` as a dict of numpy
    arrays (plus ``tris_per_object`` for a scene)."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        out[f.name] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    if isinstance(x, SceneData):
        out["tris_per_object"] = x.tris_per_object
    return out
