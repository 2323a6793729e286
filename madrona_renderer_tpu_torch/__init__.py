"""madrona_renderer_tpu_torch — the batch many-world renderer on PyTorch
and CUDA (NVIDIA Hopper).

The port of ``madrona_renderer_tpu`` (JAX/Pallas on a TPU), which stays in
the repository as the reference. The public surface is the same
reference-compatible one (``src/bindings.cpp:18-234``)::

    import madrona_renderer_tpu_torch as m
    renderer = m.MadronaRenderer(gpu_id=0, num_worlds=4,
                                 render_mode=m.RenderMode.Raytracer, ...)
    renderer.step()
    rgb = renderer.rgb_tensor().to_torch()   # the device tensor itself

Entry points run on the card (``cuda:{gpu_id}``); pass ``device="cpu"`` to
run the kernels' plain PyTorch versions on the host. This package imports
torch, numpy and the standard library only.
"""

from .config import (
    AdditionalMaterial,
    GeometryConfig,
    ImportedAsset,
    ImportedCamera,
    ImportedInstance,
    ManagerConfig,
    RenderConfig,
    RenderMode,
    WorldInit,
)
from .core.frames import Frames
from .core.scene import SceneData, bake_scene, configure_lighting
from .core.state import SimState, init_state
from .manager import MadronaRenderer, Manager
from .tensor import Tensor

__version__ = "0.1.0"

__all__ = [
    "AdditionalMaterial",
    "Frames",
    "GeometryConfig",
    "ImportedAsset",
    "ImportedCamera",
    "ImportedInstance",
    "MadronaRenderer",
    "Manager",
    "ManagerConfig",
    "RenderConfig",
    "RenderMode",
    "SceneData",
    "SimState",
    "Tensor",
    "WorldInit",
    "bake_scene",
    "configure_lighting",
    "init_state",
]
