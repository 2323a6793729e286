"""Tensor export handle: the boundary between the renderer and ML code.

The reference wraps raw device pointers in ``madrona::py::Tensor`` with
zero-copy ``.to_torch()`` via DLPack (reference ``src/mgr.cpp:186-193``,
``src/bindings.cpp:19``; consumed at ``scripts/test.py:137,151``), and —
the key contract — writes into exported *state* tensors are visible to the
next ``step()`` (``scripts/test.py:144-150``).

  * **Output tensors** (rgb/depth/segmask) wrap the device tensor of the
    latest step: ``.to_torch()`` returns that tensor itself (zero-copy),
    ``.numpy()`` copies it to the host.
  * **State tensors** (instance/camera position/rotation) wrap a *live host
    mirror*: a numpy array the Manager uploads at the start of every
    ``step()`` when it changed. ``.to_torch()`` returns a CPU tensor sharing
    the mirror's memory, so ``positions[0][2] += 1.0; renderer.step()``
    works verbatim.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Tensor:
    """Export handle. Analog of ``madrona::py::Tensor``."""

    def __init__(self, host: Optional[np.ndarray] = None,
                 device: Optional[torch.Tensor] = None):
        if (host is None) == (device is None):
            raise ValueError("Tensor wraps exactly one of host= or device=")
        self._host = host
        self._device = device

    @property
    def shape(self):
        return tuple(self._host.shape if self._host is not None else self._device.shape)

    @property
    def dtype(self):
        return self._host.dtype if self._host is not None else self._device.dtype

    def numpy(self) -> np.ndarray:
        """Host ndarray: the live mirror for state tensors, a copy for
        outputs."""
        if self._host is not None:
            return self._host
        return self._device.detach().cpu().numpy()

    def to_torch(self) -> torch.Tensor:
        """The output's device tensor itself, or a CPU tensor sharing the
        live state mirror (writes take effect on the next step)."""
        if self._host is not None:
            return torch.from_numpy(self._host)
        return self._device

    def device_ptr(self) -> int:
        """Raw buffer address (the mirror's host address for state
        tensors). Analog of ``Manager::rgbCudaPtr`` etc.
        (reference ``src/mgr.cpp:607-620``)."""
        if self._device is None:
            return self._host.ctypes.data
        return self._device.data_ptr()
