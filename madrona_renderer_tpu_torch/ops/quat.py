"""Quaternion rotation used by the render prologue.

Conventions (matching the reference renderer's observable behavior):
  * Quaternions are stored ``(w, x, y, z)`` (reference ``scripts/test.py:38``).
  * World space is right-handed, Z-up.
  * Camera local frame: +X right, +Y forward, +Z up.

Both functions repeat the JAX package's ``ops/quat.py`` operation for
operation (numpy cross order), so the two packages round alike. They are
shape-polymorphic over leading batch dims and broadcast like PyTorch.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``numpy.cross`` over the last axis, term for term:
    ``(a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)``."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v [..., 3]`` by quaternion(s) ``q [..., 4]`` (w,x,y,z):
    ``v' = v + 2*cross(q.xyz, cross(q.xyz, v) + w*v)``."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    uuv = cross(u, uv + w * v)
    return v + 2.0 * uuv


def quat_rotate_planar(qw, qx, qy, qz, vx, vy, vz):
    """Per-component ``quat_rotate`` on scalar component planes, same
    formulation term for term. Returns ``(x, y, z)``."""
    uvx = qy * vz - qz * vy
    uvy = qz * vx - qx * vz
    uvz = qx * vy - qy * vx
    ax = uvx + qw * vx
    ay = uvy + qw * vy
    az = uvz + qw * vz
    uuvx = qy * az - qz * ay
    uuvy = qz * ax - qx * az
    uuvz = qx * ay - qy * ax
    return (vx + 2.0 * uuvx, vy + 2.0 * uuvy, vz + 2.0 * uuvz)
