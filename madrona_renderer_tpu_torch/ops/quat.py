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


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) ``[..., 4]`` to unit length: the squares
    summed w, x, y, z in that order, the square root correctly rounded (in
    f64, then to f32: torch's CPU ``sqrt`` is not everywhere), as the JAX
    package's on the CPU and the card's IEEE ``sqrt`` give."""
    s = q * q
    n2 = ((s[..., 0:1] + s[..., 1:2]) + s[..., 2:3]) + s[..., 3:4]
    n = torch.sqrt(n2.double()).to(q.dtype)
    return q / torch.clamp_min(n, eps)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a*b`` of quaternions ``[..., 4]`` (w,x,y,z), each
    component summed left to right as the JAX package writes it."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
