"""Watertight ray/triangle intersection (Woop, Benthin & Wald 2013, JCGT,
"Watertight Ray/Triangle Intersection"): the quality-tier intersector.

The port's copy of the JAX package's ``ops/watertight.py``. The default
intersector (the render kernel's Möller–Trumbore test) accepts with an
ε-slack on the barycentric bounds: seams between adjacent triangles are
over-covered by ε, which avoids cracks in practice but is a tuned
tolerance, not a guarantee. This module shears each ray into a frame
where its direction is +Z and decides hits by three 2D edge functions.
For an edge shared by two triangles, both edge functions are computed
from the *same two sheared vertex coordinates* with operands swapped, so
IEEE arithmetic makes them exactly negated: one triangle accepts whenever
the other strictly rejects, and exact zeros (a ray through the edge) are
accepted by both. No crack can open between triangles whose shared
vertices are bitwise equal.

Two forms of the shear frame, equal on every ray that can produce an
accepted hit:
  * ``_shear_frame`` / ``woop_intersect``: the JAX module's one-hot form
    (kz = argmax |d|, first maximum on ties; kx, ky its cyclic
    successors), for explicit vertex arrays;
  * ``shear_select`` / ``sheared``: the JAX render kernel's select form
    (``raytrace_pallas.py:1244-1273``), which the port's render kernel K10
    (``csrc/render_resident.cu``, ``GEO`` raw_wt / raw_wt_shadows) and its
    plain version (``raytrace_cuda.plain_triangle_test``) use.
Every divide is a reciprocal then a multiply (``1.0 / dz``, ``1.0 / det``),
as in the JAX module, which keeps its Pallas kernel bitwise against XLA on
a TPU.

Divergences from the paper (deliberate, the JAX module's):
  * Double-sided: the renderer ignores winding, so the accept test is
    "all edge functions ≥ 0 or all ≤ 0", and a fixed cyclic axis order per
    ray keeps shared-edge cancellation intact.
  * No double-precision fallback on exact edge-function zeros: zeros are
    accepted as boundary hits by both adjacent triangles, which keeps the
    no-crack property; it only decides which of two coincident boundary
    hits wins the min-t.

Contraction caveat, restated for CUDA: the no-crack guarantee needs the
two shared-edge 2D cross products rounded identically, so that IEEE
subtraction negates them exactly. ``nvcc`` contracts ``a*b - c*d`` into a
fused multiply-add unless told ``--fmad=false``, which rounds the two
triangles' copies differently and can flip an exactly-zero edge function
to ±1 ulp: a knife-edge ray could then miss both triangles. The port
builds every kernel with ``--fmad=false`` (``_build.NVCC_FLAGS``), so
exact-zero edge functions survive on the card, and PyTorch's eager ops
round each multiply and add on their own on either device. XLA:CPU does
contract inside compiled code, so the JAX package's jnp path differs from
this module by a few knife-edge pixels on the CPU (the tests' bar).

Validity caveat: a padding or disabled triangle slot has zero edges, so
its three sheared points coincide and its edge functions are exactly
zero without contraction (det = 0, rejected). The render kernel ANDs the
pack's validity row 9 into the decision all the same, as the JAX kernel
does (``raytrace_pallas.py:1415-1432``): with contraction the zeros become
rounding residuals that accepted 310 phantom hits on a 32² view there.

Scope caveat: the scene pipeline stores triangles in (v0, e1, e2) edge
form from bake time on, so a vertex shared between triangles is
reconstructed as ``v0 + e1`` with up to 1-ulp disagreement between them.
The render kernel is therefore watertight up to that reconstruction ulp;
``woop_intersect`` on explicit vertex arrays is exactly watertight. The
JAX module's soup-level wrapper ``intersect_watertight`` works on the jnp
reference's triangle soup; the port has its twin of that soup
(``raytrace_ref.build_world_soup``), but not of the wrapper, which no port
route takes (ROADMAP Queue 1 item 10, the jnp reference path).
"""

from __future__ import annotations

import torch


def _shear_frame(dirs: torch.Tensor):
    """Per-ray shear constants. dirs [..., 3] → (ox, oy, oz one-hots
    [..., 3], Sx, Sy, Sz [...]). kz = argmax |d| (first maximum); kx, ky
    cyclic."""
    kz = torch.argmax(dirs.abs(), dim=-1)
    oz = torch.nn.functional.one_hot(kz, 3).to(dirs.dtype)
    ox = torch.roll(oz, 1, dims=-1)  # kx = (kz + 1) % 3
    oy = torch.roll(oz, 2, dims=-1)  # ky = (kz + 2) % 3
    dz = (dirs * oz).sum(-1)
    dx = (dirs * ox).sum(-1)
    dy = (dirs * oy).sum(-1)
    # |dz| is the max-magnitude component of a nonzero direction;
    # reciprocal-multiply form, not dx / dz.
    sz = 1.0 / dz
    return ox, oy, oz, dx * sz, dy * sz, sz


def _edge_function_hit(ax, ay, az, bx, by, bz, cx, cy, cz):
    """2D edge functions over sheared coordinates → (u, v, w, det, t,
    accept), elementwise on any broadcastable shapes. Double-sided accept;
    zeros (a ray exactly through an edge) accepted."""
    u = cx * by - cy * bx  # weight of v0
    v = ax * cy - ay * cx  # weight of v1
    w = bx * ay - by * ax  # weight of v2
    det = u + v + w
    nonzero = det != 0.0
    inv_det = torch.where(nonzero, 1.0 / det, 0.0)
    t = torch.where(nonzero, (u * az + v * bz + w * cz) * inv_det, torch.inf)
    accept = nonzero & (((u >= 0.0) & (v >= 0.0) & (w >= 0.0))
                        | ((u <= 0.0) & (v <= 0.0) & (w <= 0.0)))
    return u, v, w, det, t, accept


def woop_intersect(orig: torch.Tensor, dirs: torch.Tensor, v0: torch.Tensor,
                   v1: torch.Tensor, v2: torch.Tensor):
    """All-pairs watertight test of R rays × S triangles: ``orig`` [..., 3]
    (broadcastable to the rays), ``dirs`` [R, 3], ``v0`` / ``v1`` / ``v2``
    [S, 3]. Returns (t [R, S], accept [R, S], bary [R, S, 3]); ``t`` may be
    ≤ 0 for hits behind the origin (callers bound it), ``bary`` are the
    (v0, v1, v2) weights. Exactly watertight across edges whose endpoint
    coordinates are bitwise shared between triangles."""
    ox, oy, oz, sx, sy, sz = _shear_frame(dirs)  # [R, ...]

    def sheared(v):  # v [S, 3] translated per ray origin → [R, S]
        tv = v[None, :, :] - torch.as_tensor(orig)[..., None, :]  # [R, S, 3]
        px = (tv * ox[:, None, :]).sum(-1)
        py = (tv * oy[:, None, :]).sum(-1)
        pz = (tv * oz[:, None, :]).sum(-1)
        return px - sx[:, None] * pz, py - sy[:, None] * pz, sz[:, None] * pz

    u, v, w, det, t, accept = _edge_function_hit(*sheared(v0), *sheared(v1),
                                                 *sheared(v2))
    inv = torch.where(det != 0.0, 1.0 / det, 0.0)
    return t, accept, torch.stack([u * inv, v * inv, w * inv], dim=-1)


def shear_select(dx, dy, dz):
    """The render kernel's per-ray shear frame (select form): returns
    ``(kz_x, kz_y, shear_x, shear_y, shear_z)``, kz_x / kz_y the masks of
    kz = x / kz = y (first maximum of |d|: ``adx >= ady && adx >= adz``,
    then ``ady >= adz``), shear_z = 1 / d[kz], shear_x = d[kx] · shear_z,
    shear_y = d[ky] · shear_z."""
    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()
    kz_x = (adx >= ady) & (adx >= adz)
    kz_y = ~kz_x & (ady >= adz)
    frame = (kz_x, kz_y)
    shear_z = 1.0 / _sel_z(frame, dx, dy, dz)
    return (kz_x, kz_y, _sel_x(frame, dx, dy, dz) * shear_z,
            _sel_y(frame, dx, dy, dz) * shear_z, shear_z)


def _sel_z(frame, vx, vy, vz):  # component kz
    return torch.where(frame[0], vx, torch.where(frame[1], vy, vz))


def _sel_x(frame, vx, vy, vz):  # component kx = kz + 1 (mod 3)
    return torch.where(frame[0], vy, torch.where(frame[1], vz, vx))


def _sel_y(frame, vx, vy, vz):  # component ky = kz + 2 (mod 3)
    return torch.where(frame[0], vz, torch.where(frame[1], vx, vy))


def sheared(shear, vx, vy, vz):
    """A vertex translated to the ray origin → its sheared (x, y, z) in the
    frame ``shear`` of ``shear_select``."""
    kz_x, kz_y, shear_x, shear_y, shear_z = shear
    frame = (kz_x, kz_y)
    pz = _sel_z(frame, vx, vy, vz)
    return (_sel_x(frame, vx, vy, vz) - shear_x * pz,
            _sel_y(frame, vx, vy, vz) - shear_y * pz,
            shear_z * pz)
