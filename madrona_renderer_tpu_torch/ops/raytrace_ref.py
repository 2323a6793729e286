"""World-space triangle planes, the intersection epsilons and the shadow
epilogue.

The port's copy of what the render prologue and the 9-output route's
epilogue need from the JAX package's ``ops/raytrace_ref.py``: the two
Möller–Trumbore epsilons, the shadow bias, ``planar_soup_parts`` (the
single source of the world-space triangle values that the render kernel's
input pack lays out as rows), the world soup ``build_world_soup``, the
camera rays ``camera_ray_dirs`` and the shadow rays of the epilogue
(``shadow_occlusion``, ``compute_lit``), each the JAX expressions term for
term.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.scene import SceneData
from ..core.state import SimState
from .quat import cross, quat_rotate_planar

_EPS_DET = 1e-10
# Tiny barycentric slack so rays on a shared triangle edge hit at least one
# of the adjacent triangles (naive Möller–Trumbore is not watertight; the
# slack double-counts the edge instead of dropping it — min-t picks one).
_EPS_BARY = 1e-6

# Self-shadow bias: a shadow ray from a hit point must travel at least
# SHADOW_EPS * (1 + primary_t) before an occluder counts — the hit point
# carries O(t·ulp) reconstruction error. (Beyond-reference feature: the
# reference's lighting is unshadowed direct lambert.)
SHADOW_EPS = 1e-3


def planar_soup_parts(state: SimState, scene: SceneData, what: str = "all"):
    """Instance transforms × object triangles → world-space component
    PLANES ``[W, I, T]`` (the render-ECS instance gather + TLAS refit;
    reference ``RenderingSystem::setupTasks``, ``src/sim.cpp:122-126``).

    Returns a dict of ``[W, I, T]`` planes: v0/e1/e2/n0/dn1/dn2 as
    (x, y, z) tuples, uv0/duv1/duv2 as (x, y), plus mat (i32), valid,
    density. ``what='geo'`` skips the normal/uv/density planes. Every
    expression is the JAX package's, term for term
    (``madrona_renderer_tpu/ops/raytrace_ref.py:73``)."""
    obj = state.instance_obj.long()  # [W, I]

    def g(arr):  # [O, T] object plane → [W, I, T]
        return arr[obj]

    def bi(x):  # [W, I] per-instance scalar → broadcast over T
        return x[:, :, None]

    pos = [bi(state.instance_pos[..., k]) for k in range(3)]
    rotq = [bi(state.instance_rot[..., k]) for k in range(4)]
    scale = [bi(state.instance_scale[..., k]) for k in range(3)]

    def rot3(v):
        return quat_rotate_planar(*rotq, *v)

    v0 = rot3([scale[k] * g(scene.v0[..., k]) for k in range(3)])
    v0 = tuple(v0[k] + pos[k] for k in range(3))
    e1 = rot3([scale[k] * g(scene.e1[..., k]) for k in range(3)])
    e2 = rot3([scale[k] * g(scene.e2[..., k]) for k in range(3)])
    valid = g(scene.tri_valid) * state.instance_valid[:, :, None]
    parts = dict(v0=v0, e1=e1, e2=e2, valid=valid, mat=g(scene.tri_mat))
    if what == "geo":
        return parts

    # Normals transform with inverse-transpose: rot * (n / scale).
    inv = [
        1.0 / torch.clamp_min(torch.abs(scale[k]), 1e-20)
        * torch.sign(scale[k] + (scale[k] == 0))
        for k in range(3)
    ]
    parts["n0"] = rot3([g(scene.n0[..., k]) * inv[k] for k in range(3)])
    parts["dn1"] = rot3([g(scene.dn1[..., k]) * inv[k] for k in range(3)])
    parts["dn2"] = rot3([g(scene.dn2[..., k]) * inv[k] for k in range(3)])
    parts["uv0"] = (g(scene.uv0[..., 0]), g(scene.uv0[..., 1]))
    parts["duv1"] = (g(scene.duv1[..., 0]), g(scene.duv1[..., 1]))
    parts["duv2"] = (g(scene.duv2[..., 0]), g(scene.duv2[..., 1]))

    # Mip-level density (world-space): same cross order, the 3-term norm
    # associating (x² + y²) + z².
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    cwx = e1y * e2z - e1z * e2y
    cwy = e1z * e2x - e1x * e2z
    cwz = e1x * e2y - e1y * e2x
    a_world = torch.sqrt(cwx * cwx + cwy * cwy + cwz * cwz)
    tex_id = scene.mat_tex[parts["mat"].long()].long()
    du1x, du1y = parts["duv1"]
    du2x, du2y = parts["duv2"]
    a_uv = torch.abs(du1x * du2y - du1y * du2x)
    tex_area = (
        a_uv
        * scene.tex_width[tex_id].to(torch.float32)
        * scene.tex_height[tex_id].to(torch.float32)
    )
    parts["density"] = torch.sqrt(tex_area / torch.clamp_min(a_world, 1e-30))
    return parts


@dataclasses.dataclass(frozen=True)
class TriangleSoup:
    """Per-world world-space triangles, ``[W, S, ...]``."""

    v0: torch.Tensor  # f32 [W, S, 3]
    e1: torch.Tensor  # f32 [W, S, 3]
    e2: torch.Tensor  # f32 [W, S, 3]
    uv0: torch.Tensor  # f32 [W, S, 2]
    duv1: torch.Tensor
    duv2: torch.Tensor
    n0: torch.Tensor  # f32 [W, S, 3]
    dn1: torch.Tensor
    dn2: torch.Tensor
    mat: torch.Tensor  # i32 [W, S]
    seg: torch.Tensor  # i32 [W, S]: per-world instance index (segmask value)
    valid: torch.Tensor  # f32 [W, S]
    density: torch.Tensor  # f32 [W, S]: texels per world unit at the base mip


def build_world_soup(state: SimState, scene: SceneData) -> TriangleSoup:
    """World-space triangle soup ``[W, S, ...]``: a stack of
    ``planar_soup_parts`` (``raytrace_ref.build_world_soup``, :178)."""
    W, I = state.instance_obj.shape
    T = scene.tris_per_object
    S = I * T
    p = planar_soup_parts(state, scene)

    def fN(c):  # tuple of [W, I, T] planes → [W, S, len(c)]
        return torch.stack([x.expand(W, I, T) for x in c], dim=-1).reshape(W, S, len(c))

    seg = torch.arange(I, dtype=torch.int32, device=state.device)[None, :, None]
    return TriangleSoup(
        v0=fN(p["v0"]), e1=fN(p["e1"]), e2=fN(p["e2"]),
        uv0=fN(p["uv0"]), duv1=fN(p["duv1"]), duv2=fN(p["duv2"]),
        n0=fN(p["n0"]), dn1=fN(p["dn1"]), dn2=fN(p["dn2"]),
        mat=p["mat"].to(torch.int32).reshape(W, S),
        seg=seg.expand(W, I, T).reshape(W, S),
        valid=p["valid"].reshape(W, S),
        density=p["density"].reshape(W, S),
    )


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE divide (a Python divisor on the card multiplies by
    its reciprocal)."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z rounded once to f32 (the product of two f32 is exact in
    f64): a fused multiply-add."""
    return (x.double() * y.double() + z.double()).to(torch.float32)


def _cross_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` as XLA:CPU compiles it: each component a fused
    multiply-add, ``fma(a1, b2, -(a2 b1))``, …"""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)),
                        _fma(a0, b1, -(a1 * b0))], dim=-1)


def camera_ray_dirs(cam_rot: torch.Tensor, height: int, width: int,
                    fov_y_degrees=90.0) -> torch.Tensor:
    """Unit ray directions ``[..., H*W, 3]`` for each camera
    (``raytrace_ref.camera_ray_dirs``, :205): pixel (0, 0) is the top-left
    one, rays through pixel centres; ``fov_y_degrees`` a float or an f32
    tensor broadcastable to the camera batch. The compiled pieces of the JAX
    function round as XLA:CPU compiles them: the norm's squares summed x, y,
    z by fused multiply-adds, its square root correctly rounded, and the
    quaternion rotation's cross products fused (``_cross_fused``), so the
    directions are the JAX function's bit for bit."""
    batch = cam_rot.shape[:-1]
    dev = cam_rot.device
    f32 = torch.float32
    fov = torch.as_tensor(fov_y_degrees, dtype=f32, device=dev).expand(batch)
    tan_y = torch.tan(fov * float(np.float32(np.pi / 180)) * 0.5)[..., None]  # [..., 1]
    tan_x = tan_y * (width / height)
    ys = _div(torch.arange(height, dtype=f32, device=dev) + 0.5, height)
    xs = _div(torch.arange(width, dtype=f32, device=dev) + 0.5, width)
    ndc_x = xs * 2.0 - 1.0
    ndc_z = 1.0 - ys * 2.0
    gx = ndc_x[None, :].expand(height, width).reshape(-1)  # [P]
    gz = ndc_z[:, None].expand(height, width).reshape(-1)
    dx = gx * tan_x  # [..., P]
    dz = gz * tan_y
    ones = torch.ones_like(dx)
    n2 = _fma(dz, dz, _fma(ones, ones, dx * dx))
    norm = torch.sqrt(n2.double()).to(f32)[..., None]
    local = torch.stack([dx, ones, dz], dim=-1) / norm  # [..., P, 3]
    q = cam_rot.reshape(batch + (1, 4))
    w, u = q[..., 0:1], q[..., 1:4]
    uuv = _cross_fused(u, _cross_fused(u, local) + w * local)
    return local + 2.0 * uuv


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """The last axis of 3 summed in order, as XLA's reduction adds it."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def shadow_occlusion(soup: TriangleSoup, points: torch.Tensor, sdir: torch.Tensor,
                     t_hit: torch.Tensor, chunk: int = 128,
                     max_elements: int = 1 << 24) -> torch.Tensor:
    """Any-hit test along a shared direction from per-pixel origins → bool
    ``[W, C, P]`` (True = occluded) (``raytrace_ref.shadow_occlusion``,
    :366): ``pvec = sdir × e2``, the determinant and its reciprocal per
    triangle, then per (pixel, triangle) tvec, qvec, u, v, t, accepted when
    the barycentrics pass with the ε slack, t > SHADOW_EPS · (1 + t_hit)
    and the triangle is valid. Pixels go ``chunk`` at a time and worlds as
    many at a time as keep a ``[worlds, C, chunk, S]`` temporary within
    ``max_elements`` (its ``[..., 3]`` siblings three times that): every
    pixel's test is its own, so the chunks change only the memory."""
    W, S, _ = soup.v0.shape
    C, P = points.shape[1], points.shape[2]
    chunk = max(1, min(chunk, P))
    w_chunk = max(1, max_elements // max(1, C * chunk * S))
    sdir = sdir.to(torch.float32)
    pvec = cross(sdir.expand(soup.e2.shape), soup.e2)  # [W, S, 3]
    det = _sum3(soup.e1 * pvec)
    inv = torch.where(torch.abs(det) > float(np.float32(_EPS_DET)), 1.0 / det, 0.0)
    tri_ok = soup.valid > 0.0
    eps_bary = float(np.float32(_EPS_BARY))
    eps_one = float(np.float32(1.0 + _EPS_BARY))
    eps_shadow = float(np.float32(SHADOW_EPS))
    occ = torch.empty((W, C, P), dtype=torch.bool, device=points.device)
    for w0 in range(0, W, w_chunk):
        w1 = min(W, w0 + w_chunk)
        v0 = soup.v0[w0:w1, None, None]  # [w, 1, 1, S, 3]
        e1 = soup.e1[w0:w1, None, None]
        e2 = soup.e2[w0:w1, None, None]
        pv = pvec[w0:w1, None, None]
        iv = inv[w0:w1, None, None]
        ok_tri = tri_ok[w0:w1, None, None]
        for p0 in range(0, P, chunk):
            p1 = min(P, p0 + chunk)
            tv = points[w0:w1, :, p0:p1, None, :] - v0  # [w, C, ch, S, 3]
            u = _sum3(tv * pv) * iv
            q = cross(tv, e1)
            v = _sum3(sdir * q) * iv
            t = _sum3(e2 * q) * iv
            eps = (eps_shadow * (1.0 + t_hit[w0:w1, :, p0:p1]))[..., None]
            ok = ((u >= -eps_bary) & (v >= -eps_bary) & (u + v <= eps_one)
                  & (t > eps) & ok_tri)
            occ[w0:w1, :, p0:p1] = ok.any(-1)
    return occ


def light_directions(scene: SceneData) -> torch.Tensor:
    """Each light's unit direction ``[L, 3]``: its components over the norm
    (x, y, z squared and summed in that order), floored at 1e-20 — the
    camera rows' expression (``raytrace_cuda._pack_cams``), which the
    kernels shade with."""
    ld = scene.light_dir
    norms = torch.clamp_min(
        torch.sqrt(ld[:, 0:1] * ld[:, 0:1] + ld[:, 1:2] * ld[:, 1:2]
                   + ld[:, 2:3] * ld[:, 2:3]),
        1e-20,
    )
    return ld / norms


def compute_lit(soup: TriangleSoup, scene: SceneData, points: torch.Tensor,
                t_hit: torch.Tensor) -> torch.Tensor:
    """Per-light visibility ``[W, C, P, L]`` (1 lit, 0 shadowed) from the
    primary hit points, one ``shadow_occlusion`` pass per light toward
    -direction (``raytrace_ref.compute_lit``, :422)."""
    dirs = light_directions(scene)
    cols = []
    for li in range(int(scene.light_dir.shape[0])):
        occ = shadow_occlusion(soup, points, -dirs[li], t_hit)
        cols.append(torch.where(occ, 0.0, 1.0))
    return torch.stack(cols, dim=-1)
