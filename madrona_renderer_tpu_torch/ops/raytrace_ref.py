"""World-space triangle planes and the intersection epsilons.

The port's copy of what the render prologue needs from the JAX package's
``ops/raytrace_ref.py``: the two Möller–Trumbore epsilons, the shadow
bias and ``planar_soup_parts``, the single source of the world-space
triangle values that the render kernel's input pack lays out as rows.
"""

from __future__ import annotations

import torch

from ..core.scene import SceneData
from ..core.state import SimState
from .quat import quat_rotate_planar

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
