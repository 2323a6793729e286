"""Batch raytracer: the render prologue as torch ops, then kernel K1.

The port of the main path of the JAX package's ``ops/raytrace_pallas.py``
(``render_core``, :3998) for what its flags resolve to on untextured
single-camera scenes that fit the resident budget: the cluster-culled
resident sweep over pack-time Möller–Trumbore rows (``prep``,
``defer_attrs``, ``uv_defer``), shaded in the kernel, with the fused export
(depth, segmask and RGBA8 written in their final masked form).

  1. The prologue packs the inputs with the JAX package's expressions,
     term for term: ``_pack_rows_planar`` (split layout, camera-origin
     prep rows), ``_pack_cams``, and ``world_clusters`` +
     ``_pack_clusters`` (the per-step TLAS refit).
  2. ``render_resident`` launches kernel K1 (``csrc/render_resident.cu``)
     for tensors on the card, or runs ``render_resident_plain`` — the
     same function in torch ops — for tensors on the CPU.
  3. The kernel writes ``[W·C, H, Wd]`` outputs directly, so ``raytrace``
     only reshapes them into ``Frames`` (the JAX ``unpack`` and supertile
     fold are TPU layout steps with no counterpart here).

Scenes outside this path raise ``NotImplementedError`` naming the ROADMAP
item that ports them (``check_supported``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core.frames import Frames
from ..core.scene import SMEM_TRI_BUDGET, SceneData
from ..core.state import SimState
from .quat import quat_rotate
from .raytrace_ref import _EPS_BARY, _EPS_DET, planar_soup_parts
from .shade import AMBIENT, packed_to_rgba8

# Camera row: origin(3) right(3) fwd(3) up(3) tan_x tan_y near far_t far_z
# (cols 0-16), then L light blocks of [dir(3, normalized), color(3)] from
# col 17, then camera_valid, padded to a multiple of 8.
_CAM_LIGHT0 = 17
_N_GEO_ROWS = 16  # split pack: rows 0-9 prep constants, 10-15 padding
_N_PREP_ROWS = 10  # D(3) A(3) Q(3) t_num
_N_ATTR_ROWS = 24  # split pack: rows 16-35 attributes, 36-39 padding
_TRI_ROWS = 32  # the JAX kernel's resident row count (budget check)

# The f32 values of the JAX constants (Python floats there, rounded to f32
# where they meet an f32 array).
_F_EPS_DET = float(np.float32(_EPS_DET))
_F_EPS_BARY = float(np.float32(_EPS_BARY))
_F_ONE_PLUS_EPS = float(np.float32(1.0 + _EPS_BARY))
_F_AMBIENT = float(np.float32(AMBIENT))
_F_DIFFUSE = float(np.float32(1.0 - AMBIENT))
_F_TINY = float(np.float32(1e-20))
_ALPHA = int(np.uint32(0xFF000000).view(np.int32))


def _cam_valid_col(n_lights: int) -> int:
    return _CAM_LIGHT0 + 6 * n_lights


def _n_cam_cols(n_lights: int) -> int:
    return -(-(_CAM_LIGHT0 + 6 * n_lights + 1) // 8) * 8


def check_supported(state: SimState, scene: SceneData) -> None:
    """Raise ``NotImplementedError`` for a scene this slice does not render."""
    if int(scene.tex_data.shape[0]) > 1:
        raise NotImplementedError(
            "textured scenes are not ported yet — ROADMAP Queue 1 item 6"
        )
    if int(scene.tex_mip_offset.shape[1]) > 1:
        raise NotImplementedError(
            "mip-mapped textures are not ported yet — ROADMAP Queue 1 item 9"
        )
    if state.max_cameras > 1:
        raise NotImplementedError(
            "worlds with more than one camera are not ported yet (the prep "
            "rows bake in one camera origin) — ROADMAP Queue 1 item 7"
        )
    S = state.max_instances * scene.tris_per_object
    if _TRI_ROWS * S * 4 > SMEM_TRI_BUDGET:
        raise NotImplementedError(
            f"{S} triangles per world exceed the resident budget "
            f"({SMEM_TRI_BUDGET} bytes) — streamed big meshes are ROADMAP "
            "Queue 1 item 8"
        )


# --------------------------------------------------------------------- #
# Prologue (torch ops, the JAX expressions term for term)
# --------------------------------------------------------------------- #
def _pack_rows_planar(state: SimState, scene: SceneData,
                      cam_pos: torch.Tensor) -> torch.Tensor:
    """Split-layout rows ``[W, 40, S]`` with the camera-origin prep
    constants (``raytrace_pallas._pack_rows_planar(split=True, cam_pos)``,
    :209): rows 0-9 D = e2×e1, A = e2×tv, Q = tv×e1, t_num = e2·Q
    (tv = origin − v0), rows 16-35 the attributes (uv0, duv1, duv2, n0,
    dn1, dn2, material, premultiplied colour, texel density). Invalid
    triangles have zero edges, so their determinant is 0 and the sweep
    rejects them without a validity row."""
    W, I = state.instance_obj.shape
    T = scene.tris_per_object
    S = I * T
    p = planar_soup_parts(state, scene)
    val = p["valid"]
    v0x, v0y, v0z = p["v0"]
    e1x, e1y, e1z = p["e1"]
    e2x, e2y, e2z = p["e2"]
    mat = p["mat"].long()
    col = [scene.mat_color[:, k][mat] for k in range(3)]
    zero = torch.zeros_like(val)

    ve1 = [e1x * val, e1y * val, e1z * val]
    ve2 = [e2x * val, e2y * val, e2z * val]
    o = [cam_pos[:, None, k:k + 1] for k in range(3)]  # [W, 1, 1]
    tvx = o[0] - v0x
    tvy = o[1] - v0y
    tvz = o[2] - v0z
    qx = tvy * ve1[2] - tvz * ve1[1]
    qy = tvz * ve1[0] - tvx * ve1[2]
    qz = tvx * ve1[1] - tvy * ve1[0]
    geo_rows = [
        ve2[1] * ve1[2] - ve2[2] * ve1[1],  # D
        ve2[2] * ve1[0] - ve2[0] * ve1[2],
        ve2[0] * ve1[1] - ve2[1] * ve1[0],
        ve2[1] * tvz - ve2[2] * tvy,  # A
        ve2[2] * tvx - ve2[0] * tvz,
        ve2[0] * tvy - ve2[1] * tvx,
        qx, qy, qz,  # Q
        ve2[0] * qx + ve2[1] * qy + ve2[2] * qz,  # t_num
        zero, zero, zero, zero, zero, zero,
    ]
    attr_rows = [
        p["uv0"][0], p["uv0"][1],
        p["duv1"][0], p["duv1"][1],
        p["duv2"][0], p["duv2"][1],
        p["n0"][0], p["n0"][1], p["n0"][2],
        p["dn1"][0], p["dn1"][1], p["dn1"][2],
        p["dn2"][0], p["dn2"][1], p["dn2"][2],
        p["mat"].to(torch.float32),
        col[0], col[1], col[2],
        p["density"],
    ]
    rows = geo_rows + attr_rows + [zero, zero, zero, zero]
    out = torch.stack([r.expand(val.shape) for r in rows], dim=1)
    return out.reshape(W, len(rows), S)


def _pack_cams(
    state: SimState,
    scene: SceneData,
    width: int,
    height: int,
    eff_fov: torch.Tensor,  # f32 [W, C] degrees
    eff_near: torch.Tensor,  # f32 [W, C]
    far_t: torch.Tensor,  # f32 [W, C] t-space search window upper bound
    far_z: torch.Tensor,  # f32 [W, C] z-space far clip (raster)
) -> torch.Tensor:
    """Camera basis + clip + light scalars ``[W·C, _n_cam_cols(L)]``
    (``raytrace_pallas._pack_cams``, :292)."""
    W, C = state.camera_pos.shape[:2]
    L = int(scene.light_dir.shape[0])
    dev = state.device
    rot = state.camera_rot
    basis = torch.eye(3, dtype=torch.float32, device=dev)
    right = quat_rotate(rot, basis[0])
    fwd = quat_rotate(rot, basis[1])
    up = quat_rotate(rot, basis[2])
    deg2rad = float(np.float32(np.pi / 180))
    tan_y = torch.tan(eff_fov * deg2rad * 0.5)[..., None]  # [W, C, 1]
    tan_x = tan_y * (width / height)
    clip = torch.stack([eff_near, far_t, far_z], dim=-1)  # [W, C, 3]
    ld = scene.light_dir
    norms = torch.clamp_min(
        torch.sqrt(ld[:, 0:1] * ld[:, 0:1] + ld[:, 1:2] * ld[:, 1:2]
                   + ld[:, 2:3] * ld[:, 2:3]),
        1e-20,
    )
    lights_flat = torch.cat([ld / norms, scene.light_color], dim=-1).reshape(-1)
    light = lights_flat.expand(W, C, 6 * L)
    n_cols = _n_cam_cols(L)
    camv = state.camera_valid[:, :, None].to(torch.float32)
    pad = torch.zeros(
        (W, C, n_cols - _CAM_LIGHT0 - 6 * L - 1), dtype=torch.float32, device=dev
    )
    cams = torch.cat(
        [state.camera_pos, right, fwd, up, tan_x, tan_y, clip, light, camv, pad],
        dim=-1,
    )
    return cams.reshape(W * C, n_cols)


def world_clusters(state: SimState, scene: SceneData):
    """Per-step TLAS refit (``raytrace_pallas.world_clusters``, :334):
    object-space cluster AABBs → world space, per instance. Returns
    (cl_lo [W, CC, 3], cl_hi [W, CC, 3], cl_valid [W, CC], cl_count
    [W, CC]) with CC = max_instances · clusters_per_object, in the rows'
    triangle order (instance-major, cluster-minor)."""
    O, NC, _ = scene.cl_min.shape
    W, I = state.instance_obj.shape
    obj = state.instance_obj.long()
    picks = torch.tensor(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        dtype=torch.float32, device=state.device,
    )  # [8, 3]
    lo = scene.cl_min[obj]  # [W, I, NC, 3]
    hi = scene.cl_max[obj]
    corners = lo[..., None, :] * (1 - picks) + hi[..., None, :] * picks
    pos = state.instance_pos[:, :, None, None, :]
    rot = state.instance_rot[:, :, None, None, :]
    scale = state.instance_scale[:, :, None, None, :]
    cw = quat_rotate(rot, scale * corners) + pos
    cl_lo = cw.amin(dim=3).reshape(W, I * NC, 3)
    cl_hi = cw.amax(dim=3).reshape(W, I * NC, 3)
    valid = (
        scene.cl_valid[obj] * state.instance_valid[:, :, None]
    ).reshape(W, I * NC)
    count = (
        scene.cl_count[obj].to(torch.float32) * state.instance_valid[:, :, None]
    ).reshape(W, I * NC)
    return cl_lo, cl_hi, valid, count


def _pack_clusters(cl_lo, cl_hi, cl_valid, cl_count) -> torch.Tensor:
    """→ ``[W, 8, CC]``: rows lo.xyz, hi.xyz, valid, count (:809)."""
    rows = [
        cl_lo[..., 0], cl_lo[..., 1], cl_lo[..., 2],
        cl_hi[..., 0], cl_hi[..., 1], cl_hi[..., 2],
        cl_valid,
        cl_count,
    ]
    return torch.stack(rows, dim=1)


def pack_inputs(
    state: SimState,
    scene: SceneData,
    *,
    height: int,
    width: int,
    near: float = 0.1,
    far: float = 1000.0,
    fov_y_degrees: float = 90.0,
) -> dict:
    """The whole prologue: K1's tensors and launch parameters, as keyword
    arguments of ``render_resident`` / ``render_resident_plain``."""
    check_supported(state, scene)
    # Effective per-camera view parameters (0 = inherit the call defaults).
    eff_fov = torch.where(state.camera_fov > 0, state.camera_fov, fov_y_degrees)
    eff_near = torch.where(state.camera_znear > 0, state.camera_znear, near)
    far_z = torch.full_like(eff_near, far)
    rows = _pack_rows_planar(state, scene, state.camera_pos[:, 0, :])
    cams = _pack_cams(state, scene, width, height, eff_fov, eff_near, far_z, far_z)
    clusters = _pack_clusters(*world_clusters(state, scene))
    return dict(
        rows=rows.contiguous(),
        clusters=clusters.contiguous(),
        cams=cams.contiguous(),
        num_cams=state.max_cameras,
        n_lights=int(scene.light_dir.shape[0]),
        height=height,
        width=width,
        seg_div=scene.tris_per_object,
    )


# --------------------------------------------------------------------- #
# Kernel K1 and its plain version
# --------------------------------------------------------------------- #
def _check_inputs(rows, clusters, cams, num_cams, n_lights, height, width,
                  seg_div) -> None:
    for name, t in (("rows", rows), ("clusters", clusters), ("cams", cams)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
    if rows.dim() != 3 or rows.shape[1] != _N_GEO_ROWS + _N_ATTR_ROWS:
        raise ValueError(f"rows must be [W, 40, S], got {tuple(rows.shape)}")
    W, _, S = rows.shape
    if clusters.dim() != 3 or clusters.shape[:2] != (W, 8):
        raise ValueError(
            f"clusters must be [{W}, 8, CC], got {tuple(clusters.shape)}"
        )
    CC = clusters.shape[2]
    if CC < 1 or S % CC:
        raise ValueError(f"{S} triangles do not split into {CC} clusters")
    if cams.shape != (W * num_cams, _n_cam_cols(n_lights)):
        raise ValueError(
            f"cams must be [{W * num_cams}, {_n_cam_cols(n_lights)}], got "
            f"{tuple(cams.shape)}"
        )
    if height < 1 or width < 1 or seg_div < 1:
        raise ValueError(f"bad height/width/seg_div {height}/{width}/{seg_div}")


def render_resident(rows, clusters, cams, *, num_cams: int, n_lights: int,
                    height: int, width: int, seg_div: int):
    """Kernel K1. Returns ``(depth f32, segmask i32, rgb i32-packed)``, each
    ``[W·C, height, width]``, in their final masked form.

    Tensors on the card launch ``csrc/render_resident.cu`` on their device's
    current stream; tensors on the CPU run ``render_resident_plain``."""
    _check_inputs(rows, clusters, cams, num_cams, n_lights, height, width,
                  seg_div)
    kw = dict(num_cams=num_cams, n_lights=n_lights, height=height,
              width=width, seg_div=seg_div)
    if rows.device.type == "cpu":
        return render_resident_plain(rows, clusters, cams, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"render_resident runs on cuda or cpu, not {rows.device}")
    W, _, S = rows.shape
    CC = clusters.shape[2]
    WC = W * num_cams
    tiles = -(-height // 16) * -(-width // 16)
    if tiles > 65535:
        raise ValueError(f"{height}x{width} needs {tiles} tiles; the grid takes 65535")
    dev = rows.device
    depth = torch.empty((WC, height, width), dtype=torch.float32, device=dev)
    seg = torch.empty((WC, height, width), dtype=torch.int32, device=dev)
    rgb = torch.empty((WC, height, width), dtype=torch.int32, device=dev)
    launch = _build.load("render_resident")
    with torch.cuda.device(dev):
        err = launch(
            rows.data_ptr(), clusters.data_ptr(), cams.data_ptr(),
            depth.data_ptr(), seg.data_ptr(), rgb.data_ptr(),
            WC, num_cams, S, CC, S // CC, int(cams.shape[1]), n_lights,
            height, width, seg_div,
            float(np.float32(2.0 / width)), float(np.float32(2.0 / height)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"render_resident launch failed: {launch.error_string(err)}")
    render_resident.launches += 1
    return depth, seg, rgb


render_resident.launches = 0


def plain_rays(cams, height: int, width: int):
    """Unit ray directions ``(dx, dy, dz)``, each ``[W·C, height·width]``,
    with K1's ray generation expressions (``raytrace_pallas.py:1180-1188``)."""
    dev = cams.device
    f32 = torch.float32
    ys, xs = torch.meshgrid(
        torch.arange(height, device=dev, dtype=f32),
        torch.arange(width, device=dev, dtype=f32),
        indexing="ij",
    )
    px = xs.reshape(1, -1)
    py = ys.reshape(1, -1)
    two_w = float(np.float32(2.0 / width))
    two_h = float(np.float32(2.0 / height))
    a = ((px + 0.5) * two_w - 1.0) * cams[:, 12:13]
    b = (1.0 - (py + 0.5) * two_h) * cams[:, 13:14]
    dx = a * cams[:, 3:4] + cams[:, 6:7] + b * cams[:, 9:10]
    dy = a * cams[:, 4:5] + cams[:, 7:8] + b * cams[:, 10:11]
    dz = a * cams[:, 5:6] + cams[:, 8:9] + b * cams[:, 11:12]
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv_len, dy * inv_len, dz * inv_len


def plain_triangle_test(dx, dy, dz, tri_rows, near, best_t):
    """K1's Möller–Trumbore test of one triangle against every ray:
    ``tri_rows`` is its 10 prep rows ``[W·C, 10, 1]``. Returns
    ``(ok, t, u, v)``, ``ok`` the strict first-min acceptance."""
    def r(k):
        return tri_rows[:, k]

    det = dx * r(0) + dy * r(1) + dz * r(2)
    inv = torch.where(torch.abs(det) > _F_EPS_DET, 1.0 / det, 0.0)
    u = (dx * r(3) + dy * r(4) + dz * r(5)) * inv
    v = (dx * r(6) + dy * r(7) + dz * r(8)) * inv
    t = r(9) * inv
    ok = (
        (torch.minimum(u, v) >= -_F_EPS_BARY)
        & (u + v <= _F_ONE_PLUS_EPS)
        & (t > near)
        & (t < best_t)
    )
    return ok, t, u, v


def render_resident_plain(rows, clusters, cams, *, num_cams: int,
                          n_lights: int, height: int, width: int,
                          seg_div: int):
    """K1 in torch ops, on any device: the same expressions in the same
    order as the kernel, with no cluster cull (the cull only skips work).
    A loop over the S triangles carries (best_t, best_idx, u, v) as
    ``[W·C, H·Wd]`` tensors."""
    del clusters  # the plain version sweeps every triangle
    W, _, S = rows.shape
    WC = W * num_cams
    dev = rows.device
    f32 = torch.float32
    rows_v = rows[torch.arange(WC, device=dev) // num_cams]  # [WC, 40, S]

    def cam(k):  # camera column k → [WC, 1]
        return cams[:, k:k + 1]

    dx, dy, dz = plain_rays(cams, height, width)
    near = cam(14)
    P = height * width
    best_t = cam(15).expand(WC, P).clone()
    best_idx = torch.full((WC, P), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((WC, P), dtype=f32, device=dev)
    best_v = torch.zeros((WC, P), dtype=f32, device=dev)
    for i in range(S):
        ok, t, u, v = plain_triangle_test(
            dx, dy, dz, rows_v[:, :_N_PREP_ROWS, i:i + 1], near, best_t
        )
        best_t = torch.where(ok, t, best_t)
        best_idx = torch.where(ok, i, best_idx)
        best_u = torch.where(ok, u, best_u)
        best_v = torch.where(ok, v, best_v)

    found = best_idx >= 0
    gidx = best_idx.clamp_min(0).long()

    def attr(k):  # attribute row k of each pixel's winner → [WC, P]
        return torch.where(
            found, torch.gather(rows_v[:, _N_GEO_ROWS + k], 1, gidx), 0.0
        )

    uc = torch.clamp(best_u, 0.0, 1.0)
    vc = torch.clamp(best_v, 0.0, 1.0)
    nx = torch.where(found, attr(6) + uc * attr(9) + vc * attr(12), 0.0)
    ny = torch.where(found, attr(7) + uc * attr(10) + vc * attr(13), 0.0)
    nz = torch.where(found, attr(8) + uc * attr(11) + vc * attr(14), 0.0)
    ndotd = nx * dx + ny * dy + nz * dz
    flip = torch.where(ndotd > 0, -1.0, 1.0)
    nx = nx * flip
    ny = ny * flip
    nz = nz * flip

    n_inv = 1.0 / torch.sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, _F_TINY))
    s = [torch.zeros((WC, P), dtype=f32, device=dev) for _ in range(3)]
    for li in range(n_lights):
        c0 = _CAM_LIGHT0 + 6 * li
        nd = torch.clamp_min(
            -(nx * cam(c0) + ny * cam(c0 + 1) + nz * cam(c0 + 2)) * n_inv, 0.0
        )
        s = [s[k] + nd * cam(c0 + 3 + k) for k in range(3)]

    def quantize(base, sk):
        c = torch.clamp(base * (_F_AMBIENT + _F_DIFFUSE * sk), 0.0, 1.0)
        c = torch.where(found, c, 0.0)
        return (c * 255.0 + 0.5).to(torch.int32)

    packed = (
        quantize(attr(16), s[0])
        | (quantize(attr(17), s[1]) << 8)
        | (quantize(attr(18), s[2]) << 16)
        | _ALPHA
    )
    cam_ok = cam(_cam_valid_col(n_lights)) > 0
    hit = found & cam_ok
    depth = torch.where(hit, best_t, 0.0)
    seg = torch.where(hit, torch.div(best_idx, seg_div, rounding_mode="floor"), -1)
    rgb = torch.where(cam_ok, packed, _ALPHA)
    shape = (WC, height, width)
    return (depth.reshape(shape), seg.to(torch.int32).reshape(shape),
            rgb.to(torch.int32).reshape(shape))


# --------------------------------------------------------------------- #
# Entry points
# --------------------------------------------------------------------- #
def render_core(state: SimState, scene: SceneData, *, height: int, width: int,
                near: float = 0.1, far: float = 1000.0,
                fov_y_degrees: float = 90.0):
    """Prologue + K1 (or its plain version on the CPU). Returns
    ``(depth, segmask, rgb_packed)``, each ``[W·C, height, width]``."""
    kw = pack_inputs(state, scene, height=height, width=width, near=near,
                     far=far, fov_y_degrees=fov_y_degrees)
    return render_resident(**kw)


def raytrace(state: SimState, scene: SceneData, *, height: int, width: int,
             near: float = 0.1, far: float = 1000.0,
             fov_y_degrees: float = 90.0) -> Frames:
    """Render every (world, camera) view → padded ``Frames``; invalid
    camera slots render black/0/-1. The counterpart of
    ``raytrace_pallas.raytrace`` / ``raytrace_ref.raytrace``."""
    W, C = state.camera_pos.shape[:2]
    depth, seg, rgb = render_core(
        state, scene, height=height, width=width, near=near, far=far,
        fov_y_degrees=fov_y_degrees,
    )
    return Frames(
        rgb=packed_to_rgba8(rgb).reshape(W, C, height, width, 4),
        depth=depth.reshape(W, C, height, width),
        segmask=seg.reshape(W, C, height, width),
    )
