"""The fused input pack: kernel K13 and its plain version.

The port of the JAX package's ``ops/pack_pallas.py`` (``pack_rows_pallas``
with ``split=True``, with the camera origin or without it): per (world,
triangle slot), the instance transform applied to the object's triangle,
laid out as the ``[W, 40, S]`` split rows that the render kernel reads, in
the prep layout (camera-origin Möller–Trumbore constants) or the raw one
(v0, e1, e2 and the validity). ``pack_rows``
launches ``csrc/pack_rows.cu`` for tensors on the card and runs
``raytrace_cuda._pack_rows_planar`` — the same function in torch ops, and
the kernel's plain version — for tensors on the CPU. The two are bitwise
equal: the kernel repeats the torch expressions term for term with
``--fmad=false`` and IEEE divide and square root.

Unlike the TPU kernel, K13 needs no host-side preparation: it reads the
instance arrays and the scene's object tables as they are (the TPU kernel's
broadcast plane table and instance-scalar array exist to avoid a gather,
which a CUDA thread simply does), and the lane padding to 128 is gone.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.scene import SceneData
from ..core.state import SimState
from . import raytrace_cuda

N_ROWS = 40  # 16 geometry rows (10 prep or raw + padding), 24 attribute rows
# The two layouts' names, as chip_smoke.py reports them.
LAYOUTS = ("pack_rows", "pack_rows_raw")

_STATE_F32 = ("instance_pos", "instance_rot", "instance_scale", "instance_valid")
_SCENE_F32 = ("v0", "e1", "e2", "n0", "dn1", "dn2", "uv0", "duv1", "duv2")


def _check(state: SimState, scene: SceneData, cam_pos: torch.Tensor | None) -> None:
    dev = state.device
    W, I = state.instance_obj.shape
    for name in _STATE_F32:
        t = getattr(state, name)
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous float32 on {dev}")
    for name in _SCENE_F32 + ("tri_valid", "mat_color"):
        t = getattr(scene, name)
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous float32 on {dev}")
    for t, name in ((state.instance_obj, "state.instance_obj"),
                    (scene.tri_mat, "scene.tri_mat"), (scene.mat_tex, "scene.mat_tex"),
                    (scene.tex_width, "scene.tex_width"),
                    (scene.tex_height, "scene.tex_height")):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
    if cam_pos is not None and (cam_pos.shape != (W, 3) or cam_pos.dtype != torch.float32
                                or cam_pos.device != dev):
        raise ValueError(
            f"cam_pos must be float32 [{W}, 3] on {dev}, got "
            f"{cam_pos.dtype} {tuple(cam_pos.shape)} on {cam_pos.device}"
        )
    if scene.mat_color.shape[1] != 4:
        raise ValueError("scene.mat_color must be [M, 4]")


def layout_name(cam_pos) -> str:
    """``pack_rows`` for the prep layout, ``pack_rows_raw`` for the raw one."""
    return LAYOUTS[cam_pos is None]


def pack_rows(state: SimState, scene: SceneData,
              cam_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K13: the split rows ``[W, 40, S]``, with the camera-origin
    prep constants when ``cam_pos [W, 3]`` is given, else the raw v0 / e1 /
    e2 rows (``raytrace_cuda._pack_rows_planar`` documents the rows).

    Tensors on the card launch ``csrc/pack_rows.cu`` on their device's
    current stream; tensors on the CPU run ``_pack_rows_planar``. Each
    launch adds one to its layout's entry of ``pack_rows.layout_launches``."""
    if state.device.type == "cpu":
        return raytrace_cuda._pack_rows_planar(state, scene, cam_pos)
    if state.device.type != "cuda":
        raise ValueError(f"pack_rows runs on cuda or cpu, not {state.device}")
    _check(state, scene, cam_pos)
    W, I = state.instance_obj.shape
    T = scene.tris_per_object
    cam = None if cam_pos is None else cam_pos.contiguous()
    out = torch.empty((W, N_ROWS, I * T), dtype=torch.float32, device=state.device)
    launch = _build.load("pack_rows")
    ptrs = [getattr(state, n).data_ptr() for n in _STATE_F32]
    ptrs += [state.instance_obj.data_ptr(),
             None if cam is None else cam.data_ptr()]
    ptrs += [getattr(scene, n).data_ptr() for n in _SCENE_F32]
    ptrs += [t.data_ptr() for t in (scene.tri_mat, scene.tri_valid, scene.mat_color,
                                    scene.mat_tex, scene.tex_width, scene.tex_height, out)]
    with torch.cuda.device(state.device):
        err = launch(*ptrs, W, I, T, torch.cuda.current_stream(state.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pack_rows launch failed: {launch.error_string(err)}")
    pack_rows.layout_launches[layout_name(cam_pos)] += 1
    return out


pack_rows.layout_launches = dict.fromkeys(LAYOUTS, 0)
