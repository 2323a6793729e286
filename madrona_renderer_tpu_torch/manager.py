"""Manager: the product API, on PyTorch and CUDA.

The port of the JAX package's ``manager.py`` (the re-creation of the
reference ``Manager``, ``src/mgr.hpp:29-120``, ``src/mgr.cpp:365-665``): it
owns initialization (device selection, asset import, scene bake, state
init) and per-step execution, and exports every tensor the reference
exports with the same shapes and dtypes.

Init path (``Manager::Impl::init``, ``src/mgr.cpp:365-503``):
  * ``MWCudaExecutor::initCUDA(gpuID)``  → ``cuda:{gpu_id}`` (or the
    ``device`` the config names; construction raises when no card is
    present and none is named).
  * ``loadRenderObjects`` (import + bake) → ``load_render_assets`` +
    ``bake_scene`` (host numpy, one transfer).
  * the executor build                  → every flag resolved here, once;
    unsupported options raise ``NotImplementedError`` naming the ROADMAP
    item that ports them.

Step path (``Manager::step`` → ``CUDAImpl::run``, ``src/mgr.cpp:177-185,
529-546``): three task-graph nodes — time update, render (prologue + the
render kernel: ``raytrace`` for ``RenderMode.Raytracer``, ``rasterize``
for ``RenderMode.Rasterizer``), export flatten — run eagerly on the device.

Fixed reference quirks (documented divergences, as in the JAX package):
  * camera_{position,rotation}_tensor shapes use the camera count
    (the reference sizes them with ``totalNumInstances``,
    ``src/mgr.cpp:652,662``).
  * the raytracer honors ``batch_render_view_height`` (the reference
    renders width×width, ``src/mgr.cpp:130,443``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .assets.importer import load_render_assets
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
from .ops import raster_cuda, raytrace_cuda
from .ops.ssaa import downsample_frames, upsample_depth
from .ops.warmstart import raytrace_warmstart
from .tensor import Tensor

TIME_DELTA = 0.05  # timeUpdateSys increment (reference src/sim.cpp:73-77)


def select_device(device: Optional[str], gpu_id: int) -> torch.device:
    """The torch device a Manager runs on: ``device`` when given, else the
    card ``cuda:{gpu_id}`` (``cuda:0`` for -1 or an out-of-range id).
    Raises when no card is present and none is named — never a silent CPU
    fallback. Turns TF32 off for matmuls and convolutions (the counterpart
    of the JAX package's ``utils/precision.py`` ``f32_precise``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    n = torch.cuda.device_count()
    return torch.device("cuda", gpu_id if 0 <= gpu_id < n else 0)


def _check_config(cfg: ManagerConfig) -> None:
    """Options outside the ported slice raise, naming their ROADMAP item."""
    if cfg.impl != "auto":
        raise ValueError(
            f"impl={cfg.impl!r}: the port picks its implementation from the "
            "device (the CUDA kernel on the card, plain PyTorch on the CPU)"
        )
    if int(cfg.ssaa) < 1 or int(cfg.ssaa) != cfg.ssaa:
        raise ValueError(f"ssaa={cfg.ssaa} must be a positive integer")
    if cfg.num_devices > 1:  # the JAX Manager runs 0 or fewer on one device
        raise NotImplementedError(
            f"num_devices={cfg.num_devices} is not ported yet — ROADMAP Queue 1 item 15"
        )
    if cfg.warmstart and cfg.render_mode != RenderMode.Raytracer:
        # The JAX Manager's gate (manager.py:241-246).
        raise NotImplementedError(
            "warmstart=True is a Raytracer feature (the raster path has no "
            "segmask to drive the repair pass)"
        )


class Manager:
    """Batch renderer over ``num_worlds`` independent worlds."""

    RenderMode = RenderMode

    def __init__(self, cfg: ManagerConfig):
        self.cfg = cfg
        rcfg = cfg.rcfg
        if len(rcfg.worlds) != cfg.num_worlds:
            raise ValueError(
                f"num_worlds={cfg.num_worlds} but {len(rcfg.worlds)} WorldInit entries"
            )
        _check_config(cfg)
        self.device = select_device(cfg.device, cfg.gpu_id)

        # --- Asset import + scene bake (init-time, host) ---
        assets = load_render_assets(
            rcfg.geo_cfg,
            rcfg.asset_paths,
            rcfg.additional_mats,
            rcfg.additional_textures,
        )
        self.scene: SceneData = bake_scene(
            assets, self.device, mipmaps=cfg.mipmaps
        )

        # --- World/ECS state init ---
        self.state: SimState = init_state(
            rcfg.instances, rcfg.cameras, rcfg.worlds, self.device
        )
        raytrace_cuda.check_accel(cfg.accel)
        raytrace_cuda.check_supported(self.state, self.scene, cfg.texture_filter, cfg.accel)

        # --- Flat export index maps (world-major, matching the reference's
        # cross-world-concatenated export columns, src/sim.cpp:113-119) ---
        inst_w, inst_slot = [], []
        cam_w, cam_slot = [], []
        for w, winit in enumerate(rcfg.worlds):
            for i in range(winit.num_instances):
                inst_w.append(w)
                inst_slot.append(i)
            for c in range(winit.num_cameras):
                cam_w.append(w)
                cam_slot.append(c)
        self._inst_w = np.asarray(inst_w, np.int64)
        self._inst_slot = np.asarray(inst_slot, np.int64)
        self._cam_w = np.asarray(cam_w, np.int64)
        self._cam_slot = np.asarray(cam_slot, np.int64)
        self.total_num_instances = len(inst_w)
        self.total_num_cameras = len(cam_w)
        self._t_cam_w = torch.from_numpy(self._cam_w).to(self.device)
        self._t_cam_slot = torch.from_numpy(self._cam_slot).to(self.device)

        # --- Live host mirrors for the in-place mutation contract, plus
        # host-side padded templates so the per-step upload is a scatter
        # and one transfer, with no device→host readback ---
        self._tpl_inst_pos = self.state.instance_pos.cpu().numpy().copy()
        self._tpl_inst_rot = self.state.instance_rot.cpu().numpy().copy()
        self._tpl_cam_pos = self.state.camera_pos.cpu().numpy().copy()
        self._tpl_cam_rot = self.state.camera_rot.cpu().numpy().copy()
        self._mirror_inst_pos = self._tpl_inst_pos[self._inst_w, self._inst_slot].copy()
        self._mirror_inst_rot = self._tpl_inst_rot[self._inst_w, self._inst_slot].copy()
        self._mirror_cam_pos = self._tpl_cam_pos[self._cam_w, self._cam_slot].copy()
        self._mirror_cam_rot = self._tpl_cam_rot[self._cam_w, self._cam_slot].copy()

        # Dirty tracking: a mirror can only change after its tensor has been
        # handed out, so "dirty" = exported AND bytes differ from the last
        # uploaded snapshot. Untouched steps skip the upload entirely.
        self._mirror_exported = {
            "inst_pos": False, "inst_rot": False,
            "cam_pos": False, "cam_rot": False,
        }
        self._mirror_snapshot = {
            "inst_pos": self._mirror_inst_pos.copy(),
            "inst_rot": self._mirror_inst_rot.copy(),
            "cam_pos": self._mirror_cam_pos.copy(),
            "cam_rot": self._mirror_cam_rot.copy(),
        }

        self._step_fn = self._build_step_fn()
        self._frames: Optional[Frames] = None
        self._flat_frames = None
        # warmstart=True: the previous frame's depth seeds the next render
        # (ops/warmstart.py); the first step's seed is far everywhere.
        self._prev_depth = None
        if cfg.warmstart:
            self._prev_depth = torch.full(
                (cfg.num_worlds, self.state.max_cameras, cfg.batch_render_view_height,
                 cfg.batch_render_view_width),
                float(cfg.far_plane), dtype=torch.float32, device=self.device)

        # Prime first observations, exactly like the reference ctor
        # (src/mgr.cpp:524).
        self.step()

    # ------------------------------------------------------------------ #
    # Step program construction
    # ------------------------------------------------------------------ #
    def _build_step_fn(self):
        cfg = self.cfg
        raster = cfg.render_mode == RenderMode.Rasterizer
        render = raster_cuda.rasterize if raster else raytrace_cuda.raytrace
        # SSAA renders every view at ssaa x height and width; render_sys
        # box-filters the frames back down (ops/ssaa.py).
        ssaa = int(cfg.ssaa)
        render_kwargs = dict(
            height=cfg.batch_render_view_height * ssaa,
            width=cfg.batch_render_view_width * ssaa,
            near=cfg.raster_near_plane if raster else cfg.near_plane,
            far=cfg.far_plane,
            fov_y_degrees=cfg.fov_y_degrees,
            texture_filter=cfg.texture_filter,
            shadows=bool(cfg.shadows),
            watertight=bool(cfg.watertight),
            accel=cfg.accel,
            deferred_mxu=bool(cfg.deferred_mxu),
        )
        cam_w, cam_slot = self._t_cam_w, self._t_cam_slot

        from .core.sim import TaskGraphID
        from .ecs.taskgraph import TaskGraphManager

        # The per-step program as taskgraphs (analog of Sim::setupTasks +
        # CUDAImpl::run's graph sequence, reference src/sim.cpp:129-133 +
        # src/mgr.cpp:177-185). The carrier is a dict so render nodes can
        # add outputs alongside the evolving state.
        def time_update_sys(carry):
            # timeUpdateSys (src/sim.cpp:73-77).
            state = carry["state"]
            carry["state"] = dataclasses.replace(state, time=state.time + TIME_DELTA)
            return carry

        if cfg.warmstart:
            def render_sys(carry):
                # Seeded by the previous frame's depth, repaired where it
                # misses: bitwise a cold render (ops/warmstart.py). Under
                # SSAA the fed-back depth is at output resolution; its
                # nearest upsample is a seed like any other.
                carry["frames"] = downsample_frames(raytrace_warmstart(
                    carry["state"], carry["scene"],
                    prev_depth=upsample_depth(carry["prev_depth"], ssaa),
                    **render_kwargs), ssaa)
                return carry
        else:
            def render_sys(carry):
                carry["frames"] = downsample_frames(
                    render(carry["state"], carry["scene"], **render_kwargs), ssaa)
                return carry

        def export_flatten_sys(carry):
            # Flat [total_cams, ...] export tensors.
            frames = carry["frames"]
            carry["flat"] = (
                frames.rgb[cam_w, cam_slot],
                frames.depth[cam_w, cam_slot],
                frames.segmask[cam_w, cam_slot],
            )
            return carry

        tg = TaskGraphManager()
        step_builder = tg.init(TaskGraphID.Step.value)
        step_builder.add_to_graph(time_update_sys)
        render_builder = tg.init(TaskGraphID.Render.value)
        r_node = render_builder.add_to_graph(render_sys)
        render_builder.add_to_graph(export_flatten_sys, deps=(r_node,))
        run_graphs = tg.build_sequence()

        def step_fn(state: SimState, scene: SceneData, prev_depth=None):
            carry = run_graphs({"state": state, "scene": scene, "prev_depth": prev_depth})
            return carry["state"], carry["frames"], carry["flat"]

        return step_fn

    # ------------------------------------------------------------------ #
    # Stepping
    # ------------------------------------------------------------------ #
    def _upload_mirrors(self) -> None:
        """Host mirrors → padded device state (the in-place contract).
        Scatters into host templates (no device readback) and uploads only
        the transform arrays that were mutated since the last step."""
        table = (
            ("inst_pos", self._mirror_inst_pos, self._tpl_inst_pos,
             self._inst_w, self._inst_slot, "instance_pos"),
            ("inst_rot", self._mirror_inst_rot, self._tpl_inst_rot,
             self._inst_w, self._inst_slot, "instance_rot"),
            ("cam_pos", self._mirror_cam_pos, self._tpl_cam_pos,
             self._cam_w, self._cam_slot, "camera_pos"),
            ("cam_rot", self._mirror_cam_rot, self._tpl_cam_rot,
             self._cam_w, self._cam_slot, "camera_rot"),
        )
        updates = {}
        for name, mirror, tpl, w_idx, slot_idx, field in table:
            if not self._mirror_exported[name]:
                continue
            snap = self._mirror_snapshot[name]
            if np.array_equal(mirror, snap):
                continue
            np.copyto(snap, mirror)
            tpl[w_idx, slot_idx] = mirror
            updates[field] = torch.tensor(tpl, device=self.device)
        if updates:
            self.state = dataclasses.replace(self.state, **updates)

    def step(self) -> None:
        """Advance one step and render all views (OO path with mirrors);
        with ``warmstart`` the frames' depth seeds the next step."""
        self._upload_mirrors()
        self.state, self._frames, self._flat_frames = self._step_fn(
            self.state, self.scene, self._prev_depth
        )
        if self.cfg.warmstart:
            self._prev_depth = self._frames.depth

    def refresh_frames(self) -> None:
        """Re-render from the current state + mirror writes WITHOUT keeping
        the advanced state (the paused viewer's re-render)."""
        self._upload_mirrors()
        _, self._frames, self._flat_frames = self._step_fn(
            self.state, self.scene, self._prev_depth)

    def step_state(self, state: SimState, prev_depth=None):
        """Pure step: (state) → (state', frames, flat_frames). The input
        state is left as it was. With ``warmstart`` the render is seeded by
        ``prev_depth`` (a previous frames' depth), by default the Manager's
        carried one."""
        if self.cfg.warmstart and prev_depth is None:
            prev_depth = self._prev_depth
        return self._step_fn(state, self.scene, prev_depth)

    def render_state(self, state: SimState) -> Frames:
        """Render a state without advancing it."""
        _, frames, _ = self._step_fn(state, self.scene, self._prev_depth)
        return frames

    # ------------------------------------------------------------------ #
    # Exports (shapes per reference §3.3 of SURVEY)
    # ------------------------------------------------------------------ #
    def rgb_tensor(self) -> Tensor:
        return Tensor(device=self._flat_frames[0])

    def depth_tensor(self) -> Tensor:
        depth = self._flat_frames[1]
        if self.cfg.render_mode == RenderMode.Rasterizer:
            # Rasterizer depth carries a trailing singleton dim
            # (reference src/mgr.cpp:570-580).
            depth = depth[..., None]
        return Tensor(device=depth)

    def segmask_tensor(self) -> Tensor:
        if self.cfg.render_mode == RenderMode.Rasterizer:
            raise RuntimeError("Segmask not implemented for rasterizer")
        return Tensor(device=self._flat_frames[2])

    def instance_position_tensor(self) -> Tensor:
        self._mirror_exported["inst_pos"] = True
        return Tensor(host=self._mirror_inst_pos)

    def instance_rotation_tensor(self) -> Tensor:
        self._mirror_exported["inst_rot"] = True
        return Tensor(host=self._mirror_inst_rot)

    def camera_position_tensor(self) -> Tensor:
        self._mirror_exported["cam_pos"] = True
        return Tensor(host=self._mirror_cam_pos)

    def camera_rotation_tensor(self) -> Tensor:
        self._mirror_exported["cam_rot"] = True
        return Tensor(host=self._mirror_cam_rot)

    def rgb_device_ptr(self) -> int:
        return self.rgb_tensor().device_ptr()

    def depth_device_ptr(self) -> int:
        return self.depth_tensor().device_ptr()

    def segmask_device_ptr(self) -> int:
        return self.segmask_tensor().device_ptr()

    # Reference-named aliases (src/bindings.cpp:227-229).
    rgb_cuda_ptr = rgb_device_ptr
    depth_cuda_ptr = depth_device_ptr
    segmask_cuda_ptr = segmask_device_ptr

    def configure_lighting(self, direction=None, color=None, *, lights=None) -> None:
        """Replace the directional light(s) — the engine API's list form
        (``lights=[(dir, color), ...]``) or the single-light shorthand."""
        self.scene = configure_lighting(
            self.scene, direction, color, lights=lights
        )

    @property
    def frames(self) -> Optional[Frames]:
        """Latest padded [W, C, H, W, ...] frames."""
        return self._frames


class MadronaRenderer(Manager):
    """Drop-in constructor matching the reference Python bindings exactly
    (kwargs and order per ``src/bindings.cpp:124-222``); extra keyword
    arguments (``device=...``) go to ``ManagerConfig``."""

    def __init__(
        self,
        gpu_id: int,
        num_worlds: int,
        render_mode: RenderMode,
        batch_render_view_width: int,
        batch_render_view_height: int,
        asset_paths: Sequence[ImportedAsset] = (),
        mesh_vertices: Optional[np.ndarray] = None,
        mesh_uvs: Optional[np.ndarray] = None,
        mesh_indices: Optional[np.ndarray] = None,
        mesh_vertex_offsets: Optional[np.ndarray] = None,
        mesh_indices_offsets: Optional[np.ndarray] = None,
        mesh_materials: Optional[np.ndarray] = None,
        materials: Sequence[AdditionalMaterial] = (),
        texture_paths: Sequence[str] = (),
        instances: Sequence[ImportedInstance] = (),
        cameras: Sequence[ImportedCamera] = (),
        worlds: Sequence[WorldInit] = (),
        **extra,
    ):
        def as_arr(x, dtype, shape_tail):
            if x is None:
                return np.zeros((0,) + shape_tail, dtype)
            arr = np.asarray(x, dtype)
            if shape_tail and (arr.ndim != 1 + len(shape_tail) or arr.shape[1:] != shape_tail):
                raise ValueError(f"expected shape [-1, {shape_tail}], got {arr.shape}")
            return arr

        geo = GeometryConfig(
            vertices=as_arr(mesh_vertices, np.float32, (3,)),
            uvs=as_arr(mesh_uvs, np.float32, (2,)),
            indices=as_arr(mesh_indices, np.uint32, ()),
            mesh_vertex_offsets=as_arr(mesh_vertex_offsets, np.uint32, ()),
            mesh_index_offsets=as_arr(mesh_indices_offsets, np.uint32, ()),
            mesh_materials=as_arr(mesh_materials, np.int32, ()),
        )
        cfg = ManagerConfig(
            gpu_id=gpu_id,
            num_worlds=num_worlds,
            render_mode=render_mode,
            batch_render_view_width=batch_render_view_width,
            batch_render_view_height=batch_render_view_height,
            rcfg=RenderConfig(
                geo_cfg=geo,
                asset_paths=list(asset_paths),
                additional_mats=list(materials),
                additional_textures=list(texture_paths),
                instances=list(instances),
                cameras=list(cameras),
                worlds=list(worlds),
            ),
            **extra,
        )
        super().__init__(cfg)
