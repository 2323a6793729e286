"""PyTorch port: mip-mapped textures == the JAX package's.

The mip bake, the ``ops/mips.py`` helpers and mip-textured frames (nearest,
bilinear, trilinear; raytraced and rasterized; shadows; two cameras) through
the port's plain path (kernel K7's plain version on the CPU) against the
JAX package on the same inputs: the jnp reference and the Pallas kernel in
interpret mode. Bars, those tests/test_mips.py holds its own two paths to:
  * the bake and the helpers' integers bitwise;
  * rgb within 2 LSB on the smooth gradient scenes (test_mips.py:205-216),
    within 1 LSB under trilinear (test_mips.py:443-508);
  * on the overflow, shadow, raster and seam scenes, where a nearest tap
    or a level may flip at an exact boundary, at most 2% of pixels past 2 LSB
    and none past 64 (``_assert_close_modulo_boundaries``);
  * depth rtol = atol = 1e-5, segmask exact.
Each JAX render is made once per module (its compilation dominates).
"""

import dataclasses

import numpy as np
import pytest
import torch

import madrona_renderer_tpu as jm
import madrona_renderer_tpu_torch as tm
from madrona_renderer_tpu.assets.png import write_png
from madrona_renderer_tpu.core.scene import _mip_next as j_mip_next
from madrona_renderer_tpu.core.scene import configure_lighting as j_light
from madrona_renderer_tpu.ops import mips as j_mips
from madrona_renderer_tpu.ops.raster_pallas import rasterize as j_raster_pallas
from madrona_renderer_tpu.ops.raster_ref import rasterize as j_raster_ref
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu.runners.scenes import demo_config as j_demo
from madrona_renderer_tpu_torch.core.scene import _mip_next as t_mip_next
from madrona_renderer_tpu_torch.ops import mips as t_mips
from madrona_renderer_tpu_torch.ops import raster_cuda
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.ops import shade
from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo

from tests.torch_helpers import (
    IDENTITY, carry_over, checker_image, gradient_image, mip_spec,
    quad_uvs, quad_xz, to_numpy, two_quad_spec,
)


@pytest.fixture(scope="module")
def textures(tmp_path_factory):
    d = tmp_path_factory.mktemp("mip_tex")
    rng = np.random.default_rng(41)
    out = {}
    for name, img in (("gradient", gradient_image(256)),
                      ("checker", checker_image(256, 4)),
                      ("odd", rng.integers(0, 256, size=(120, 200, 4), dtype=np.uint8)),
                      ("small", rng.integers(0, 256, size=(40, 64, 4), dtype=np.uint8))):
        out[name] = str(d / f"{name}.png")
        write_png(out[name], img)
    return out


def _two_texture_spec(textures):
    spec = mip_spec(textures["odd"])
    return dataclasses.replace(
        spec, textures=[textures["odd"], textures["small"]],
        materials=[(1, 1, 1, 1), (0.9, 0.4, 0.3, 1.0)], material_textures=[0, 1],
        meshes=spec.meshes + [quad_xz(2.0, 4.0)],
        uvs=spec.uvs + [quad_uvs(3.1, -0.4)], mesh_materials=[0, 1],
        instances=spec.instances + [dict(position=[0, 0, 0], rotation=IDENTITY,
                                         scale=[1, 1, 1], object_id=1)],
        worlds=[dict(num_instances=2, instance_offset=0, num_cameras=1,
                     camera_offset=0)],
    )


BAKES = {
    "gradient256": lambda t: mip_spec(t["gradient"]),
    "checker256": lambda t: mip_spec(t["checker"]),
    "odd200x120": lambda t: mip_spec(t["odd"]),
    "two_textures": _two_texture_spec,
}


@pytest.mark.parametrize("case", sorted(BAKES))
def test_mip_bake_bitwise(case, textures):
    """Every field of the mip bake, the pool and fb_rows included, is the
    JAX bake's, bit for bit (mipmaps="auto" turns the chains on)."""
    spec = BAKES[case](textures)
    _, j_scene = spec.build_jax()
    _, t_scene = spec.build_torch()
    jd = to_numpy(j_scene)
    for f in dataclasses.fields(t_scene):
        a, b = jd[f.name], getattr(t_scene, f.name)
        if f.name == "fb_rows":
            assert a == b
            continue
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f.name
    assert trc.has_mips(t_scene)


@pytest.mark.parametrize("shape", [(8, 6), (7, 5), (1, 9), (13, 1), (256, 256), (3, 3)])
def test_mip_next_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, size=shape + (4,),
                                                     dtype=np.uint8)
    a, b = j_mip_next(img), t_mip_next(img)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_mips_off_and_explicit_off(textures):
    """A small pool keeps one level; mipmaps=False keeps one for a big one."""
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene

    spec = mip_spec(textures["small"])
    _, scene = spec.build_torch()
    assert not trc.has_mips(scene)
    geo, mats, _, _, _ = spec._parts(tm.config)
    big = load_render_assets(geo, [], mats, [textures["gradient"]])
    assert not trc.has_mips(bake_scene(big, "cpu", mipmaps=False))
    assert trc.has_mips(bake_scene(load_render_assets(geo, [], mats, [textures["small"]]),
                                   "cpu", mipmaps=True))


def test_container_mip_chains_raise():
    """Author-provided mip chains arrive only with KTX2 (ROADMAP item 18):
    a texture entry that carries its own levels is refused by the bake."""
    from types import SimpleNamespace

    from madrona_renderer_tpu_torch.assets.importer import ImportedAssets
    from madrona_renderer_tpu_torch.core.scene import bake_scene

    img = gradient_image(8)
    chain = SimpleNamespace(base=img, levels=[img, t_mip_next(img)])
    with pytest.raises(NotImplementedError, match="item 18"):
        bake_scene(ImportedAssets(textures=[chain]), "cpu")


# ------------------------------------------------------------- helpers ----
@pytest.mark.parametrize("hw", [(48, 48), (64, 256), (64, 64), (40, 24), (16, 16),
                                (32, 384), (8, 256), (100, 128)])
def test_tile_geometry_and_ids_match_jax(hw):
    h, w = hw
    geo = j_mips.tile_geometry(h, w)
    assert t_mips.tile_geometry(h, w) == geo
    a = np.asarray(j_mips.tile_ids(h, w, geo[0], geo[1]))
    b = t_mips.tile_ids(h, w, geo[0], geo[1]).numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mip_level_and_blend_match_jax():
    rng = np.random.default_rng(5)
    t = rng.uniform(0.0, 300.0, size=4096).astype(np.float32)
    tan_y = rng.uniform(0.2, 2.0, size=4096).astype(np.float32)
    dens = rng.uniform(0.0, 200.0, size=4096).astype(np.float32)
    t[:8] = 0.0
    # Exact power-of-two footprints: t (2/h) tan_y density = 2^k.
    t[8:16], tan_y[8:16], dens[8:16] = 32.0, 1.0, 2.0 ** np.arange(-1, 7)
    fp = t_mips.footprint(torch.from_numpy(t), torch.from_numpy(tan_y), 64,
                          torch.from_numpy(dens))
    lvl = t_mips.mip_level(fp, 9)
    j_lvl = np.asarray(j_mips.mip_level(t, tan_y, 64, dens, 9))
    assert np.array_equal(lvl.numpy(), j_lvl)
    assert len(np.unique(j_lvl)) == 9
    w = t_mips.mip_blend_weight(fp, lvl).numpy()
    j_w = np.asarray(j_mips.mip_blend_weight(t, tan_y, 64, dens, j_lvl))
    assert np.array_equal(w.view(np.uint32), j_w.view(np.uint32))
    near = t_mips.level_boundary_mask(fp, 9).numpy()
    assert np.array_equal(near, np.asarray(j_mips.level_boundary_mask(t, tan_y, 64, dens, 9)))
    assert near[10:16].all() and not near[8:10].any()  # boundaries are 2^1 .. 2^8


@pytest.fixture(scope="module")
def gradient_scene(textures):
    spec = mip_spec(textures["gradient"], extra_mesh=quad_xz(2.0, 4.0))
    j_state, j_scene = spec.build_jax()
    return j_state, j_scene, carry_over(j_state, j_scene)


def _random_pixels(seed, n_views, h, w, n_levels):
    rng = np.random.default_rng(seed)
    shape = (n_views, h * w)
    mat = rng.integers(0, 3, size=shape).astype(np.int32)
    uv = rng.uniform(-3.0, 5.0, size=shape + (2,)).astype(np.float32)
    # Blocks of nearby uv, so that tiles find windows that fit.
    uv[0] = rng.uniform(0.3, 0.34, size=(h * w, 2))
    level = rng.integers(0, n_levels, size=shape).astype(np.int32)
    level[1] = np.minimum(level[1], 1)
    hit = rng.uniform(size=shape) < 0.8
    blend = np.where(rng.uniform(size=shape) < 0.5, 0.0,
                     rng.uniform(0.0, 1.0, size=shape)).astype(np.float32)
    return mat, uv, level, hit, blend


@pytest.mark.parametrize("filt", ["nearest", "bilinear", "trilinear"])
@pytest.mark.parametrize("hw", [(48, 48), (64, 256)])
def test_tap_rows_window_and_clamp_match_jax(filt, hw, gradient_scene):
    """mip_tap_rows, window_base, clamp_levels and sample_texture_mip on
    random materials, uvs, levels and hit masks, on the TPU tiling (the
    48×48 view's one band with its overhang, the 64×256 view's 2D tiles):
    the integers exact, the texels bitwise."""
    _, j_scene, (_, t_scene) = gradient_scene
    h, w = hw
    L = int(j_scene.tex_mip_offset.shape[1])
    mat, uv, level, hit, blend = _random_pixels(h * 1000 + w, 3, h, w, L)
    j_tex = np.asarray(j_scene.mat_tex)[mat]
    table = shade.mip_table(t_scene)
    pool = shade.texel_pool(t_scene)
    tm_, tu, tv = torch.from_numpy(mat), torch.from_numpy(uv[..., 0]), torch.from_numpy(uv[..., 1])
    tl, th = torch.from_numpy(level), torch.from_numpy(hit)
    prim = "bilinear" if filt == "trilinear" else filt
    lo, hi = t_mips.mip_tap_rows(table, tm_, tu, tv, tl, prim)
    j_lo, j_hi = j_mips.mip_tap_rows(j_scene, j_tex, uv, level, prim)
    assert np.array_equal(lo.numpy(), np.asarray(j_lo))
    assert np.array_equal(hi.numpy(), np.asarray(j_hi))
    tile_sub, tiles_x, n_tiles = j_mips.tile_geometry(h, w)
    tid = t_mips.tile_ids(h, w, tile_sub, tiles_x)
    j_tid = j_mips.tile_ids(h, w, tile_sub, tiles_x)
    fine = th & (hi >= t_scene.fb_rows)
    base = t_mips.window_base(lo, hi, fine, tl, tid, n_tiles)
    j_base = j_mips.window_base(j_lo, j_hi, np.asarray(fine), level, j_tid, n_tiles)
    assert np.array_equal(base.numpy(), np.asarray(j_base))
    assert len(np.unique(base.numpy())) > 1
    tb = torch.from_numpy(blend)
    lvl_c, kill = t_mips.clamp_levels(table, t_scene.fb_rows, tm_, tu, tv, tl, th, tid,
                                      n_tiles, filt, tile_clamp_blend=tb)
    j_lvl_c, j_kill = j_mips.clamp_levels(j_scene, j_tex, uv, level, hit, j_tid, n_tiles,
                                          filt, tile_clamp_blend=blend)
    assert np.array_equal(lvl_c.numpy(), np.asarray(j_lvl_c))
    assert (lvl_c != tl).any()
    if filt == "trilinear":
        assert np.array_equal(kill.numpy(), np.asarray(j_kill))
    else:
        assert kill is None and j_kill is None
    col = t_mips.sample_texture_mip(table, pool, tm_, tu, tv, lvl_c, filt, blend=tb)
    j_col = np.asarray(j_mips.sample_texture_mip(j_scene, j_tex, uv, np.asarray(j_lvl_c),
                                                 filt, blend=blend))
    for c in range(3):
        assert np.array_equal(col[c].numpy().view(np.uint32),
                              j_col[..., c].view(np.uint32)), c


# -------------------------------------------------------------- frames ----
def _assert_rgb_within(ref, port, lsb):
    d = np.abs(np.asarray(ref.rgb).astype(np.int16) - port.rgb.numpy().astype(np.int16))
    assert d.max() <= lsb, d.max()


def _assert_close_modulo_boundaries(ref, port, frac=0.02, hard=64):
    """tests/test_mips.py's bar for scenes with sharp texel edges."""
    d = np.abs(np.asarray(ref.rgb).astype(np.int16) - port.rgb.numpy().astype(np.int16))
    assert d.max() <= hard, d.max()
    assert float((d.max(axis=-1) > 2).mean()) <= frac


def _assert_depth_seg(ref, port):
    np.testing.assert_allclose(np.asarray(ref.depth), port.depth.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref.segmask), port.segmask.numpy())


SUN = [((1.0, 1.0, 0.0), (1.0, 1.0, 1.0))]
# name: (scene, (height, width), mode, filter, shadows, bar)
FRAMES = {
    "smooth_nearest_48": ("gradient_quad2", (48, 48), "rt", "nearest", False, 2),
    "smooth_bilinear_48": ("gradient_quad2", (48, 48), "rt", "bilinear", False, 2),
    "smooth_nearest_64x256": ("gradient_quad2", (64, 256), "rt", "nearest", False, 2),
    "smooth_bilinear_64x256": ("gradient_quad2", (64, 256), "rt", "bilinear", False, 2),
    "overflow_clamp_32": ("overflow", (32, 32), "rt", "nearest", False, "boundaries"),
    "shadows_32": ("gradient_quad3_sun", (32, 32), "rt", "nearest", True, "boundaries"),
    "raster_32": ("gradient", (32, 32), "raster", "nearest", False, "boundaries"),
    "trilinear_48": ("gradient_quad2", (48, 48), "rt", "trilinear", False, 1),
    "trilinear_48x256": ("gradient_quad2", (48, 256), "rt", "trilinear", False, 1),
    "trilinear_raster_32": ("gradient_quad2", (32, 32), "raster", "trilinear", False, 1),
    "trilinear_shadows_32": ("gradient_quad3_sun", (32, 32), "rt", "trilinear", True, 1),
    "two_cams_bilinear_32": ("gradient_2cams", (32, 32), "rt", "bilinear", False, 2),
    "seam_bilinear_32": ("seam", (32, 32), "rt", "bilinear", False, "boundaries"),
}
SCENES = {
    "gradient": lambda t: mip_spec(t["gradient"]),
    "gradient_quad2": lambda t: mip_spec(t["gradient"], extra_mesh=quad_xz(2.0, 4.0)),
    "gradient_quad3_sun": lambda t: mip_spec(t["gradient"], extra_mesh=quad_xz(3.0, 5.0)),
    "gradient_2cams": lambda t: mip_spec(t["gradient"], extra_mesh=quad_xz(2.0, 4.0),
                                         n_worlds=2, num_cams=2),
    "overflow": lambda t: mip_spec(t["gradient"], uv_scale=63.7),
    "seam": lambda t: two_quad_spec(t["gradient"], 0.0, 0.07),
}


@pytest.fixture(scope="module")
def scenes(textures):
    out = {}
    for name, make in SCENES.items():
        j_state, j_scene = make(textures).build_jax()
        if name.endswith("_sun"):
            j_scene = j_light(j_scene, lights=SUN)
        out[name] = (j_state, j_scene, carry_over(j_state, j_scene))
    return out


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_mip_frames_match_jax(case, scenes):
    scene_name, (h, w), mode, filt, shadows, bar = FRAMES[case]
    j_state, j_scene, (t_state, t_scene) = scenes[scene_name]
    assert trc.has_mips(t_scene)
    kw = dict(height=h, width=w, texture_filter=filt, shadows=shadows)
    if mode == "raster":
        render, ref, pal = raster_cuda.rasterize, j_raster_ref, j_raster_pallas
    else:
        render, ref, pal = trc.raytrace, j_ref, j_pallas
    port = render(t_state, t_scene, **kw)
    for frames in (ref(j_state, j_scene, **kw),
                   pal(j_state, j_scene, interpret=True, **kw)):
        if bar == "boundaries":
            _assert_close_modulo_boundaries(frames, port)
        else:
            _assert_rgb_within(frames, port, bar)
        _assert_depth_seg(frames, port)
    if shadows:  # the shadow darkens something, and nothing but rgb changes
        off = render(t_state, t_scene, **dict(kw, shadows=False))
        assert (off.rgb.numpy() != port.rgb.numpy()).any()
        np.testing.assert_array_equal(off.segmask.numpy(), port.segmask.numpy())


def _levels(t_state, t_scene, filt, h=32, w=32):
    """The port's per-pixel (level, clamped level, kill) and segmask from
    its own hand-off (K7's plain version)."""
    kw = trc.pack_inputs(t_state, t_scene, height=h, width=w, texture_filter=filt)
    names = ("num_cams", "n_lights", "height", "width", "seg_div", "raster", "geo")
    _, seg, code, hf = trc.render_handoff(kw["rows"], kw["clusters"], kw["cams"],
                                          **{k: kw[k] for k in names})
    c = code.reshape(code.shape[0], -1)
    u, v, fp = hf.reshape(6, code.shape[0], -1)[:3]
    lvl, lvl_c, kill, _ = t_mips.mip_levels(kw["mats"], kw["fb_rows"], c & 0xFFFF, u, v,
                                            fp, (c & (1 << 16)) != 0, h, w, filt)
    return lvl[0].numpy(), lvl_c[0].numpy(), kill, seg.reshape(-1).numpy()


def test_clamp_and_kill_fire(textures):
    """tests/test_mips.py's per-pixel clamp scenes on the port
    (test_mips.py:591-627): a close-up's magnified pixels keep level 0
    under bilinear and trilinear, and trilinear kills the blend of some of
    them; where the close-up's bilinear taps wrap the uv seam, those pixels
    alone fall back to the coarse chain."""
    for lo, hi in ((0.40, 0.47), (0.0, 0.07)):
        j_state, j_scene = two_quad_spec(textures["gradient"], lo, hi).build_jax()
        t_state, t_scene = carry_over(j_state, j_scene)
        for filt in ("bilinear", "trilinear"):
            lvl, lvl_c, kill, seg = _levels(t_state, t_scene, filt)
            mag = (seg == 1) & (lvl == 0)
            assert mag.sum() > 100
            kept = (lvl_c[mag] == 0).mean()
            bumped = (lvl_c != lvl).sum()
            if lo == 0.0:  # the seam
                assert 0.8 < kept < 1.0 and bumped > 0
            else:
                assert kept == 1.0 and bumped == 0
            if filt == "trilinear":
                kill = kill[0].numpy()
                assert kill[mag].any() and (~kill[mag]).any()
            else:
                assert kill is None


# -------------------------------------------------------------- manager ----
def test_manager_mipmaps_and_trilinear():
    """Manager(mipmaps=True) and texture_filter="trilinear" construct, step
    and render like the JAX Manager; trilinear without mip chains raises
    ValueError, as the JAX check does; an untextured scene takes any
    filter."""
    kw = dict(dynamic=True, textured=True, tex_size=32, texture_filter="trilinear",
              mipmaps=True)
    t = tm.Manager(t_demo(2, tm.RenderMode.Raytracer, 32, 32, device="cpu", **kw))
    assert trc.has_mips(t.scene)
    t.instance_position_tensor().to_torch()[0][1] += 0.5
    t.step()
    j = jm.Manager(j_demo(2, jm.RenderMode.Raytracer, 32, 32, impl="jnp", **kw))
    j.instance_position_tensor().to_torch()[0][1] += 0.5
    j.step()
    _assert_rgb_within(j.frames, t.frames, 1)
    _assert_depth_seg(j.frames, t.frames)
    with pytest.raises(ValueError, match="trilinear"):
        tm.Manager(t_demo(1, tm.RenderMode.Raytracer, 16, 16, textured=True, tex_size=32,
                          texture_filter="trilinear", device="cpu"))
    u = tm.Manager(t_demo(1, tm.RenderMode.Raytracer, 16, 16, texture_filter="trilinear",
                          shadows=True, device="cpu"))
    assert u.rgb_tensor().to_torch().shape == (1, 16, 16, 4)


def test_mip_route_refuses_bad_inputs(scenes):
    _, _, (t_state, t_scene) = scenes["gradient"]
    kw = trc.pack_inputs(t_state, t_scene, height=16, width=16, texture_filter="bilinear")
    assert kw["fb_rows"] == t_scene.fb_rows and kw["mats"].shape[0] == 4 + 3 * 9
    with pytest.raises(ValueError, match="fb_rows"):
        trc.render_resident(**dict(kw, fb_rows=48))
    with pytest.raises(ValueError, match="mip table"):
        trc.render_resident(**dict(kw, mats=shade.material_table(t_scene)))
    with pytest.raises(ValueError, match="texture_filter"):
        trc.check_supported(t_state, t_scene, "anisotropic")
    with pytest.raises(ValueError, match="fb_rows is for textured"):
        trc.render_resident(**dict(kw, texture=None, mats=None, pool=None))
