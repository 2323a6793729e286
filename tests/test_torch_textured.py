"""PyTorch port: the textured path == the JAX package's.

PNG decode, the textured bake, and textured frames (nearest and bilinear)
through the port's ``raytrace`` (the plain PyTorch version of the render
kernel on the CPU) against the JAX Pallas kernel in interpret mode and the
jnp reference. The frame bar is tests/test_pallas_parity.py's: rgb within
±1 LSB, depth rtol = atol = 1e-5, segmask exact; decode and bake are bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from madrona_renderer_tpu.assets import png as j_png
from madrona_renderer_tpu.config import RenderMode
from madrona_renderer_tpu.ops.raytrace_pallas import raytrace as j_pallas
from madrona_renderer_tpu.ops.raytrace_ref import raytrace as j_ref
from madrona_renderer_tpu.runners.scenes import demo_config
from madrona_renderer_tpu.runners.scenes import demo_texture_png as j_demo_png
from madrona_renderer_tpu_torch.assets import png as t_png
from madrona_renderer_tpu_torch.assets.importer import import_image
from madrona_renderer_tpu_torch.ops import raytrace_cuda as trc
from madrona_renderer_tpu_torch.ops import shade
from madrona_renderer_tpu_torch.runners.scenes import demo_texture_png as t_demo_png

from tests.fixtures import make_checker_png
from tests.torch_helpers import (
    IDENTITY, SceneSpec, assert_frames_close, carry_over, quad_uvs, quad_xz,
    spec_from_config, to_numpy,
)


def _images():
    rng = np.random.default_rng(4)
    return {
        "checker32": make_checker_png(32, 4),
        "checker48_odd_tiles": make_checker_png(48, 6),
        "random_rgba_13x7": rng.integers(0, 256, size=(13, 7, 4), dtype=np.uint8),
        "random_rgb_9x16": rng.integers(0, 256, size=(9, 16, 3), dtype=np.uint8),
        "random_gray_5x11": rng.integers(0, 256, size=(5, 11), dtype=np.uint8),
    }


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("name", sorted(_images()))
def test_png_codec_matches_jax(name, interlace):
    """Both encoders write the same bytes; both decoders read them (and the
    other package's bytes) to the same RGBA8 texels."""
    img = _images()[name]
    jb = j_png.encode_png(img, interlace=interlace)
    tb = t_png.encode_png(img, interlace=interlace)
    assert jb == tb
    a, b = j_png.decode_png(jb), t_png.decode_png(jb)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("size", [32, 64])
def test_demo_texture_matches_jax(size):
    """The generated demo checkerboard decodes to the JAX package's texels,
    through both decoders and the port's importer."""
    a = j_png.read_png(j_demo_png(size))
    b = t_png.read_png(t_demo_png(size))
    assert a.shape == (size, size, 4)
    assert np.array_equal(a, b)
    assert np.array_equal(import_image(t_demo_png(size)), a)


def test_importer_rejects_other_formats(tmp_path):
    path = tmp_path / "tex.ktx2"
    path.write_bytes(b"\xabKTX 20\xbb")
    with pytest.raises(NotImplementedError, match="item 18"):
        import_image(str(path))
    with pytest.raises(FileNotFoundError):
        import_image(str(tmp_path / "missing.png"))


@pytest.fixture(scope="module")
def textures(tmp_path_factory):
    d = tmp_path_factory.mktemp("tex")
    rng = np.random.default_rng(12)
    out = {}
    for name, img in (("checker", make_checker_png(32, 8)),
                      ("noise", rng.integers(0, 256, size=(12, 20, 4), dtype=np.uint8))):
        path = str(d / f"{name}.png")
        j_png.write_png(path, img)
        out[name] = path
    return out


def _mixed_spec(textures):
    """Two textured quads (tiled uvs, one with negative uvs and a non-square
    texture) beside an untextured one, in front of the camera."""
    return SceneSpec(
        meshes=[quad_xz(3.0), quad_xz(3.0), quad_xz(3.0)],
        uvs=[quad_uvs(2.5), quad_uvs(1.7, -0.6), quad_uvs()],
        instances=[
            dict(position=[-6.5, 14, 0], rotation=IDENTITY, object_id=0),
            dict(position=[0, 13, 0.5], rotation=[0.98, 0.0, 0.0, 0.199], object_id=1),
            dict(position=[6.5, 15, 0], rotation=IDENTITY, object_id=2),
        ],
        cameras=[dict(position=[0, 0, 0], rotation=IDENTITY)],
        worlds=[dict(num_instances=3, instance_offset=0, num_cameras=1,
                     camera_offset=0)],
        materials=[(1, 1, 1, 1), (0.8, 0.9, 0.6, 1), (0.2, 0.9, 0.4, 1)],
        mesh_materials=[0, 1, 2],
        textures=[textures["checker"], textures["noise"]],
        material_textures=[0, 1, -1],
    )


CASES = {
    "demo2_dynamic_tex32_64": (lambda t: spec_from_config(demo_config(
        2, RenderMode.Raytracer, 64, 64, dynamic=True, textured=True,
        tex_size=32)), 64, 64),
    "demo2_tex64_40x24": (lambda t: spec_from_config(demo_config(
        2, RenderMode.Raytracer, 24, 40, dynamic=True, textured=True)), 40, 24),
    "mixed_materials_48": (_mixed_spec, 48, 48),
}


@pytest.mark.parametrize("texture_filter", ["nearest", "bilinear"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_textured_frames_match_jax(case, texture_filter, textures):
    make, height, width = CASES[case]
    j_state, j_scene = make(textures).build_jax()
    t_state, t_scene = carry_over(j_state, j_scene)
    assert trc.is_textured(t_scene)
    kw = dict(height=height, width=width, texture_filter=texture_filter)
    port = trc.raytrace(t_state, t_scene, **kw)
    assert_frames_close(j_ref(j_state, j_scene, **kw), port)
    assert_frames_close(j_pallas(j_state, j_scene, interpret=True, **kw), port)
    seg = port.segmask.numpy()
    assert (seg >= 0).any()
    # The texture shows: beside the plane, the lit faces of a textured object
    # take both checker colours each.
    rgb = port.rgb.numpy()[..., :3].reshape(-1, 3)[(seg >= 0).reshape(-1)]
    assert len(np.unique(rgb, axis=0)) > 4


@pytest.mark.parametrize("name", ["demo_tex32", "mixed"])
def test_textured_bake_bitwise(name, textures):
    """Every field of the textured bake, the texel pool included, is the JAX
    bake's, bit for bit."""
    spec = (_mixed_spec(textures) if name == "mixed" else spec_from_config(
        demo_config(2, RenderMode.Raytracer, 32, 32, textured=True, tex_size=32)))
    j_state, j_scene = spec.build_jax()
    t_state, t_scene = spec.build_torch()
    jd = to_numpy(j_scene)
    for f in dataclasses.fields(t_scene):
        a, b = jd[f.name], getattr(t_scene, f.name)
        if f.name == "fb_rows":
            assert a == b
            continue
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f.name
    assert t_scene.tex_data.shape[0] > 1 and t_scene.tex_mip_offset.shape[1] == 1
    # The numpy hand-over carries every texture field across.
    _, carried = carry_over(j_state, j_scene)
    for f in ("tex_data", "tex_offset", "tex_width", "tex_height", "mat_tex",
              "tex_mip_offset", "tex_mip_w", "tex_mip_h", "tex_fit_level"):
        assert torch.equal(getattr(carried, f), getattr(t_scene, f)), f


def test_dequant_is_the_bakes_division():
    k = torch.arange(256, dtype=torch.int32)
    a = shade.dequant(k).numpy()
    b = np.arange(256, dtype=np.float32) / np.float32(255)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_texel_pool_round_trips(textures):
    _, t_scene = _mixed_spec(textures).build_torch()
    pool = shade.texel_pool(t_scene)
    rgb = torch.stack([shade.dequant((pool >> (8 * c)) & 255) for c in range(3)], 1)
    assert torch.equal(rgb, t_scene.tex_data[:, :3])


def test_big_pool_and_mips_raise(tmp_path):
    """Past 128 rows of 128 texels the bake turns mips on and the scene
    renders through the mip route; with mipmaps=False the scene exceeds the
    in-kernel route and renders through the 9-output route (it raised,
    naming item 6, until that route was ported; tests/test_torch_epilogue.py
    holds its frames to the JAX package's), and trilinear without mips
    raises."""
    from madrona_renderer_tpu_torch.assets.importer import load_render_assets
    from madrona_renderer_tpu_torch.core.scene import bake_scene
    from madrona_renderer_tpu_torch.core.state import init_state

    spec = _mixed_spec({"checker": str(tmp_path / "big.png"),
                        "noise": str(tmp_path / "big.png")})
    t_png.write_png(spec.textures[0], make_checker_png(144, 16))
    import madrona_renderer_tpu_torch.config as tcfg

    geo, mats, insts, cams, worlds = spec._parts(tcfg)
    assets = load_render_assets(geo, [], mats, spec.textures)
    state = init_state(insts, cams, worlds, "cpu")
    mipped = bake_scene(assets, "cpu")
    assert trc.has_mips(mipped)
    frames = trc.raytrace(state, mipped, height=16, width=16, texture_filter="trilinear")
    assert (frames.segmask.numpy() >= 0).any()
    assert len(np.unique(frames.rgb.numpy().reshape(-1, 4), axis=0)) > 4
    scene = bake_scene(assets, "cpu", mipmaps=False)
    assert trc.output_mode(scene) == "nine"
    frames = trc.raytrace(state, scene, height=16, width=16)
    assert (frames.segmask.numpy() >= 0).any()
    assert len(np.unique(frames.rgb.numpy().reshape(-1, 4), axis=0)) > 4
    with pytest.raises(ValueError, match="trilinear"):
        trc.check_supported(state, scene, "trilinear")


def test_material_naming_a_missing_texture_raises():
    """A texture id past the given textures is refused at bake time, before
    any device gather could read past the texture tables."""
    import madrona_renderer_tpu_torch as tm
    from madrona_renderer_tpu_torch.runners.scenes import demo_config as t_demo
    from madrona_renderer_tpu_torch.runners.scenes import renderer_kwargs

    kw = renderer_kwargs(t_demo(1, tm.RenderMode.Raytracer, 16, 16))
    kw["materials"] = [tm.AdditionalMaterial(texture_id=0)]
    with pytest.raises(ValueError, match="names texture 0, but 0 textures"):
        tm.MadronaRenderer(0, 1, tm.RenderMode.Raytracer, 16, 16, device="cpu", **kw)
