"""PyTorch port: an installed package carries its kernel sources and builds
them outside the install.

A wheel built from the tree (no network: ``--no-index --no-deps
--no-build-isolation``) holds every ``madrona_renderer_tpu_torch/csrc/*.cu``
and the header they share, ``csrc/mip_sample.cuh`` (``pyproject.toml``'s
package data); unpacked as an installed package, the
port lists every kernel source and puts its build cache in the user's cache
directory, not beside the package. A source checkout keeps ``build/``.
"""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

from madrona_renderer_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent

_INSTALLED = r"""
import sys
from pathlib import Path
from madrona_renderer_tpu_torch import _build
from madrona_renderer_tpu_torch.runners import scenes
site = Path(sys.argv[1]).resolve()
assert _build.PACKAGE.is_relative_to(site), _build.PACKAGE
for path in (_build.BUILD_DIR, scenes.ASSET_DIR):
    assert not path.is_relative_to(site), path
    assert path.is_relative_to(Path(sys.argv[2]).resolve()), path
print(" ".join(_build.sources()))
"""


def test_checkout_builds_into_build_dir():
    assert _build.cache_root() == ROOT / "build"
    assert _build.BUILD_DIR == ROOT / "build" / "torch_kernels"


def test_installed_package_caches_in_the_user_cache(tmp_path, monkeypatch):
    """Outside a checkout (no pyproject.toml beside the package) the cache is
    ``$XDG_CACHE_HOME/madrona_renderer_tpu_torch``, else under ``~/.cache``;
    a relative XDG_CACHE_HOME is ignored, as the XDG spec says."""
    package = tmp_path / "site-packages" / "madrona_renderer_tpu_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert _build.cache_root(package) == tmp_path / "xdg" / "madrona_renderer_tpu_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", "relative")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert (_build.cache_root(package)
            == tmp_path / "home" / ".cache" / "madrona_renderer_tpu_torch")


def test_wheel_holds_every_kernel_source(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(ROOT / "pyproject.toml", src)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so")
    for pkg in ("madrona_renderer_tpu", "madrona_renderer_tpu_torch"):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=ignore)
    env = dict(os.environ, PIP_NO_INDEX="1", PIP_DISABLE_PIP_VERSION_CHECK="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-q", "-w", str(tmp_path / "dist"), str(src)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    kernels = sorted(p.name for p in _build.CSRC.glob("*.cu*"))
    assert {"render_none.cu", "render_batched.cu", "render_resident.cu", "render_dmxu.cu",
            "render_mip.cu", "ladder.cu", "mip_sample.cuh"} <= set(kernels)
    missing = [k for k in kernels if f"madrona_renderer_tpu_torch/csrc/{k}" not in names]
    assert not missing, f"the wheel lacks {missing}"

    # Unpacked as an installed package: the sources are found, and the build
    # and asset caches land in the user's cache directory.
    site = tmp_path / "site"
    zipfile.ZipFile(wheel).extractall(site)
    env = dict(os.environ, PYTHONPATH=str(site), HOME=str(tmp_path / "home"),
               XDG_CACHE_HOME=str(tmp_path / "xdg"))
    proc = subprocess.run([sys.executable, "-c", _INSTALLED, str(site), str(tmp_path / "xdg")],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == [Path(k).stem for k in kernels if k.endswith(".cu")]
