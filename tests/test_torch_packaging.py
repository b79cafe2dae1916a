"""The port's packaging: `pyproject.toml` names every package of
`demucs_tpu_torch/` and ships every source file that its kernels and
native helpers compile on first use, so a non-editable install builds
what the checkout builds."""

import fnmatch
import re
import tomllib
from pathlib import Path

import pytest

from demucs_tpu_torch import native
from demucs_tpu_torch.ops.cuda import build, dconv, flash_attention, lstm, quant_matmul

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "demucs_tpu_torch"


def _setuptools() -> dict:
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]


def _kernel_files() -> list[Path]:
    """What `ops/cuda/build.py` compiles (csrc/<name>.cu of every kernel
    module's SOURCES), the headers it watches (csrc/*.cuh) and every local
    header those sources include."""
    names = set(flash_attention.SOURCES + lstm.SOURCES + dconv.SOURCES + quant_matmul.SOURCES)
    files = {build.CSRC / f"{name}.cu" for name in names} | set(build.CSRC.glob("*.cuh"))
    for cu in [f for f in files if f.suffix == ".cu"]:
        files |= {build.CSRC / inc for inc in
                  re.findall(r'^\s*#include\s+"([^"]+)"', cu.read_text(), re.M)}
    return sorted(files)


def _native_files() -> list[Path]:
    """What `native/__init__.py` compiles: native/<name>.cpp of each
    library the package loads (the WAV codec and the ggml parser)."""
    return [native.SRC_DIR / f"{name}.cpp" for name in ("wav_io", "ggml_loader")]


def _subpackages(root: Path) -> set[str]:
    """The dotted names of `root` and of every directory below it that is
    a package, reached through packages (an `__init__.py` at each level;
    build folders without one are not walked)."""
    found = {".".join(root.relative_to(REPO).parts)}
    for child in sorted(root.iterdir()):
        if (child / "__init__.py").is_file():
            found |= _subpackages(child)
    return found


def test_every_package_of_the_port_is_listed():
    listed = set(_setuptools()["packages"])
    found = _subpackages(PKG)
    assert {"demucs_tpu_torch.native", "demucs_tpu_torch.parallel"} <= found
    assert found - listed == set()


@pytest.mark.parametrize("group", ["kernels", "native"])
def test_every_compiled_source_is_package_data(group):
    files = _kernel_files() if group == "kernels" else _native_files()
    assert files and all(f.is_file() for f in files), files
    if group == "kernels":
        assert build.CSRC / "sm90.cuh" in files
    listed = set(_setuptools()["packages"])
    data = _setuptools()["package-data"]
    for f in files:
        # the deepest package holding the file, and the file's path in it
        owner = max((p for p in data if (REPO / p.replace(".", "/")) in f.parents),
                    key=len, default=None)
        assert owner in listed, f"{f.relative_to(REPO)}: no package-data entry of a package"
        rel = f.relative_to(REPO / owner.replace(".", "/")).as_posix()
        assert any(fnmatch.fnmatch(rel, glob) for glob in data[owner]), (
            f"{f.relative_to(REPO)} matches no glob of {owner}: {data[owner]}")
