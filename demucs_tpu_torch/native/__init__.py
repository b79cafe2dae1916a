"""Native (C++) host helpers: the ggml parser (`ggml_loader.cpp`) and the
WAV codec (`wav_io.cpp`).

Each source has a plain C interface. It is compiled on first use with
`g++ -O3 -std=c++17 -shared -fPIC` into `demucs_tpu_torch/_build/
lib<name>.so` (gitignored) and loaded with `ctypes`; a library older than
its source is rebuilt. There is no `-march=native`: a checkout's build
directory may be read by hosts with other CPUs, and a library built for
one host's instruction set can fail to load on another. Both helpers do
integer work and exact conversions, so the flag changes no result.

Only a missing `g++` (with no current library built) sends a caller to
its numpy path; `FALLBACK` is then True. Where `g++` exists, a build or a
load that fails raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# True once a caller fell back to numpy because g++ is missing
FALLBACK = False

_loaded: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    return not lib.exists() or lib.stat().st_mtime < (SRC_DIR / f"{name}.cpp").stat().st_mtime


def build_and_load(name: str) -> ctypes.CDLL:
    """The loaded library of `native/<name>.cpp`, compiled first if it is
    missing or older than its source. Raises if g++ is missing, fails, or
    the library does not load. The library is written under a temporary
    name and renamed into place, so a concurrent loader never sees a
    partial file."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        cxx = shutil.which("g++")
        if cxx is None:
            raise FileNotFoundError(f"g++ not found: needed to build native/{name}.cpp")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native/{name}.cpp: g++ exit {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, library_path(name))
    lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def load(name: str) -> ctypes.CDLL | None:
    """`build_and_load(name)`, or None when it would have to build and g++
    is missing; the caller then takes its numpy path, and `FALLBACK` says
    so."""
    global FALLBACK
    if name not in _loaded and _stale(name) and shutil.which("g++") is None:
        FALLBACK = True
        return None
    return build_and_load(name)
