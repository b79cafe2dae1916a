"""Build the package's CUDA sources into shared libraries, load them,
and launch their entry points.

Each `csrc/<name>.cu` has a plain C interface. It is compiled on first
use with `nvcc` for Hopper (`sm_90a`) into `demucs_tpu_torch/_build/
lib<name>.so` and loaded with `ctypes`; a library older than its source,
or than any shared header `csrc/*.cuh`, is rebuilt. `build()` starts one
`nvcc` per stale source, all at once, and waits for them together.
`sass_counts` reads a built library's machine code (which instructions
each kernel issues). Nothing here runs at import time.

`entry_point`, `on_cpu` and `launch` are what every kernel wrapper
shares: a C entry point bound once, the choice between the plain twin
(CPU tensors) and the kernel (CUDA tensors), and a launch on the current
stream that raises on a CUDA error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the suffix of a kernel's C entry point for its operands' dtype
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict = {}  # (source, entry point) -> bound C function
# ptxas resource reports (registers, shared memory, spills) of the
# builds made by this process, by source name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in demucs_tpu_torch/csrc")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True if the library is missing or older than its source or than any
    shared header under csrc/ (a source may include any of them)."""
    lib = library_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names, force: bool = False) -> float:
    """Compile every stale source of `names` (every one with `force`) in
    parallel; returns the seconds taken.

    Each library is written under a temporary name and renamed into
    place, so a concurrent loader never sees a partial file.
    """
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = []
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def sass_counts(name: str, mnemonic: str) -> dict[str, int]:
    """How many `mnemonic` instructions (SASS, e.g. "HGMMA" for a
    warpgroup MMA) each kernel of the built library of `csrc/<name>.cu`
    holds, read with the toolkit's cuobjdump: {mangled kernel name: n}."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(library_path(name))],
                          check=True, capture_output=True, text=True, timeout=120).stdout
    counts: dict[str, int] = {}
    kernel = None
    for line in sass.splitlines():
        if "Function : " in line:
            kernel = line.split("Function : ", 1)[1].strip()
            counts[kernel] = 0
        elif kernel is not None and any(op == mnemonic or op.startswith(mnemonic + ".")
                                        for op in line.split()):
            counts[kernel] += 1
    return counts


def entry_point(source: str, name: str, n_ptrs: int, n_ints: int):
    """The C function `name` of `csrc/<source>.cu`, bound on first use: it
    takes `n_ptrs` pointers, `n_ints` ints and the stream, and returns a
    CUDA error code."""
    fn = _bound.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[(source, name)] = fn
    return fn


def on_cpu(what: str, *ts: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if none does where a
    kernel cannot run; raises on a device that is neither CPU nor CUDA."""
    if all(t.device.type == "cpu" for t in ts):
        return True
    for t in ts:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what} runs on CUDA or CPU tensors, got {t.device}")
    return False


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point `fn(*args, stream)` on `device`'s current
    stream; raises if it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
