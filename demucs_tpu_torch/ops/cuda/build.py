"""Build the package's CUDA sources into shared libraries, load them,
and launch their entry points.

Each `csrc/<name>.cu` has a plain C interface. It is compiled on first
use with `nvcc` for Hopper (`sm_90a`) into `demucs_tpu_torch/_build/
lib<name>.so` and loaded with `ctypes`; a library older than its source,
or than any shared header `csrc/*.cuh`, is rebuilt. `build()` starts one
`nvcc` per stale source, all at once, and waits for them together.
`sass_counts` reads a built library's machine code (which instructions
each kernel issues). Nothing here runs at import time.

`entry_point` and `launch` are what every kernel wrapper shares: a C
entry point bound once, and a launch on the current stream that raises
on a CUDA error.

`define_op` binds each wrapper as a torch custom op of the one namespace
`demucs_tpu_torch` (`torch.ops.demucs_tpu_torch.<name>`): its CUDA
implementation is the ctypes launch, its CPU implementation the plain
twin, and a fake implementation gives the output's shape and dtype, so
that `torch.export` records the kernel as one call in the graph of an
exported program (it cannot trace through a ctypes call). The ops are
registered through `torch.library.Library` directly. Every wrapper calls
its op (`call_op`), and the dispatcher picks the implementation by the
tensors' device: the plain twin on the CPU, the kernel on the card.
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

NAMESPACE = "demucs_tpu_torch"
LIBRARY = torch.library.Library(NAMESPACE, "DEF")


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


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point `fn(*args, stream)` on `device`'s current
    stream; raises if it returns a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def define_op(name: str, schema: str, cuda, cpu, fake):
    """Register the custom op `demucs_tpu_torch::name` with `schema` (its
    arguments and results, e.g. "(Tensor x) -> Tensor") and the three
    implementations; returns the op (`torch.ops.demucs_tpu_torch.name`'s
    overload), which dispatches on its tensors' device. The CUDA
    implementation never gives way to the CPU one."""
    LIBRARY.define(name + schema)
    LIBRARY.impl(name, cuda, "CUDA")
    LIBRARY.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def call_op(what: str, op, *args):
    """A wrapper's call of its custom op on `args`, on every path: the
    dispatcher runs the plain twin on CPU tensors and the kernel on CUDA
    tensors, and an exported program records the call. Raises first on a
    tensor that lies on neither."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{what} runs on CUDA or CPU tensors, got {a.device}")
    return op(*args)
