"""ctypes binding of the native ggml parser (`native/ggml_loader.cpp`).

`load(data)` has the contract of `ggml._load_ggml_numpy`: (model kind,
{name: fp16 array}), ValueError on a bad magic or a corrupt or truncated
file. The record iteration and its bounds checks run in C++; each array
is a read-only view of its payload in `data`, as the numpy parser's are
(the JAX package's native parser copies every payload out, which made it
slower than the numpy parser it replaces). `fp16_to_fp32` is the native
widening. The library is built on first use (`native.build_and_load`),
never at import.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native

# the name is not NUL-terminated in the format: a raw pointer and its length
_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64)


def library() -> ctypes.CDLL | None:
    """The bound parser, or None where g++ is missing (`native.load`)."""
    lib = native.load("ggml_loader")
    if lib is not None and not hasattr(lib, "_bound"):
        lib.demucs_ggml_parse.restype = ctypes.c_int32
        lib.demucs_ggml_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, _CB, ctypes.c_void_p]
        lib.demucs_fp16_to_fp32.restype = None
        lib.demucs_fp16_to_fp32.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib._bound = True
    return lib


def _lib() -> ctypes.CDLL:
    lib = library()
    if lib is None:
        raise FileNotFoundError("g++ not found: the native ggml parser cannot be built")
    return lib


def load(data: bytes) -> tuple[str, dict[str, np.ndarray]]:
    from .ggml import GGML_MAGICS, check_magic

    check_magic(data)
    data = bytes(data)
    buf = ctypes.c_char_p(data)  # the bytes object's own buffer, which C reads in place
    base = ctypes.cast(buf, ctypes.c_void_p).value
    tensors: dict[str, np.ndarray] = {}

    @_CB
    def visit(_ctx, name, name_len, n_dims, shape, fp16, count):
        ne = tuple(shape[i] for i in range(n_dims))
        offset = ctypes.cast(fp16, ctypes.c_void_p).value - base
        key = ctypes.string_at(name, name_len).decode("utf-8")
        tensors[key] = np.frombuffer(data, np.float16, count, offset).reshape(ne)

    magic = _lib().demucs_ggml_parse(buf, len(data), visit, None)
    if magic == -1:
        raise ValueError("corrupt or truncated ggml file")
    if magic not in GGML_MAGICS:
        raise ValueError(f"bad ggml magic 0x{magic & 0xFFFFFFFF:08x}")
    return GGML_MAGICS[magic], tensors


def fp16_to_fp32(x: np.ndarray) -> np.ndarray:
    """fp16 -> fp32, exact (every fp16 value, subnormals, infinities and
    NaNs included, is an fp32 value)."""
    x = np.ascontiguousarray(x, dtype=np.float16)
    out = np.empty(x.shape, np.float32)
    _lib().demucs_fp16_to_fp32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size)
    return out
