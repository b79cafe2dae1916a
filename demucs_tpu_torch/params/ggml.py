"""ggml weight-file reader/writer (same binary format as the reference).

The port's copy of the numpy path of `demucs_tpu/params/ggml.py`.

File layout:

    int32 magic                  'dmc4' | 'dmc6' | 'dmc3'
    repeated records:
        int32 n_dims
        int32 name_len
        int32 ne[n_dims]         (row-major numpy shape, squeezed)
        char  name[name_len]
        fp16  data[prod(ne)]     (native checkpoint dtype)
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

GGML_MAGICS = {
    0x646D6334: "htdemucs_4s",
    0x646D6336: "htdemucs_6s",
    0x646D6333: "hdemucs_mmi",
}
MAGIC_BY_NAME = {v: k for k, v in GGML_MAGICS.items()}


def check_magic(data: bytes) -> int:
    """Validate the 4-byte magic."""
    if len(data) < 4:
        raise ValueError("truncated ggml file (no magic)")
    (magic,) = struct.unpack_from("<i", data, 0)
    if magic not in GGML_MAGICS:
        raise ValueError(f"bad ggml magic 0x{magic & 0xFFFFFFFF:08x}")
    return magic


def _load_ggml_numpy(data: bytes) -> tuple[str, dict[str, np.ndarray]]:
    magic = check_magic(data)
    offset = 4
    tensors: dict[str, np.ndarray] = {}
    n = len(data)
    try:
        while offset < n:
            n_dims, name_len = struct.unpack_from("<ii", data, offset)
            offset += 8
            if not (0 <= n_dims <= 8) or not (0 <= name_len <= 4096):
                raise ValueError(f"corrupt ggml record at offset {offset - 8}")
            ne = struct.unpack_from(f"<{n_dims}i", data, offset)
            offset += 4 * n_dims
            name = data[offset:offset + name_len].decode("utf-8")
            offset += name_len
            count = int(np.prod(ne)) if n_dims else 1
            arr = np.frombuffer(data, dtype=np.float16, count=count,
                                offset=offset)
            offset += 2 * count
            tensors[name] = arr.reshape(ne)
    except (struct.error, ValueError) as e:
        if isinstance(e, ValueError) and "ggml" in str(e):
            raise
        raise ValueError(
            f"truncated ggml file at offset {offset} "
            f"({len(tensors)} tensors read)") from e
    return GGML_MAGICS[magic], tensors


def load_ggml(path: str | Path | bytes) -> tuple[str, dict[str, np.ndarray]]:
    """Parse a ggml file (path or raw bytes) -> (model_kind, {name: fp16 array})."""
    data = Path(path).read_bytes() if isinstance(path, (str, Path)) else path
    return _load_ggml_numpy(data)


def write_ggml(path: str | Path, kind: str, tensors: dict[str, np.ndarray]):
    """Write tensors (squeezed, fp16) in the reference's ggml format."""
    magic = MAGIC_BY_NAME[kind]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", magic))
        for name, arr in tensors.items():
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            a = np.ascontiguousarray(np.squeeze(np.asarray(arr)).astype(np.float16))
            encoded = name.encode("utf-8")
            f.write(struct.pack("<ii", a.ndim, len(encoded)))
            for d in a.shape:
                f.write(struct.pack("<i", d))
            f.write(encoded)
            f.write(a.tobytes())


def load_model_params(path: str | Path | bytes):
    """One-call loader: ggml file -> (config, checked flat state dict).

    The family comes from the file's magic: `dmc4`/`dmc6` give an
    `HTDemucsConfig`, `dmc3` the `HDemucsV3Config`. Orbax checkpoint
    directories are not ported yet and raise.
    """
    from .. import config as cfgmod
    from .schema import hdemucs_v3_schema, htdemucs_schema
    from .tree import from_state_dict

    if isinstance(path, (str, Path)) and Path(path).is_dir():
        raise ValueError(f"{path}: checkpoint directories are not supported "
                         "by demucs_tpu_torch yet; pass a ggml file")
    kind, tensors = load_ggml(path)
    if kind == "htdemucs_4s":
        cfg = cfgmod.HTDEMUCS_4S
        schema = htdemucs_schema(cfg)
    elif kind == "htdemucs_6s":
        cfg = cfgmod.HTDEMUCS_6S
        schema = htdemucs_schema(cfg)
    else:
        cfg = cfgmod.HDEMUCS_V3
        schema = hdemucs_v3_schema(cfg)
    return cfg, from_state_dict(tensors, schema)
