"""Hand-written CUDA kernels (sources in `demucs_tpu_torch/csrc/`), their
wrappers and their plain PyTorch versions.

KERNELS lists every kernel wrapper of the port; each carries a plain
integer `launches` that counts its kernel launches.
"""

from .flash_attention import flash_mha, flash_mha_plain  # noqa: F401

KERNELS = (flash_mha,)
