"""Hand-written CUDA kernels (sources in `demucs_tpu_torch/csrc/`), their
wrappers and their plain PyTorch versions.

KERNELS lists every kernel wrapper of the port; each carries a plain
integer `launches` that counts its kernel launches.
"""

from .flash_attention import (  # noqa: F401
    flash_mha,
    flash_mha_bwd,
    flash_mha_bwd_plain,
    flash_mha_fwd,
    flash_mha_fwd_plain,
    flash_mha_plain,
)

KERNELS = (flash_mha, flash_mha_fwd, flash_mha_bwd)
