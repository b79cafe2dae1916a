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

from .lstm import bilstm_recurrence, bilstm_recurrence_plain  # noqa: F401

from .dconv import (  # noqa: F401
    dconv_sub_block,
    dconv_sub_block_plain,
    gn_glu_scale_res,
    gn_glu_scale_res_plain,
)

from .quant_matmul import int8_matmul, int8_matmul_plain  # noqa: F401

KERNELS = (flash_mha, flash_mha_fwd, flash_mha_bwd, bilstm_recurrence, dconv_sub_block,
           gn_glu_scale_res, int8_matmul)
