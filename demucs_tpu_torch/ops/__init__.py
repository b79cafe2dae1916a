"""Functional NN ops, the port of `demucs_tpu/ops`: plain functions on
tensors, in the JAX package's layouts. Convolutions are `F.conv*` calls;
the attention's inner product, the BiLSTM's recurrence, the DConv
sub-block, the DConv tail and the linears of int8 weights are the
hand-written CUDA kernels of `ops/cuda`. A weight may be held quantized
(`ops.quant.QuantizedWeight`)."""

from .quant import QuantizedWeight, dense, hold_quantized  # noqa: F401
from .conv import (  # noqa: F401
    conv1d,
    conv2d,
    conv_transpose1d,
    conv_transpose2d,
    freq_conv1x1_fmajor,
    freq_conv3x3_fmajor,
    freq_conv_fmajor,
    freq_convtr_fmajor,
)
from .norms import (  # noqa: F401
    gelu,
    glu,
    group_norm,
    group_norm_fmajor,
    layer_norm,
    layer_scale,
)
from .attention import linear, multihead_attention, transformer_layer  # noqa: F401
from .embeddings import create_sin_embedding, create_2d_sin_embedding  # noqa: F401
from .lstm import BiLSTMRecurrence, bilstm, bilstm_packed, pack_bilstm_layer  # noqa: F401
from .dconv import DConvSubBlock, GnGluScaleRes, dconv_sub_block, gn_glu_scale_res  # noqa: F401
from .local_attention import decay_kernel, local_attention  # noqa: F401
