"""Functional NN ops, the port of `demucs_tpu/ops`: plain functions on
tensors, in the JAX package's layouts. Convolutions are `F.conv*` calls;
the attention's inner product and the BiLSTM's recurrence are the
hand-written CUDA kernels of `ops/cuda`."""

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
from .lstm import bilstm  # noqa: F401
from .local_attention import decay_kernel, local_attention  # noqa: F401
