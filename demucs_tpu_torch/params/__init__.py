"""Weight handling: the v4 and v3 schemas, state dicts, ggml files, checkpoint
directories, conversion from the JAX package's parameter trees, weight-only
quantization."""

from .schema import hdemucs_v3_schema, htdemucs_schema  # noqa: F401
from .tree import (  # noqa: F401
    flatten_tree,
    from_state_dict,
    init_flat,
    unflatten_tree,
)
from .ggml import (  # noqa: F401
    GGML_MAGICS,
    load_ggml,
    load_model_params,
    write_ggml,
)
from .checkpoint_io import infer_kind, load_checkpoint, save_checkpoint  # noqa: F401
from .convert import cast_state_dict, from_jax_bag_params, from_jax_params  # noqa: F401
from .quant import (  # noqa: F401
    fp8_compute_supported,
    quantize_fp8,
    quantize_int8,
    quantized_bytes,
    should_quantize,
)
