"""Weight handling: the v4 and v3 schemas, state dicts, ggml files, conversion
from the JAX package's parameter trees."""

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
from .convert import from_jax_params  # noqa: F401
