"""Weight handling: the v4 schema, state dicts, ggml files, conversion
from the JAX package's parameter trees."""

from .schema import htdemucs_schema  # noqa: F401
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
