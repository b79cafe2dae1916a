"""Model graphs as torch modules: mix (B, 2, L) -> sources (B, S, 2, L)."""

import torch

from ..config import HDemucsV3Config
from .hdemucs_v3 import HDemucsV3, build_hdemucs_v3  # noqa: F401
from .htdemucs import HTDemucs, build_htdemucs, feeds_group_norm  # noqa: F401


def build_model(cfg, state_dict, device="cpu", quant_dtype=torch.float32):
    """The inference module of the family `cfg` belongs to (as
    `params.load_model_params` returns it from the ggml magic): dmc3 ->
    HDemucsV3, dmc4/dmc6 -> HTDemucs. The network runs in the dtype of
    the state dict's weights (`params.cast_state_dict` for bf16); the
    weights of a quantized state dict widen to `quant_dtype` (bfloat16 on
    `--bf16 --int8`, whose network stays f32, as the JAX package's)."""
    if isinstance(cfg, HDemucsV3Config):
        return build_hdemucs_v3(cfg, state_dict, device, quant_dtype)
    return build_htdemucs(cfg, state_dict, device, quant_dtype=quant_dtype)


from .bag import BagOfModels, bag_select, build_bag, unrolled_model_map  # noqa: E402,F401
