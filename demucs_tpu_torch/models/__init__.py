"""Model graphs as torch modules: mix (B, 2, L) -> sources (B, S, 2, L)."""

import torch

from ..config import HDemucsV3Config
from .hdemucs_v3 import HDemucsV3, build_hdemucs_v3  # noqa: F401
from .htdemucs import HTDemucs, build_htdemucs, feeds_group_norm  # noqa: F401


def build_model(cfg, state_dict, device="cuda", quant_dtype=torch.float32, train=False):
    """The module of the family `cfg` belongs to (as
    `params.load_model_params` returns it from the ggml magic): dmc3 ->
    HDemucsV3, dmc4/dmc6 -> HTDemucs, on `device` ("cuda" unless the
    caller asks for "cpu"; without a GPU a CUDA request raises), for
    inference, or trainable with `train=True`. The network runs in the
    dtype of the state dict's weights (`params.cast_state_dict` for bf16);
    the weights of a quantized state dict widen to `quant_dtype` (bfloat16
    on `--bf16 --int8`, whose network stays f32, as the JAX package's)."""
    build = build_hdemucs_v3 if isinstance(cfg, HDemucsV3Config) else build_htdemucs
    return build(cfg, state_dict, device, train=train, quant_dtype=quant_dtype)


from .bag import BagOfModels, bag_select, build_bag, unrolled_model_map  # noqa: E402,F401
