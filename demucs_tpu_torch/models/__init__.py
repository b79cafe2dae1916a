"""Model graphs as torch modules: mix (B, 2, L) -> sources (B, S, 2, L)."""

import torch

from ..config import HDemucsV3Config
from .hdemucs_v3 import HDemucsV3, build_hdemucs_v3  # noqa: F401
from .htdemucs import HTDemucs, build_htdemucs, feeds_group_norm  # noqa: F401


def build_model(cfg, state_dict, device="cuda", quant_dtype=torch.float32, train=False,
                tp_group=None):
    """The module of the family `cfg` belongs to (as
    `params.load_model_params` returns it from the ggml magic): dmc3 ->
    HDemucsV3, dmc4/dmc6 -> HTDemucs, on `device` ("cuda" unless the
    caller asks for "cpu"; without a GPU a CUDA request raises), for
    inference, or trainable with `train=True`. The network runs in the
    dtype of the state dict's weights (`params.cast_state_dict` for bf16);
    the weights of a quantized state dict widen to `quant_dtype` (bfloat16
    on `--bf16 --int8`, whose network stays f32, as the JAX package's).
    `tp_group`: a tensor-parallel process group, whose rank's slice of the
    weights (`parallel.shard_state_dict`) `state_dict` is; hdemucs_mmi has
    nothing that tp shards, so it holds every weight whatever the group."""
    if isinstance(cfg, HDemucsV3Config):
        return build_hdemucs_v3(cfg, state_dict, device, train=train, quant_dtype=quant_dtype)
    return build_htdemucs(cfg, state_dict, device, train=train, quant_dtype=quant_dtype,
                          tp_group=tp_group)


from .bag import BagOfModels, bag_select, build_bag, unrolled_model_map  # noqa: E402,F401
