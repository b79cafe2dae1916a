"""Model graphs as torch modules: mix (B, 2, L) -> sources (B, S, 2, L)."""

from ..config import HDemucsV3Config
from .hdemucs_v3 import HDemucsV3, build_hdemucs_v3  # noqa: F401
from .htdemucs import HTDemucs, build_htdemucs, feeds_group_norm  # noqa: F401


def build_model(cfg, state_dict, device="cpu"):
    """The inference module of the family `cfg` belongs to (as
    `params.load_model_params` returns it from the ggml magic): dmc3 ->
    HDemucsV3, dmc4/dmc6 -> HTDemucs."""
    if isinstance(cfg, HDemucsV3Config):
        return build_hdemucs_v3(cfg, state_dict, device)
    return build_htdemucs(cfg, state_dict, device)
