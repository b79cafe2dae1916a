"""Model graphs as torch modules: mix (B, 2, L) -> sources (B, S, 2, L)."""

from .htdemucs import HTDemucs, build_htdemucs, feeds_group_norm  # noqa: F401
