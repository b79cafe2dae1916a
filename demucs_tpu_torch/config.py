"""Model-family configurations (Demucs v4 htdemucs 4s/6s, v3 hdemucs_mmi).

A copy of `demucs_tpu/config.py`: the port keeps its own constants so
that it never imports the JAX package. One field is added to the v3
config, `dconv_depth`, which the encoder layers it shares with v4 read.
"""

from __future__ import annotations

import dataclasses

SAMPLE_RATE = 44100
SEGMENT_LEN_SECS = 7.8
OVERLAP = 0.25
MAX_SHIFT_SECS = 0.5
TRANSITION_POWER = 1.0
SEGMENT_SAMPLES = int(SEGMENT_LEN_SECS * SAMPLE_RATE)  # 343980


@dataclasses.dataclass(frozen=True)
class HTDemucsConfig:
    """Demucs v4 Hybrid Transformer."""

    sources: tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    channels: int = 48          # encoder 0 output channels
    growth: int = 2
    depth: int = 4
    nfft: int = 4096
    # transformer
    bottom_channels: int = 512  # 0 => transformer runs at 384 (6s model)
    t_layers: int = 5
    t_heads: int = 8
    t_hidden_scale: float = 4.0
    # dconv residual branches
    dconv_comp: int = 8
    dconv_depth: int = 2
    # frequency embedding: 10 (ScaledEmbedding scale) * 0.2 (freq_emb weight)
    freq_emb_scale: float = 10.0 * 0.2

    @property
    def num_sources(self) -> int:
        return len(self.sources)

    @property
    def freq_bins(self) -> int:
        return self.nfft // 2  # 2048 after top-bin drop

    @property
    def t_dim(self) -> int:
        return self.bottom_channels or self.channels * self.growth ** (self.depth - 1)

    @property
    def enc_channels(self) -> tuple[int, ...]:
        return tuple(self.channels * self.growth ** i for i in range(self.depth))


HTDEMUCS_4S = HTDemucsConfig()
HTDEMUCS_6S = HTDemucsConfig(
    sources=("drums", "bass", "other", "vocals", "guitar", "piano"),
    bottom_channels=0,
)


@dataclasses.dataclass(frozen=True)
class HDemucsV3Config:
    """Demucs v3 Hybrid (hdemucs_mmi): BiLSTM + LocalAttention, no transformer."""

    sources: tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    channels: int = 48
    growth: int = 2
    depth: int = 6              # encoders 0-5 (4/5 are the unique shared ones)
    nfft: int = 4096
    dconv_comp: int = 4
    dconv_depth: int = 2        # read by the encoders 0-3 shared with v4
    lstm_hidden: tuple[int, int] = (192, 384)   # enc4, enc5
    local_attn_heads: int = 4
    local_attn_ndecay: int = 4
    freq_emb_scale: float = 10.0 * 0.2

    @property
    def num_sources(self) -> int:
        return len(self.sources)

    @property
    def freq_bins(self) -> int:
        return self.nfft // 2

    @property
    def enc_channels(self) -> tuple[int, ...]:
        return tuple(self.channels * self.growth ** i for i in range(4))


HDEMUCS_V3 = HDemucsV3Config()
