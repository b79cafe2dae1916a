"""Flat parameter schemas: PyTorch state-dict name -> full tensor shape.

The port's copy of `demucs_tpu/params/schema.py`. It enumerates every
weight of Demucs v4 (`htdemucs_schema`: 533 tensors for htdemucs-4s,
525 for htdemucs-6s) and of Demucs v3 (`hdemucs_v3_schema`) with its
unsqueezed shape (the ggml files store squeezed tensors).
`models.htdemucs.HTDemucs` and `models.hdemucs_v3.HDemucsV3` build the
same names from torch modules, so each is checked against its schema.
"""

from __future__ import annotations

from ..config import HDemucsV3Config, HTDemucsConfig


def _dconv_entries(prefix: str, ch: int, comp: int, depth: int = 2):
    """DConv residual branch: Sequential indices 0 conv / 1 norm / 3 conv /
    4 norm / 6 LayerScale."""
    hid = ch // comp
    out = {}
    for j in range(depth):
        p = f"{prefix}.layers.{j}"
        out[f"{p}.0.weight"] = (hid, ch, 3)
        out[f"{p}.0.bias"] = (hid,)
        out[f"{p}.1.weight"] = (hid,)
        out[f"{p}.1.bias"] = (hid,)
        out[f"{p}.3.weight"] = (2 * ch, hid, 1)
        out[f"{p}.3.bias"] = (2 * ch,)
        out[f"{p}.4.weight"] = (2 * ch,)
        out[f"{p}.4.bias"] = (2 * ch,)
        out[f"{p}.6.scale"] = (ch,)
    return out


def _transformer_layer_entries(prefix: str, d: int, hidden: int, cross: bool):
    attn = "cross_attn" if cross else "self_attn"
    out = {
        f"{prefix}.{attn}.in_proj_weight": (3 * d, d),
        f"{prefix}.{attn}.in_proj_bias": (3 * d,),
        f"{prefix}.{attn}.out_proj.weight": (d, d),
        f"{prefix}.{attn}.out_proj.bias": (d,),
        f"{prefix}.linear1.weight": (hidden, d),
        f"{prefix}.linear1.bias": (hidden,),
        f"{prefix}.linear2.weight": (d, hidden),
        f"{prefix}.linear2.bias": (d,),
        f"{prefix}.norm1.weight": (d,),
        f"{prefix}.norm1.bias": (d,),
        f"{prefix}.norm2.weight": (d,),
        f"{prefix}.norm2.bias": (d,),
        f"{prefix}.gamma_1.scale": (d,),
        f"{prefix}.gamma_2.scale": (d,),
        f"{prefix}.norm_out.weight": (d,),
        f"{prefix}.norm_out.bias": (d,),
    }
    if cross:
        out[f"{prefix}.norm3.weight"] = (d,)
        out[f"{prefix}.norm3.bias"] = (d,)
    return out


def htdemucs_schema(cfg: HTDemucsConfig) -> dict[str, tuple[int, ...]]:
    """All 533 (4s) / 525 (6s) tensors of Demucs v4, keyed by torch names."""
    s: dict[str, tuple[int, ...]] = {}
    chans = cfg.enc_channels  # (48, 96, 192, 384)
    cac_in = 2 * cfg.audio_channels  # 4

    # --- encoders (freq: Conv2d over the frequency axis; time: Conv1d)
    for i, ch in enumerate(chans):
        chin_f = cac_in if i == 0 else chans[i - 1]
        chin_t = cfg.audio_channels if i == 0 else chans[i - 1]
        s[f"encoder.{i}.conv.weight"] = (ch, chin_f, 8, 1)
        s[f"encoder.{i}.conv.bias"] = (ch,)
        s[f"encoder.{i}.rewrite.weight"] = (2 * ch, ch, 1, 1)
        s[f"encoder.{i}.rewrite.bias"] = (2 * ch,)
        s.update(_dconv_entries(f"encoder.{i}.dconv", ch, cfg.dconv_comp))
        s[f"tencoder.{i}.conv.weight"] = (ch, chin_t, 8)
        s[f"tencoder.{i}.conv.bias"] = (ch,)
        s[f"tencoder.{i}.rewrite.weight"] = (2 * ch, ch, 1)
        s[f"tencoder.{i}.rewrite.bias"] = (2 * ch,)
        s.update(_dconv_entries(f"tencoder.{i}.dconv", ch, cfg.dconv_comp))

    # --- decoders (index 0 = innermost/bottleneck, applied first)
    for i in range(cfg.depth):
        chin = chans[-1] // cfg.growth ** i           # 384, 192, 96, 48
        last = i == cfg.depth - 1
        chout_f = cac_in * cfg.num_sources if last else chin // cfg.growth
        chout_t = cfg.audio_channels * cfg.num_sources if last else chin // cfg.growth
        s[f"decoder.{i}.conv_tr.weight"] = (chin, chout_f, 8, 1)
        s[f"decoder.{i}.conv_tr.bias"] = (chout_f,)
        s[f"decoder.{i}.rewrite.weight"] = (2 * chin, chin, 3, 3)
        s[f"decoder.{i}.rewrite.bias"] = (2 * chin,)
        s.update(_dconv_entries(f"decoder.{i}.dconv", chin, cfg.dconv_comp))
        s[f"tdecoder.{i}.conv_tr.weight"] = (chin, chout_t, 8)
        s[f"tdecoder.{i}.conv_tr.bias"] = (chout_t,)
        s[f"tdecoder.{i}.rewrite.weight"] = (2 * chin, chin, 3)
        s[f"tdecoder.{i}.rewrite.bias"] = (2 * chin,)
        s.update(_dconv_entries(f"tdecoder.{i}.dconv", chin, cfg.dconv_comp))

    # --- frequency embedding (512 bins after encoder 0 -> 48 channels)
    s["freq_emb.embedding.weight"] = (cfg.freq_bins // 4, cfg.channels)

    # --- channel up/downsamplers (4s only: 384 <-> bottom_channels)
    if cfg.bottom_channels:
        bc, ch = cfg.bottom_channels, chans[-1]
        for name in ("channel_upsampler", "channel_upsampler_t"):
            s[f"{name}.weight"] = (bc, ch, 1)
            s[f"{name}.bias"] = (bc,)
        for name in ("channel_downsampler", "channel_downsampler_t"):
            s[f"{name}.weight"] = (ch, bc, 1)
            s[f"{name}.bias"] = (ch,)

    # --- crosstransformer
    d = cfg.t_dim
    hidden = int(cfg.t_hidden_scale * d)
    for suffix in ("", "_t"):
        s[f"crosstransformer.norm_in{suffix}.weight"] = (d,)
        s[f"crosstransformer.norm_in{suffix}.bias"] = (d,)
        for li in range(cfg.t_layers):
            s.update(_transformer_layer_entries(
                f"crosstransformer.layers{suffix}.{li}", d, hidden,
                cross=(li % 2 == 1)))
    return s


def _v3_enc45_dconv_entries(prefix: str, ch: int, hidden: int, depth: int = 2):
    """v3 encoder-4/5 DConv: 0 conv / 1 norm / 3 BiLSTM+linear /
    4 LocalState / 5 conv / 6 norm / 8 LayerScale."""
    s = {}
    for j in range(depth):
        p = f"{prefix}.layers.{j}"
        s[f"{p}.0.weight"] = (hidden, ch, 3)
        s[f"{p}.0.bias"] = (hidden,)
        s[f"{p}.1.weight"] = (hidden,)
        s[f"{p}.1.bias"] = (hidden,)
        # 2-layer BiLSTM + skip-linear
        for layer in range(2):
            ih_in = hidden if layer == 0 else 2 * hidden
            for suffix in ("", "_reverse"):
                s[f"{p}.3.lstm.weight_ih_l{layer}{suffix}"] = (4 * hidden, ih_in)
                s[f"{p}.3.lstm.weight_hh_l{layer}{suffix}"] = (4 * hidden, hidden)
                s[f"{p}.3.lstm.bias_ih_l{layer}{suffix}"] = (4 * hidden,)
                s[f"{p}.3.lstm.bias_hh_l{layer}{suffix}"] = (4 * hidden,)
        s[f"{p}.3.linear.weight"] = (hidden, 2 * hidden)
        s[f"{p}.3.linear.bias"] = (hidden,)
        # LocalState (4 heads, 4 decays)
        for name, out_ch in (("content", hidden), ("query", hidden),
                             ("key", hidden), ("query_decay", 16),
                             ("proj", hidden)):
            s[f"{p}.4.{name}.weight"] = (out_ch, hidden, 1)
            s[f"{p}.4.{name}.bias"] = (out_ch,)
        s[f"{p}.5.weight"] = (2 * ch, hidden, 1)
        s[f"{p}.5.bias"] = (2 * ch,)
        s[f"{p}.6.weight"] = (2 * ch,)
        s[f"{p}.6.bias"] = (2 * ch,)
        s[f"{p}.8.scale"] = (ch,)
    return s


def hdemucs_v3_schema(cfg: HDemucsV3Config) -> dict[str, tuple[int, ...]]:
    """All tensors of Demucs v3 hdemucs_mmi, keyed by torch names."""
    s: dict[str, tuple[int, ...]] = {}
    chans = cfg.enc_channels  # (48, 96, 192, 384)
    cac_in = 2 * cfg.audio_channels

    # --- encoders 0-3 (same structure as v4, different dconv compression)
    for i, ch in enumerate(chans):
        chin_f = cac_in if i == 0 else chans[i - 1]
        chin_t = cfg.audio_channels if i == 0 else chans[i - 1]
        s[f"encoder.{i}.conv.weight"] = (ch, chin_f, 8, 1)
        s[f"encoder.{i}.conv.bias"] = (ch,)
        s[f"encoder.{i}.rewrite.weight"] = (2 * ch, ch, 1, 1)
        s[f"encoder.{i}.rewrite.bias"] = (2 * ch,)
        s.update(_dconv_entries(f"encoder.{i}.dconv", ch, cfg.dconv_comp))
        s[f"tencoder.{i}.conv.weight"] = (ch, chin_t, 8)
        s[f"tencoder.{i}.conv.bias"] = (ch,)
        s[f"tencoder.{i}.rewrite.weight"] = (2 * ch, ch, 1)
        s[f"tencoder.{i}.rewrite.bias"] = (2 * ch,)
        s.update(_dconv_entries(f"tencoder.{i}.dconv", ch, cfg.dconv_comp))

    # --- tencoder 4: plain Conv1d 384 -> 768, no dconv/rewrite
    s["tencoder.4.conv.weight"] = (768, 384, 8)
    s["tencoder.4.conv.bias"] = (768,)

    # --- freq encoder 4 (with time injection) and shared encoder 5,
    # GroupNorm(4) norm1/norm2
    s["encoder.4.conv.weight"] = (768, 384, 8, 1)
    s["encoder.4.conv.bias"] = (768,)
    s["encoder.4.norm1.weight"] = (768,)
    s["encoder.4.norm1.bias"] = (768,)
    s["encoder.4.rewrite.weight"] = (1536, 768, 1, 1)
    s["encoder.4.rewrite.bias"] = (1536,)
    s["encoder.4.norm2.weight"] = (1536,)
    s["encoder.4.norm2.bias"] = (1536,)
    s.update(_v3_enc45_dconv_entries("encoder.4.dconv", 768, cfg.lstm_hidden[0]))

    s["encoder.5.conv.weight"] = (1536, 768, 4)
    s["encoder.5.conv.bias"] = (1536,)
    s["encoder.5.norm1.weight"] = (1536,)
    s["encoder.5.norm1.bias"] = (1536,)
    s["encoder.5.rewrite.weight"] = (3072, 1536, 1)
    s["encoder.5.rewrite.bias"] = (3072,)
    s["encoder.5.norm2.weight"] = (3072,)
    s["encoder.5.norm2.bias"] = (3072,)
    s.update(_v3_enc45_dconv_entries("encoder.5.dconv", 1536, cfg.lstm_hidden[1]))

    # --- shared decoder 0 and freq decoder 1
    s["decoder.0.rewrite.weight"] = (3072, 1536, 3)
    s["decoder.0.rewrite.bias"] = (3072,)
    s["decoder.0.norm1.weight"] = (3072,)
    s["decoder.0.norm1.bias"] = (3072,)
    s["decoder.0.conv_tr.weight"] = (1536, 768, 4)
    s["decoder.0.conv_tr.bias"] = (768,)
    s["decoder.0.norm2.weight"] = (768,)
    s["decoder.0.norm2.bias"] = (768,)

    s["decoder.1.rewrite.weight"] = (1536, 768, 3, 3)
    s["decoder.1.rewrite.bias"] = (1536,)
    s["decoder.1.norm1.weight"] = (1536,)
    s["decoder.1.norm1.bias"] = (1536,)
    s["decoder.1.conv_tr.weight"] = (768, 384, 8, 1)
    s["decoder.1.conv_tr.bias"] = (384,)
    s["decoder.1.norm2.weight"] = (384,)
    s["decoder.1.norm2.bias"] = (384,)

    # --- tdecoder 0: plain ConvTranspose1d 768 -> 384 + GroupNorm
    s["tdecoder.0.conv_tr.weight"] = (768, 384, 8)
    s["tdecoder.0.conv_tr.bias"] = (384,)
    s["tdecoder.0.norm2.weight"] = (384,)
    s["tdecoder.0.norm2.bias"] = (384,)

    # --- common decoders 2-5 (freq) / 1-4 (time): rewrite + conv_tr only,
    # no dconv, no norms
    for k in range(4):
        chin = chans[-1] // cfg.growth ** k  # 384, 192, 96, 48
        last = k == 3
        chout_f = cac_in * cfg.num_sources if last else chin // cfg.growth
        chout_t = cfg.audio_channels * cfg.num_sources if last else chin // cfg.growth
        fi, ti = k + 2, k + 1  # state-dict indices
        s[f"decoder.{fi}.rewrite.weight"] = (2 * chin, chin, 3, 3)
        s[f"decoder.{fi}.rewrite.bias"] = (2 * chin,)
        s[f"decoder.{fi}.conv_tr.weight"] = (chin, chout_f, 8, 1)
        s[f"decoder.{fi}.conv_tr.bias"] = (chout_f,)
        s[f"tdecoder.{ti}.rewrite.weight"] = (2 * chin, chin, 3)
        s[f"tdecoder.{ti}.rewrite.bias"] = (2 * chin,)
        s[f"tdecoder.{ti}.conv_tr.weight"] = (chin, chout_t, 8)
        s[f"tdecoder.{ti}.conv_tr.bias"] = (chout_t,)

    s["freq_emb.embedding.weight"] = (cfg.freq_bins // 4, cfg.channels)
    return s
