"""Demucs v4 Hybrid Transformer (htdemucs 4s/6s) as a PyTorch module.

The port of `demucs_tpu/models/htdemucs.py`. `HTDemucs.forward(mix)`
is `htdemucs_segment(params, mix, cfg)`: (B, 2, L) -> (B, S, 2, L).

The modules are the torch ones Demucs itself is built from (Conv1d,
Conv2d, ConvTranspose*, GroupNorm, LayerNorm, MultiheadAttention, ...),
so their parameter names are the state-dict names of `params/schema.py`
and `load_state_dict(strict=True)` checks every name and shape. They
hold the weights; the forward passes run the functional ops of `ops/`,
which keep the JAX package's maths (one-pass norm statistics, exact-erf
GELU, the attention through the flash kernel).

The frequency branch flows frequency-major, (B, F, C, T), as in the JAX
graph: the `(b f) c t` fold of the DConv branches is a reshape, and the
frequency convolutions permute to PyTorch's (B, C, F, T) view around
each `F.conv2d`. Two equivalent forms the JAX graph reaches through
flags are written here once, as its defaults take them: the last
frequency decoder emits the untrimmed bin axis and the inverse STFT
slices it (`bin_offset=2`), and the 3x3 rewrite conv's bias is added in
the GLU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import dsp, ops
from ..config import HTDemucsConfig
from ..utils.device import f32_precision


class LayerScale(nn.Module):
    """Per-channel scale (Demucs `LayerScale`; parameter `scale`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))


class ScaledEmbedding(nn.Module):
    """Frequency embedding holder (parameter `embedding.weight`)."""

    def __init__(self, num_embeddings: int, dim: int):
        super().__init__()
        # an uninitialised weight: the random init of nn.Embedding on the
        # meta device imports torch's compiler stack (seconds per process)
        self.embedding = nn.Embedding(num_embeddings, dim,
                                      _weight=torch.empty(num_embeddings, dim))


def _dconv_block(ch: int, comp: int, dilation: int) -> nn.Sequential:
    """One DConv sub-block with Demucs' Sequential indices: 0 conv, 1 norm,
    2 GELU, 3 conv, 4 norm, 5 GLU, 6 LayerScale."""
    hid = ch // comp
    return nn.Sequential(
        nn.Conv1d(ch, hid, 3, padding=dilation, dilation=dilation),
        nn.GroupNorm(1, hid), nn.GELU(),
        nn.Conv1d(hid, 2 * ch, 1), nn.GroupNorm(1, 2 * ch), nn.GLU(1),
        LayerScale(ch))


def dconv_tail(y: torch.Tensor, norm: nn.GroupNorm, scale: LayerScale,
               x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1) -> GLU -> LayerScale -> residual (the DConv expand tail)."""
    y = ops.group_norm(y, norm.weight, norm.bias, 1)
    y = ops.glu(y, 1)
    y = ops.layer_scale(y, scale.scale)
    return x + y


class DConv(nn.Module):
    """DConv residual branch on (B, C, T).

    Per sub-block: compress conv (k=3, dilation 2^j) -> GroupNorm(1)+GELU
    -> expand 1x1 conv -> GroupNorm(1) -> GLU -> LayerScale -> residual.
    """

    def __init__(self, ch: int, comp: int, depth: int):
        super().__init__()
        self.layers = nn.ModuleList(
            _dconv_block(ch, comp, 2 ** j) for j in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.layers):
            dil = 2 ** j
            y = ops.conv1d(x, blk[0].weight, blk[0].bias,
                           padding=dil, dilation=dil)
            y = ops.group_norm(y, blk[1].weight, blk[1].bias, 1)
            y = ops.gelu(y)
            y = ops.conv1d(y, blk[3].weight, blk[3].bias)
            x = dconv_tail(y, blk[4], blk[6], x)
        return x


def dconv_freq(x: torch.Tensor, dconv: DConv) -> torch.Tensor:
    """DConv on the freq branch via the `(b f) c t` fold of (B, F, C, T)."""
    B, Fq, C, T = x.shape
    return dconv(x.reshape(B * Fq, C, T)).reshape(B, Fq, C, T)


class HEncLayer(nn.Module):
    """Freq encoder layer on (B, F, C, T): conv(8,1)/(4,1) + GELU ->
    DConv -> 1x1 rewrite -> GLU."""

    def __init__(self, chin: int, ch: int, cfg: HTDemucsConfig):
        super().__init__()
        self.conv = nn.Conv2d(chin, ch, (8, 1), (4, 1), (2, 0))
        self.rewrite = nn.Conv2d(ch, 2 * ch, 1)
        self.dconv = DConv(ch, cfg.dconv_comp, cfg.dconv_depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.freq_conv_fmajor(x, self.conv.weight, self.conv.bias,
                                 stride=4, padding=2)
        y = ops.gelu(y)
        y = dconv_freq(y, self.dconv)
        y = ops.freq_conv1x1_fmajor(y, self.rewrite.weight, self.rewrite.bias)
        return ops.glu(y, 2)


class TEncLayer(nn.Module):
    """Time encoder layer. Pads its input to a stride multiple first (the
    demucs convention), so no tail sample is dropped."""

    def __init__(self, chin: int, ch: int, cfg: HTDemucsConfig):
        super().__init__()
        self.conv = nn.Conv1d(chin, ch, 8, 4, 2)
        self.rewrite = nn.Conv1d(ch, 2 * ch, 1)
        self.dconv = DConv(ch, cfg.dconv_comp, cfg.dconv_depth)

    def forward(self, xt: torch.Tensor) -> torch.Tensor:
        pad = (-xt.shape[-1]) % 4
        if pad:
            xt = F.pad(xt, (0, pad))
        y = ops.conv1d(xt, self.conv.weight, self.conv.bias, stride=4, padding=2)
        y = ops.gelu(y)
        y = self.dconv(y)
        y = ops.conv1d(y, self.rewrite.weight, self.rewrite.bias)
        return ops.glu(y, 1)


class HDecLayer(nn.Module):
    """Freq decoder layer on (B, F, C, T): +skip -> 3x3 rewrite -> GLU
    -> DConv -> transposed conv(8,1)/(4,1) [+GELU unless last]. The
    2+2 freq-row trim is the conv_tr padding, except on the last layer,
    which leaves it to the inverse STFT (`bin_offset=2`)."""

    def __init__(self, chin: int, chout: int, last: bool, cfg: HTDemucsConfig):
        super().__init__()
        self.last = last
        self.conv_tr = nn.ConvTranspose2d(chin, chout, (8, 1), (4, 1))
        self.rewrite = nn.Conv2d(chin, 2 * chin, 3, padding=1)
        self.dconv = DConv(chin, cfg.dconv_comp, cfg.dconv_depth)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = ops.freq_conv3x3_fmajor(x + skip, self.rewrite.weight)
        y = ops.glu(y, 2, bias=self.rewrite.bias)
        y = dconv_freq(y, self.dconv)
        y = ops.freq_convtr_fmajor(y, self.conv_tr.weight, self.conv_tr.bias,
                                   stride=4, padding=0 if self.last else 2)
        return y if self.last else ops.gelu(y)


class TDecLayer(nn.Module):
    """Time decoder layer: +skip -> rewrite(k=3) -> GLU -> DConv ->
    transposed conv, trimmed to [2:2+out_length] [+GELU unless last]."""

    def __init__(self, chin: int, chout: int, last: bool, cfg: HTDemucsConfig):
        super().__init__()
        self.last = last
        self.conv_tr = nn.ConvTranspose1d(chin, chout, 8, 4)
        self.rewrite = nn.Conv1d(chin, 2 * chin, 3, padding=1)
        self.dconv = DConv(chin, cfg.dconv_comp, cfg.dconv_depth)

    def forward(self, xt: torch.Tensor, skip: torch.Tensor,
                out_length: int) -> torch.Tensor:
        y = ops.conv1d(xt + skip, self.rewrite.weight, self.rewrite.bias,
                       padding=1)
        y = ops.glu(y, 1)
        y = self.dconv(y)
        y = ops.conv_transpose1d(y, self.conv_tr.weight, self.conv_tr.bias,
                                 stride=4)
        y = y[:, :, 2:2 + out_length]
        return y if self.last else ops.gelu(y)


class CrossTransformerLayer(nn.Module):
    """One transformer encoder layer; `cross` picks the cross-attention
    variant (cross_attn, norm3) over the self-attention one."""

    def __init__(self, d: int, heads: int, hidden: int, cross: bool):
        super().__init__()
        self.num_heads = heads
        self.cross = cross
        attn = nn.MultiheadAttention(d, heads, batch_first=True)
        if cross:
            self.cross_attn = attn
        else:
            self.self_attn = attn
        self.linear1 = nn.Linear(d, hidden)
        self.linear2 = nn.Linear(hidden, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        if cross:
            self.norm3 = nn.LayerNorm(d)
        self.gamma_1 = LayerScale(d)
        self.gamma_2 = LayerScale(d)
        self.norm_out = nn.GroupNorm(1, d)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None) -> torch.Tensor:
        return ops.transformer_layer(x, kv, self, self.num_heads)


class CrossTransformer(nn.Module):
    """5-layer cross-domain transformer.

    Freq tokens are `b c fr t -> b (t fr) c` with a 2-D sincos embedding;
    time tokens get a 1-D embedding. Layers 0/2/4 are per-branch
    self-attention; layers 1/3 cross-attend (freq queries the current
    time tokens, time queries the *pre-update* freq tokens). x arrives
    F-major (B, Fr, C, T).
    """

    def __init__(self, cfg: HTDemucsConfig):
        super().__init__()
        d = cfg.t_dim
        hidden = int(cfg.t_hidden_scale * d)
        self.norm_in = nn.LayerNorm(d)
        self.norm_in_t = nn.LayerNorm(d)
        self.layers = nn.ModuleList(
            CrossTransformerLayer(d, cfg.t_heads, hidden, li % 2 == 1)
            for li in range(cfg.t_layers))
        self.layers_t = nn.ModuleList(
            CrossTransformerLayer(d, cfg.t_heads, hidden, li % 2 == 1)
            for li in range(cfg.t_layers))

    def forward(self, x: torch.Tensor, xt: torch.Tensor):
        B, Fr, C, T1 = x.shape
        T2 = xt.shape[-1]

        pe2d = ops.create_2d_sin_embedding(C, Fr, T1)  # (C, Fr, T1)
        pos2d = torch.from_numpy(pe2d.transpose(2, 1, 0).reshape(1, T1 * Fr, C))
        xtok = x.permute(0, 3, 1, 2).reshape(B, T1 * Fr, C)
        xtok = (ops.layer_norm(xtok, self.norm_in.weight, self.norm_in.bias)
                + pos2d.to(x.device, x.dtype))

        pos1d = torch.from_numpy(ops.create_sin_embedding(T2, C))
        ttok = xt.transpose(1, 2)
        ttok = (ops.layer_norm(ttok, self.norm_in_t.weight, self.norm_in_t.bias)
                + pos1d.to(xt.device, xt.dtype))

        for layer, layer_t in zip(self.layers, self.layers_t):
            if layer.cross:
                old_x = xtok
                xtok = layer(xtok, ttok)
                ttok = layer_t(ttok, old_x)
            else:
                xtok = layer(xtok)
                ttok = layer_t(ttok)

        x = xtok.reshape(B, T1, Fr, C).permute(0, 2, 3, 1)  # F-major
        return x, ttok.transpose(1, 2)


def _mean_std_unbiased(x: torch.Tensor, dims):
    """(mean, torch.Tensor.std) over dims in one pass, keepdim:
    unbiased variance via (E[x^2] - mean^2) * n/(n-1)."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    mean = x.mean(dims, keepdim=True)
    mean2 = x.square().mean(dims, keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0) * (n / (n - 1))
    return mean, torch.sqrt(var)


class HTDemucs(nn.Module):
    """htdemucs 4s/6s: forward(mix (B, 2, L)) -> (B, S, 2, L), float32."""

    def __init__(self, cfg: HTDemucsConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.enc_channels
        cac_in = 2 * cfg.audio_channels
        self.encoder = nn.ModuleList(
            HEncLayer(cac_in if i == 0 else chans[i - 1], ch, cfg)
            for i, ch in enumerate(chans))
        self.tencoder = nn.ModuleList(
            TEncLayer(cfg.audio_channels if i == 0 else chans[i - 1], ch, cfg)
            for i, ch in enumerate(chans))
        decoder, tdecoder = [], []
        for i in range(cfg.depth):
            chin = chans[-1] // cfg.growth ** i
            last = i == cfg.depth - 1
            chout_f = cac_in * cfg.num_sources if last else chin // cfg.growth
            chout_t = cfg.audio_channels * cfg.num_sources if last else chin // cfg.growth
            decoder.append(HDecLayer(chin, chout_f, last, cfg))
            tdecoder.append(TDecLayer(chin, chout_t, last, cfg))
        self.decoder = nn.ModuleList(decoder)
        self.tdecoder = nn.ModuleList(tdecoder)
        self.freq_emb = ScaledEmbedding(cfg.freq_bins // 4, cfg.channels)
        if cfg.bottom_channels:
            bc, ch = cfg.bottom_channels, chans[-1]
            self.channel_upsampler = nn.Conv1d(ch, bc, 1)
            self.channel_upsampler_t = nn.Conv1d(ch, bc, 1)
            self.channel_downsampler = nn.Conv1d(bc, ch, 1)
            self.channel_downsampler_t = nn.Conv1d(bc, ch, 1)
        self.crosstransformer = CrossTransformer(cfg)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        with f32_precision():
            return self._segment(mix.float())

    def _segment(self, mix: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, _, L = mix.shape
        S = cfg.num_sources

        # --- spectral front-end + CaC (F-major: (B, F, 2C, T)), normalized
        x = dsp.spec_cac_fmajor(mix, cfg.nfft)
        mean, std = _mean_std_unbiased(x, (1, 2, 3))
        x = (x - mean) / (std + 1e-5)
        meant, stdt = _mean_std_unbiased(mix, (1, 2))
        xt = (mix - meant) / (stdt + 1e-5)

        # --- encoders (interleaved, skips saved)
        saved, savedt, lengths = [], [], []
        for i in range(cfg.depth):
            lengths.append(xt.shape[-1])
            xt = self.tencoder[i](xt)
            x = self.encoder[i](x)
            if i == 0:
                emb = self.freq_emb.embedding.weight          # (F/4, C0)
                x = x + cfg.freq_emb_scale * emb[None, :, :, None]
            saved.append(x)
            savedt.append(xt)

        # --- bottleneck transformer (with 4s channel up/downsampling);
        # the 1x1 resampler commutes with the (F*T) flatten, so it runs
        # on the F-major tensor directly
        if cfg.bottom_channels:
            x = ops.freq_conv1x1_fmajor(x, self.channel_upsampler.weight,
                                        self.channel_upsampler.bias)
            xt = ops.conv1d(xt, self.channel_upsampler_t.weight,
                            self.channel_upsampler_t.bias)
        x, xt = self.crosstransformer(x, xt)
        if cfg.bottom_channels:
            x = ops.freq_conv1x1_fmajor(x, self.channel_downsampler.weight,
                                        self.channel_downsampler.bias)
            xt = ops.conv1d(xt, self.channel_downsampler_t.weight,
                            self.channel_downsampler_t.bias)

        # --- decoders (skips consumed innermost-first)
        for i in range(cfg.depth):
            k = cfg.depth - 1 - i
            x = self.decoder[i](x, saved[k])
            xt = self.tdecoder[i](xt, savedt[k], lengths[k])

        # --- epilogue: denorm, un-CaC, ISTFT, sum with time branch
        x = x * std + mean                                   # (B, 2052, S*4, Tf)
        wave_spec = dsp.ispec_cac_fmajor(x, S, L, cfg.nfft, bin_offset=2)
        xt = (xt * stdt + meant).reshape(B, S, cfg.audio_channels, L)
        return wave_spec + xt


def build_htdemucs(cfg: HTDemucsConfig, state_dict: dict[str, torch.Tensor],
                   device: str | torch.device = "cpu") -> HTDemucs:
    """An eval-mode HTDemucs on `device` holding `state_dict` (checked
    strictly). The module is built on the meta device, so no weights
    are initialised only to be overwritten."""
    with torch.device("meta"):
        model = HTDemucs(cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model.to(device).eval()
