"""Demucs v4 Hybrid Transformer (htdemucs 4s/6s) as a PyTorch module.

The port of `demucs_tpu/models/htdemucs.py`. `HTDemucs.forward(mix)`
is `htdemucs_segment(params, mix, cfg)`: (B, 2, L) -> (B, S, 2, L).

The modules are the torch ones Demucs itself is built from (Conv1d,
Conv2d, ConvTranspose*, GroupNorm, LayerNorm, MultiheadAttention, ...),
so their parameter names are the state-dict names of `params/schema.py`
and `load_state_dict(strict=True)` checks every name and shape. They
hold the weights; the forward passes run the functional ops of `ops/`,
which keep the JAX package's maths (one-pass norm statistics, exact-erf
GELU, the attention through the flash kernel, each DConv sub-block
through the fused kernel K5).

The frequency branch flows frequency-major, (B, F, C, T), as in the JAX
graph: the `(b f) c t` fold of the DConv branches is a reshape, and the
frequency convolutions permute to PyTorch's (B, C, F, T) view around
each `F.conv2d`. Two equivalent forms the JAX graph reaches through
flags are written here once, as its defaults take them: the last
frequency decoder emits the untrimmed bin axis and the inverse STFT
slices it (`bin_offset=2`), and the 3x3 rewrite conv's bias is added in
the GLU. `INT8_SKIPS` is the JAX package's third switch, read from the
same environment variable and off by default as there.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import dsp, ops
from ..config import HTDemucsConfig
from ..utils.device import f32_precision, on_device, resolve_device
from ..utils.progress import report_stage


# Store the encoder skips as int8 with per-channel dynamic scales, each
# dequantized to the network dtype before its decoder's skip-add (the JAX
# package's switch, demucs_tpu/models/htdemucs.py:44-68, computed there
# outside any kernel too). Env DT_INT8_SKIPS=1 enables it.
INT8_SKIPS = os.environ.get("DT_INT8_SKIPS", "0") == "1"


def _quantize_skip(x: torch.Tensor, ch_axis: int):
    """x -> (int8 q, f32 per-channel scale) when INT8_SKIPS, else x: scale
    = max(amax / 127, 1e-12) over every axis but `ch_axis`, q = x / scale
    rounded half to even and clipped to +-127."""
    if not INT8_SKIPS:
        return x
    axes = tuple(a for a in range(x.ndim) if a != ch_axis % x.ndim)
    x32 = x.float()
    scale = (x32.abs().amax(dim=axes, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(x32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def _dequant_skip(s, dtype: torch.dtype) -> torch.Tensor:
    if not INT8_SKIPS:
        return s
    q, scale = s
    return (q.float() * scale).to(dtype)


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


def feeds_group_norm(name: str) -> bool:
    """Whether parameter `name` is a DConv conv bias (sub-block index 0 or
    3). A GroupNorm(1) follows each of those convs and removes any constant
    shift of its output, so the component of the bias's gradient along
    (1, ..., 1) is zero up to rounding."""
    return ".dconv.layers." in name and name.endswith((".0.bias", ".3.bias"))


def dconv_tail(y: torch.Tensor, norm: nn.GroupNorm, scale: LayerScale,
               x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1) -> GLU -> LayerScale -> residual (the DConv expand
    tail): the kernel K4 on CUDA tensors, its plain twin on CPU tensors;
    in grad mode through `ops.GnGluScaleRes` (K4 forward, the twin
    recomputed in the backward)."""
    return ops.gn_glu_scale_res(y, norm.weight, norm.bias, scale.scale, x)


class DConv(nn.Module):
    """DConv residual branch on (B, C, T).

    Per sub-block: compress conv (k=3, dilation 2^j) -> GroupNorm(1)+GELU
    -> expand 1x1 conv -> GroupNorm(1) -> GLU -> LayerScale -> residual,
    one call of `ops.dconv_sub_block` (the kernel K5 on CUDA tensors).
    """

    def __init__(self, ch: int, comp: int, depth: int):
        super().__init__()
        self.layers = nn.ModuleList(
            _dconv_block(ch, comp, 2 ** j) for j in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.layers):
            x = ops.dconv_sub_block(x, blk, 2 ** j)
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
    variant (cross_attn, norm3) over the self-attention one. With a tensor
    parallel `tp_group` of tp ranks, the layer holds this rank's share of
    the projections (`parallel.sharding`): in_proj (3d/tp, d), linear1
    (hidden/tp, d), out_proj and linear2 with d/tp and hidden/tp input
    columns; tp must divide the heads and the hidden width."""

    def __init__(self, d: int, heads: int, hidden: int, cross: bool, tp_group=None):
        super().__init__()
        self.num_heads = heads
        self.cross = cross
        self.tp_group = tp_group
        tp = 1 if tp_group is None else dist.get_world_size(tp_group)
        if heads % tp or hidden % tp:
            raise ValueError(f"tp={tp} must divide the {heads} heads and the hidden width "
                             f"{hidden}")
        attn = nn.MultiheadAttention(d, heads, batch_first=True)
        if tp > 1:
            attn.in_proj_weight = nn.Parameter(torch.empty(3 * d // tp, d))
            attn.in_proj_bias = nn.Parameter(torch.empty(3 * d // tp))
            attn.out_proj.weight = nn.Parameter(torch.empty(d, d // tp))
        if cross:
            self.cross_attn = attn
        else:
            self.self_attn = attn
        self.linear1 = nn.Linear(d, hidden // tp)
        self.linear2 = nn.Linear(hidden // tp, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        if cross:
            self.norm3 = nn.LayerNorm(d)
        self.gamma_1 = LayerScale(d)
        self.gamma_2 = LayerScale(d)
        self.norm_out = nn.GroupNorm(1, d)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None) -> torch.Tensor:
        return ops.transformer_layer(x, kv, self, self.num_heads, group=self.tp_group)


def _pos2d(C: int, Fr: int, T1: int):
    """The 2-D embedding of the freq tokens, (1, T1 * Fr, C)."""
    pe2d = ops.create_2d_sin_embedding(C, Fr, T1)  # (C, Fr, T1)
    return np.ascontiguousarray(pe2d.transpose(2, 1, 0).reshape(1, T1 * Fr, C))


class CrossTransformer(nn.Module):
    """5-layer cross-domain transformer.

    Freq tokens are `b c fr t -> b (t fr) c` with a 2-D sincos embedding;
    time tokens get a 1-D embedding. Layers 0/2/4 are per-branch
    self-attention; layers 1/3 cross-attend (freq queries the current
    time tokens, time queries the *pre-update* freq tokens). x arrives
    F-major (B, Fr, C, T).
    """

    def __init__(self, cfg: HTDemucsConfig, tp_group=None):
        super().__init__()
        d = cfg.t_dim
        hidden = int(cfg.t_hidden_scale * d)
        self.norm_in = nn.LayerNorm(d)
        self.norm_in_t = nn.LayerNorm(d)
        self.layers = nn.ModuleList(
            CrossTransformerLayer(d, cfg.t_heads, hidden, li % 2 == 1, tp_group)
            for li in range(cfg.t_layers))
        self.layers_t = nn.ModuleList(
            CrossTransformerLayer(d, cfg.t_heads, hidden, li % 2 == 1, tp_group)
            for li in range(cfg.t_layers))

    def forward(self, x: torch.Tensor, xt: torch.Tensor, mark=None):
        """`mark(message)`, if given, is called after each layer (the
        segment's stage marks)."""
        B, Fr, C, T1 = x.shape
        T2 = xt.shape[-1]

        pos2d = on_device(_pos2d, C, Fr, T1, device=x.device)
        xtok = x.permute(0, 3, 1, 2).reshape(B, T1 * Fr, C)
        xtok = (ops.layer_norm(xtok, self.norm_in.weight, self.norm_in.bias)
                + pos2d.to(x.dtype))

        pos1d = on_device(ops.create_sin_embedding, T2, C, device=xt.device)
        ttok = xt.transpose(1, 2)
        ttok = (ops.layer_norm(ttok, self.norm_in_t.weight, self.norm_in_t.bias)
                + pos1d.to(xt.dtype))

        for li, (layer, layer_t) in enumerate(zip(self.layers, self.layers_t)):
            if layer.cross:
                old_x = xtok
                xtok = layer(xtok, ttok)
                ttok = layer_t(ttok, old_x)
            else:
                xtok = layer(xtok)
                ttok = layer_t(ttok)
            if mark is not None:
                mark(f"transformer layer {li}")

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


def normalized_inputs(mix: torch.Tensor, nfft: int, dtype: torch.dtype):
    """Both branches' inputs in the network's `dtype`, as the JAX segment
    graphs make them: the spectrum rounded to `dtype` before its
    statistics are taken, the statistics and the normalisation in f32 on
    it, the result rounded again; the time branch from the f32 mix.
    -> (x, mean, std, xt, meant, stdt), the statistics f32."""
    xs = dsp.spec_cac_fmajor(mix, nfft).to(dtype).float()
    mean, std = _mean_std_unbiased(xs, (1, 2, 3))
    x = ((xs - mean) / (std + 1e-5)).to(dtype)
    meant, stdt = _mean_std_unbiased(mix, (1, 2))
    xt = ((mix - meant) / (stdt + 1e-5)).to(dtype)
    return x, mean, std, xt, meant, stdt


def denormalized_spec(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """The decoder's spectrum denormalised in f32, rounded back to bf16 on
    a bf16 network before the (f32) inverse STFT, as the JAX graphs round
    it for their fast inverse DFT."""
    y = x.float() * std + mean
    return y.to(torch.bfloat16) if x.dtype == torch.bfloat16 else y


class HTDemucs(nn.Module):
    """htdemucs 4s/6s: forward(mix (B, 2, L)) -> (B, S, 2, L), float32.
    The network runs in the dtype of `encoder[0].conv.weight` (bfloat16
    with `--bf16`), the spectra and their statistics in f32. With a
    tensor-parallel `tp_group`, the transformer holds this rank's share of
    its projections (`CrossTransformerLayer`); every other weight is
    whole."""

    def __init__(self, cfg: HTDemucsConfig, tp_group=None):
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
        self.crosstransformer = CrossTransformer(cfg, tp_group)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        with f32_precision():
            return self._segment(mix.float())

    def remat_blocks(self) -> list[nn.Module]:
        """The modules `train.l1_loss(remat=True)` rematerializes one at a
        time: the encoder and decoder layers of both branches and the
        transformer layers."""
        return [*self.encoder, *self.tencoder, *self.decoder, *self.tdecoder,
                *self.crosstransformer.layers, *self.crosstransformer.layers_t]

    def _segment(self, mix: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, _, L = mix.shape
        S = cfg.num_sources
        wdtype = self.encoder[0].conv.weight.dtype

        # --- spectral front-end + CaC (F-major: (B, F, 2C, T)), normalized
        x, mean, std, xt, meant, stdt = normalized_inputs(mix, cfg.nfft, wdtype)

        # stage marks (no-ops unless enabled), as the JAX graph's: 1 spec
        # + 8 encoder + 1 up + t_layers transformer + 1 down + 8 decoder
        # + 2 epilogue = 26 for 5 layers
        n_stages = 2 * 2 * cfg.depth + cfg.t_layers + 5
        stage = iter(range(1, n_stages + 1))

        def mark(msg):
            report_stage(next(stage) / n_stages, msg)

        mark("spec + normalize")
        # --- encoders (interleaved, skips saved)
        saved, savedt, lengths = [], [], []
        for i in range(cfg.depth):
            lengths.append(xt.shape[-1])
            xt = self.tencoder[i](xt)
            mark(f"tencoder {i}")
            x = self.encoder[i](x)
            if i == 0:
                emb = self.freq_emb.embedding.weight          # (F/4, C0)
                x = x + cfg.freq_emb_scale * emb[None, :, :, None]
            mark(f"encoder {i}")
            saved.append(_quantize_skip(x, ch_axis=2))    # (B, F, C, T)
            savedt.append(_quantize_skip(xt, ch_axis=1))  # (B, C, T)

        # --- bottleneck transformer (with 4s channel up/downsampling);
        # the 1x1 resampler commutes with the (F*T) flatten, so it runs
        # on the F-major tensor directly
        if cfg.bottom_channels:
            x = ops.freq_conv1x1_fmajor(x, self.channel_upsampler.weight,
                                        self.channel_upsampler.bias)
            xt = ops.conv1d(xt, self.channel_upsampler_t.weight,
                            self.channel_upsampler_t.bias)
        mark("channel upsample")
        x, xt = self.crosstransformer(x, xt, mark)
        if cfg.bottom_channels:
            x = ops.freq_conv1x1_fmajor(x, self.channel_downsampler.weight,
                                        self.channel_downsampler.bias)
            xt = ops.conv1d(xt, self.channel_downsampler_t.weight,
                            self.channel_downsampler_t.bias)
        mark("channel downsample")

        # --- decoders (skips consumed innermost-first)
        for i in range(cfg.depth):
            k = cfg.depth - 1 - i
            x = self.decoder[i](x, _dequant_skip(saved[k], x.dtype))
            mark(f"decoder {i}")
            xt = self.tdecoder[i](xt, _dequant_skip(savedt[k], xt.dtype), lengths[k])
            mark(f"tdecoder {i}")

        # --- epilogue: denorm, un-CaC, ISTFT, sum with time branch
        x = denormalized_spec(x, mean, std)                  # (B, 2052, S*4, Tf)
        wave_spec = dsp.ispec_cac_fmajor(x, S, L, cfg.nfft, bin_offset=2)
        mark("istft")
        xt = (xt.float() * stdt + meant).reshape(B, S, cfg.audio_channels, L)
        out = wave_spec + xt
        mark("sum branches")
        return out


def load_module(model: nn.Module, state_dict: dict[str, torch.Tensor],
                device: str | torch.device, train: bool,
                quant_dtype: torch.dtype) -> nn.Module:
    """`model` (built on the meta device) holding `state_dict`, checked
    strictly, on `device` ("cuda" unless the caller asks for "cpu"; a CUDA
    request without a GPU raises), in eval mode, or with `train=True` in
    train mode holding its own copy of the weights, every parameter
    requiring grad. A state dict quantized by `params.quant` (`name.q`,
    `name.scale`) is held as `ops.QuantizedWeight`s widened to
    `quant_dtype`, for inference only."""
    if train and any(name.endswith(".q") for name in state_dict):
        raise ValueError("quantized weights are for inference; train from a dense state dict")
    device = resolve_device(device)
    if train:
        # the state dict's tensors would otherwise become the parameters
        # (assign=True) and the optimizer's in-place updates reach the caller
        state_dict = {k: v.detach().clone() for k, v in state_dict.items()}
    ops.hold_quantized(model, state_dict, quant_dtype)
    model.load_state_dict(state_dict, strict=True, assign=True)
    model = model.to(device).train(train)
    if train and not all(p.requires_grad for p in model.parameters()):
        raise RuntimeError(f"a parameter of the trainable {type(model).__name__} does not "
                           "require grad")
    return model


def build_htdemucs(cfg: HTDemucsConfig, state_dict: dict[str, torch.Tensor],
                   device: str | torch.device = "cuda", train: bool = False,
                   quant_dtype: torch.dtype = torch.float32, tp_group=None) -> HTDemucs:
    """An HTDemucs holding `state_dict`, as `load_module` places it. The
    module is built on the meta device, so no weights are initialised
    only to be overwritten. With `tp_group`, `state_dict` is this rank's
    slice (`parallel.shard_state_dict`)."""
    with torch.device("meta"):
        model = HTDemucs(cfg, tp_group)
    return load_module(model, state_dict, device, train, quant_dtype)
