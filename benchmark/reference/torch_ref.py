"""Plain PyTorch model of Demucs v4 (htdemucs 4s and 6s): the benchmark's
reference.

A frozen copy of `demucs_tpu_torch/tools/torch_ref.py`: an independent
torch implementation of the v4 graph, built from torch primitives
(`torch.stft`, `nn.MultiheadAttention`, `nn.GroupNorm`, ...) and none of
the port's modules or kernels, with state-dict names matching the port's
schema, so one seeded state dict loads into both. Every constant (the
Hann windows, the sinusoidal embeddings) is made on the input's device.
It is a copy, not an import, so that a change to the port cannot move
the yardstick it is held to.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------- DSP

def spec_torch(x: torch.Tensor, nfft: int = 4096, hl: int = 1024) -> torch.Tensor:
    length = x.shape[-1]
    le = int(math.ceil(length / hl))
    pad = hl // 2 * 3
    shape = x.shape
    x = x.reshape(-1, length)
    x = F.pad(x[None], (pad, pad + le * hl - length), mode="reflect")[0]
    z = torch.stft(x, n_fft=nfft, hop_length=hl,
                   window=torch.hann_window(nfft, periodic=True, device=x.device),
                   normalized=True, center=True, pad_mode="reflect",
                   return_complex=True)
    z = z[..., :-1, :][..., 2:2 + le]
    return z.reshape(shape[:-1] + z.shape[-2:])


def ispec_torch(z: torch.Tensor, length: int, nfft: int = 4096,
                hl: int = 1024) -> torch.Tensor:
    shape = z.shape
    z = z.reshape(-1, *shape[-2:])
    z = F.pad(z, (0, 0, 0, 1))
    z = F.pad(z, (2, 2))
    pad = hl // 2 * 3
    le = hl * int(math.ceil(length / hl)) + 2 * pad
    x = torch.istft(z, n_fft=nfft, hop_length=hl,
                    window=torch.hann_window(nfft, periodic=True, device=z.device),
                    normalized=True, center=True, length=le)
    x = x[..., pad:pad + length]
    return x.reshape(shape[:-2] + (length,))


def cac_pack_torch(z: torch.Tensor) -> torch.Tensor:
    B, C, Fq, T = z.shape
    m = torch.view_as_real(z).permute(0, 1, 4, 2, 3)
    return m.reshape(B, C * 2, Fq, T)


def cac_unpack_torch(m: torch.Tensor) -> torch.Tensor:
    B, S, C4, Fq, T = m.shape
    out = m.reshape(B, S, C4 // 2, 2, Fq, T).permute(0, 1, 2, 4, 5, 3)
    return torch.view_as_complex(out.contiguous())


# ---------------------------------------------------------------- modules

class LayerScale(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))

    def forward(self, x):
        return self.scale[:, None] * x


class TokenLayerScale(nn.Module):
    """LayerScale over the last (channel) axis of (B, T, C) tokens."""

    def __init__(self, ch):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))

    def forward(self, x):
        return self.scale * x


class DConv(nn.Module):
    def __init__(self, ch, comp=8, depth=2):
        super().__init__()
        hid = ch // comp
        self.layers = nn.ModuleList()
        for j in range(depth):
            dil = 2 ** j
            self.layers.append(nn.Sequential(
                nn.Conv1d(ch, hid, 3, dilation=dil, padding=dil),
                nn.GroupNorm(1, hid),
                nn.GELU(),
                nn.Conv1d(hid, 2 * ch, 1),
                nn.GroupNorm(1, 2 * ch),
                nn.GLU(1),
                LayerScale(ch),
            ))

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


class HEnc(nn.Module):
    def __init__(self, chin, chout, freq, comp=8):
        super().__init__()
        self.freq = freq
        if freq:
            self.conv = nn.Conv2d(chin, chout, (8, 1), (4, 1), (2, 0))
            self.rewrite = nn.Conv2d(chout, 2 * chout, 1)
        else:
            self.conv = nn.Conv1d(chin, chout, 8, 4, 2)
            self.rewrite = nn.Conv1d(chout, 2 * chout, 1)
        self.dconv = DConv(chout, comp)

    def forward(self, x):
        if not self.freq:
            le = x.shape[-1]
            if le % 4:
                x = F.pad(x, (0, 4 - le % 4))
        y = F.gelu(self.conv(x))
        if self.freq:
            B, C, Fq, T = y.shape
            y2 = y.permute(0, 2, 1, 3).reshape(-1, C, T)
            y2 = self.dconv(y2)
            y = y2.reshape(B, Fq, C, T).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self.rewrite(y), 1)


class HDec(nn.Module):
    def __init__(self, chin, chout, freq, last, comp=8, dconv=True):
        super().__init__()
        self.freq, self.last = freq, last
        if freq:
            self.rewrite = nn.Conv2d(chin, 2 * chin, 3, padding=1)
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (8, 1), (4, 1))
        else:
            self.rewrite = nn.Conv1d(chin, 2 * chin, 3, padding=1)
            self.conv_tr = nn.ConvTranspose1d(chin, chout, 8, 4)
        if dconv:
            self.dconv = DConv(chin, comp)
        self._has_dconv = dconv

    def forward(self, x, skip, out_length=None):
        y = x + skip
        y = F.glu(self.rewrite(y), 1)
        if self._has_dconv:
            if self.freq:
                B, C, Fq, T = y.shape
                y2 = y.permute(0, 2, 1, 3).reshape(-1, C, T)
                y2 = self.dconv(y2)
                y = y2.reshape(B, Fq, C, T).permute(0, 2, 1, 3)
            else:
                y = self.dconv(y)
        y = self.conv_tr(y)
        if not self.last:
            y = F.gelu(y)
        if self.freq:
            return y[:, :, 2:-2, :]
        return y[:, :, 2:2 + out_length]


class TLayer(nn.Module):
    """Self-attention transformer layer (demucs MyTransformerEncoderLayer)."""

    def __init__(self, d, hidden, heads=8):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d, heads, batch_first=True)
        self.linear1 = nn.Linear(d, hidden)
        self.linear2 = nn.Linear(hidden, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm_out = nn.GroupNorm(1, d)
        self.gamma_1 = TokenLayerScale(d)
        self.gamma_2 = TokenLayerScale(d)

    def forward(self, x):
        q = self.norm1(x)
        a, _ = self.self_attn(q, q, q, need_weights=False)
        x = x + self.gamma_1(a)
        h = self.linear2(F.gelu(self.linear1(self.norm2(x))))
        x = x + self.gamma_2(h)
        return self.norm_out(x.transpose(1, 2)).transpose(1, 2)


class TCrossLayer(nn.Module):
    """Cross-attention transformer layer (demucs CrossTransformerEncoderLayer)."""

    def __init__(self, d, hidden, heads=8):
        super().__init__()
        self.cross_attn = nn.MultiheadAttention(d, heads, batch_first=True)
        self.linear1 = nn.Linear(d, hidden)
        self.linear2 = nn.Linear(hidden, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm3 = nn.LayerNorm(d)
        self.norm_out = nn.GroupNorm(1, d)
        self.gamma_1 = TokenLayerScale(d)
        self.gamma_2 = TokenLayerScale(d)

    def forward(self, q, k):
        qn = self.norm1(q)
        kn = self.norm2(k)
        a, _ = self.cross_attn(qn, kn, kn, need_weights=False)
        x = q + self.gamma_1(a)
        h = self.linear2(F.gelu(self.linear1(self.norm3(x))))
        x = x + self.gamma_2(h)
        return self.norm_out(x.transpose(1, 2)).transpose(1, 2)


def sin_embedding_1d(length, dim, max_period=10000.0, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device).view(-1, 1, 1)
    half = dim // 2
    adim = torch.arange(half, dtype=torch.float32, device=device).view(1, 1, -1)
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1).permute(1, 0, 2)


def sin_embedding_2d(d_model, height, width, max_period=10000.0, device=None):
    pe = torch.zeros(d_model, height, width, device=device)
    d_model //= 2
    div_term = torch.exp(
        torch.arange(0.0, d_model, 2, device=device) * -(math.log(max_period) / d_model))
    pos_w = torch.arange(0.0, width, device=device).unsqueeze(1)
    pos_h = torch.arange(0.0, height, device=device).unsqueeze(1)
    pe[0:d_model:2] = torch.sin(pos_w * div_term).T.unsqueeze(1).repeat(1, height, 1)
    pe[1:d_model:2] = torch.cos(pos_w * div_term).T.unsqueeze(1).repeat(1, height, 1)
    pe[d_model::2] = torch.sin(pos_h * div_term).T.unsqueeze(2).repeat(1, 1, width)
    pe[d_model + 1::2] = torch.cos(pos_h * div_term).T.unsqueeze(2).repeat(1, 1, width)
    return pe


class CrossTransformer(nn.Module):
    def __init__(self, d, hidden, layers=5, heads=8):
        super().__init__()
        self.norm_in = nn.LayerNorm(d)
        self.norm_in_t = nn.LayerNorm(d)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for li in range(layers):
            cls = TCrossLayer if li % 2 else TLayer
            self.layers.append(cls(d, hidden, heads))
            self.layers_t.append(cls(d, hidden, heads))

    def forward(self, x, xt):
        B, C, Fr, T1 = x.shape
        pos2d = sin_embedding_2d(C, Fr, T1, device=x.device).permute(2, 1, 0).reshape(1, T1 * Fr, C)
        xtok = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)
        xtok = self.norm_in(xtok) + pos2d
        T2 = xt.shape[-1]
        pos1d = sin_embedding_1d(T2, C, device=xt.device)
        ttok = self.norm_in_t(xt.transpose(1, 2)) + pos1d
        for li, (lay, lay_t) in enumerate(zip(self.layers, self.layers_t)):
            if li % 2 == 0:
                xtok = lay(xtok)
                ttok = lay_t(ttok)
            else:
                old = xtok
                xtok = lay(xtok, ttok)
                ttok = lay_t(ttok, old)
        x = xtok.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        return x, ttok.transpose(1, 2)


class FreqEmb(nn.Module):
    def __init__(self, bins, ch):
        super().__init__()
        self.embedding = nn.Embedding(bins, ch)


class HTDemucsRef(nn.Module):
    """Torch oracle for Demucs v4 (4s and 6s)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        chans = list(cfg.enc_channels)
        cac_in = 2 * cfg.audio_channels
        self.encoder = nn.ModuleList()
        self.tencoder = nn.ModuleList()
        for i, ch in enumerate(chans):
            chin_f = cac_in if i == 0 else chans[i - 1]
            chin_t = cfg.audio_channels if i == 0 else chans[i - 1]
            self.encoder.append(HEnc(chin_f, ch, True, cfg.dconv_comp))
            self.tencoder.append(HEnc(chin_t, ch, False, cfg.dconv_comp))
        self.decoder = nn.ModuleList()
        self.tdecoder = nn.ModuleList()
        for i in range(cfg.depth):
            chin = chans[-1] // cfg.growth ** i
            last = i == cfg.depth - 1
            chout_f = cac_in * cfg.num_sources if last else chin // 2
            chout_t = cfg.audio_channels * cfg.num_sources if last else chin // 2
            self.decoder.append(HDec(chin, chout_f, True, last, cfg.dconv_comp))
            self.tdecoder.append(HDec(chin, chout_t, False, last, cfg.dconv_comp))
        self.freq_emb = FreqEmb(cfg.freq_bins // 4, cfg.channels)
        if cfg.bottom_channels:
            bc, ch = cfg.bottom_channels, chans[-1]
            self.channel_upsampler = nn.Conv1d(ch, bc, 1)
            self.channel_downsampler = nn.Conv1d(bc, ch, 1)
            self.channel_upsampler_t = nn.Conv1d(ch, bc, 1)
            self.channel_downsampler_t = nn.Conv1d(bc, ch, 1)
        d = cfg.t_dim
        self.crosstransformer = CrossTransformer(
            d, int(cfg.t_hidden_scale * d), cfg.t_layers, cfg.t_heads)

    def forward(self, mix):
        cfg = self.cfg
        B, _, L = mix.shape
        S = cfg.num_sources
        z = spec_torch(mix, cfg.nfft)
        x = cac_pack_torch(z)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)
        xt = mix
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = xt.std(dim=(1, 2), keepdim=True)
        xt = (xt - meant) / (1e-5 + stdt)

        saved, savedt, lengths = [], [], []
        for i in range(cfg.depth):
            lengths.append(xt.shape[-1])
            xt = self.tencoder[i](xt)
            x = self.encoder[i](x)
            if i == 0:
                emb = self.freq_emb.embedding.weight  # (bins, ch)
                x = x + cfg.freq_emb_scale * emb.t()[None, :, :, None]
            saved.append(x)
            savedt.append(xt)

        if cfg.bottom_channels:
            Bc, Cc, Fc, Tc = x.shape
            x = self.channel_upsampler(x.reshape(Bc, Cc, -1)).reshape(
                Bc, cfg.bottom_channels, Fc, Tc)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if cfg.bottom_channels:
            Bc, Cc, Fc, Tc = x.shape
            x = self.channel_downsampler(x.reshape(Bc, Cc, -1)).reshape(
                Bc, cfg.enc_channels[-1], Fc, Tc)
            xt = self.channel_downsampler_t(xt)

        for i in range(cfg.depth):
            last = i == cfg.depth - 1
            x = self.decoder[i](x, saved[cfg.depth - 1 - i])
            xt = self.tdecoder[i](xt, savedt[cfg.depth - 1 - i],
                                  lengths[cfg.depth - 1 - i])

        x = x * std + mean
        x = x.reshape(B, S, 4, x.shape[-2], x.shape[-1])
        zout = cac_unpack_torch(x)
        wave_spec = ispec_torch(zout, L, cfg.nfft)
        xt = xt * stdt + meant
        xt = xt.reshape(B, S, cfg.audio_channels, L)
        return wave_spec + xt
