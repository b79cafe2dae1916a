"""Plain PyTorch model of Demucs v3 (hdemucs_mmi): the benchmark's
reference.

A frozen copy of `demucs_tpu_torch/tools/torch_ref_v3.py`: an
independent torch implementation of the v3 graph (BiLSTMs as `nn.LSTM`,
LocalState as plain products), with state-dict names matching the
port's schema. LocalState's position and decay constants are made on the
input's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .torch_ref import (
    FreqEmb,
    HDec,
    HEnc,
    LayerScale,
    cac_pack_torch,
    cac_unpack_torch,
    ispec_torch,
    spec_torch,
)


class BLSTM(nn.Module):
    """2-layer BiLSTM + linear with skip (reference src/layers.cpp:928-955)."""

    def __init__(self, dim):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=2, bidirectional=True,
                            batch_first=True)
        self.linear = nn.Linear(2 * dim, dim)

    def forward(self, x):  # (B, C, T)
        seq = x.transpose(1, 2)
        y, _ = self.lstm(seq)
        y = self.linear(y) + seq
        return y.transpose(1, 2)


class LocalState(nn.Module):
    """Local attention with decay penalty (reference src/layers.cpp:533-721)."""

    def __init__(self, ch, heads=4, ndecay=4):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay
        self.content = nn.Conv1d(ch, ch, 1)
        self.query = nn.Conv1d(ch, ch, 1)
        self.key = nn.Conv1d(ch, ch, 1)
        self.query_decay = nn.Conv1d(ch, heads * ndecay, 1)
        self.proj = nn.Conv1d(ch, ch, 1)

    def forward(self, x):
        B, C, T = x.shape
        H, ND = self.heads, self.ndecay
        D = C // H
        q = self.query(x).reshape(B, H, D, T)
        k = self.key(x).reshape(B, H, D, T)
        c = self.content(x).reshape(B, H, D, T)
        dq = (torch.sigmoid(self.query_decay(x)) / 2).reshape(B, H, ND, T)
        dots = torch.einsum("bhdt,bhds->bhts", k, q) / (D ** 0.5)
        idx = torch.arange(T, dtype=torch.float32, device=x.device)
        delta = (idx[:, None] - idx[None, :]).abs()
        decays = torch.arange(1, ND + 1, dtype=torch.float32, device=x.device)
        kernel = -decays[:, None, None] * delta[None] / (ND ** 0.5)
        dots = dots + torch.einsum("bhns,nts->bhts", dq, kernel)
        dots.masked_fill_(torch.eye(T, dtype=torch.bool, device=x.device)[None, None], -100.0)
        w = torch.softmax(dots, dim=2)
        out = torch.einsum("bhts,bhdt->bhds", w, c).reshape(B, C, T)
        return x + self.proj(out)


class DConvLSTM(nn.Module):
    """v3 encoder-4/5 DConv (reference src/layers.cpp:896-1113)."""

    def __init__(self, ch, hidden, depth=2):
        super().__init__()
        self.layers = nn.ModuleList()
        for j in range(depth):
            dil = 2 ** j
            self.layers.append(nn.Sequential(
                nn.Conv1d(ch, hidden, 3, dilation=dil, padding=dil),
                nn.GroupNorm(1, hidden),
                nn.GELU(),
                BLSTM(hidden),
                LocalState(hidden),
                nn.Conv1d(hidden, 2 * ch, 1),
                nn.GroupNorm(1, 2 * ch),
                nn.GLU(1),
                LayerScale(ch),
            ))

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


class Enc4(nn.Module):
    """Freq encoder 4 with time injection (reference src/encdec.cpp:532-573)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(384, 768, (8, 1), (4, 1))
        self.norm1 = nn.GroupNorm(4, 768)
        self.rewrite = nn.Conv2d(768, 1536, 1)
        self.norm2 = nn.GroupNorm(4, 1536)
        self.dconv = DConvLSTM(768, 192)

    def forward(self, x, inject):
        y = self.conv(x)[:, :, 0, :] + inject
        y = F.gelu(self.norm1(y))
        y = self.dconv(y)
        y = self.norm2(self.rewrite(y[:, :, None, :])[:, :, 0, :])
        return F.glu(y, 1)


class Enc5(nn.Module):
    """Shared encoder 5 (reference src/encdec.cpp:575-615)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv1d(768, 1536, 4, 2, 1)
        self.norm1 = nn.GroupNorm(4, 1536)
        self.rewrite = nn.Conv1d(1536, 3072, 1)
        self.norm2 = nn.GroupNorm(4, 3072)
        self.dconv = DConvLSTM(1536, 384)

    def forward(self, x):
        y = F.gelu(self.norm1(self.conv(x)))
        y = self.dconv(y)
        y = self.norm2(self.rewrite(y))
        return F.glu(y, 1)


class Dec0(nn.Module):
    """Shared decoder 0 (reference src/encdec.cpp:617-656)."""

    def __init__(self):
        super().__init__()
        self.rewrite = nn.Conv1d(1536, 3072, 3, padding=1)
        self.norm1 = nn.GroupNorm(4, 3072)
        self.conv_tr = nn.ConvTranspose1d(1536, 768, 4, 2)
        self.norm2 = nn.GroupNorm(4, 768)

    def forward(self, skip, out_length):
        y = F.glu(self.norm1(self.rewrite(skip)), 1)
        y = F.gelu(self.norm2(self.conv_tr(y)))
        return y[:, :, 1:1 + out_length]


class Dec1(nn.Module):
    """Freq decoder 1 (reference src/encdec.cpp:658-698)."""

    def __init__(self):
        super().__init__()
        self.rewrite = nn.Conv2d(768, 1536, 3, padding=1)
        self.norm1 = nn.GroupNorm(4, 1536)
        self.conv_tr = nn.ConvTranspose2d(768, 384, (8, 1), (4, 1))
        self.norm2 = nn.GroupNorm(4, 384)

    def forward(self, x, skip):
        y = x[:, :, None, :] + skip
        y = F.glu(self.norm1(self.rewrite(y)), 1)
        pre = y
        y = F.gelu(self.norm2(self.conv_tr(y)))
        return y, pre


class TDec0(nn.Module):
    """Time decoder 0 (reference src/encdec.cpp:700-726)."""

    def __init__(self):
        super().__init__()
        self.conv_tr = nn.ConvTranspose1d(768, 384, 8, 4)
        self.norm2 = nn.GroupNorm(4, 384)

    def forward(self, pre, out_length):
        y = F.gelu(self.norm2(self.conv_tr(pre[:, :, 0, :])))
        return y[:, :, 2:2 + out_length]


class TEnc4(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv1d(384, 768, 8, 4, 2)

    def forward(self, x):
        le = x.shape[-1]
        if le % 4:
            x = F.pad(x, (0, 4 - le % 4))
        return self.conv(x)


class HDemucsV3Ref(nn.Module):
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
        self.encoder.append(Enc4())
        self.encoder.append(Enc5())
        self.tencoder.append(TEnc4())

        self.decoder = nn.ModuleList([Dec0(), Dec1()])
        self.tdecoder = nn.ModuleList([TDec0()])
        for k in range(4):
            chin = chans[-1] // cfg.growth ** k
            last = k == 3
            chout_f = cac_in * cfg.num_sources if last else chin // 2
            chout_t = cfg.audio_channels * cfg.num_sources if last else chin // 2
            self.decoder.append(HDec(chin, chout_f, True, last, dconv=False))
            self.tdecoder.append(HDec(chin, chout_t, False, last, dconv=False))

        self.freq_emb = FreqEmb(cfg.freq_bins // 4, cfg.channels)

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
        for i in range(4):
            lengths.append(xt.shape[-1])
            xt = self.tencoder[i](xt)
            x = self.encoder[i](x)
            if i == 0:
                emb = self.freq_emb.embedding.weight
                x = x + cfg.freq_emb_scale * emb.t()[None, :, :, None]
            saved.append(x)
            savedt.append(xt)

        xt4_len = xt.shape[-1]
        xt4 = self.tencoder[4](xt)
        x4 = self.encoder[4](x, xt4)
        x5 = self.encoder[5](x4)

        xshared = self.decoder[0](x5, x4.shape[-1])
        x, pre = self.decoder[1](xshared, x4[:, :, None, :])
        xt = self.tdecoder[0](pre, xt4_len)

        for k in range(4):
            x = self.decoder[k + 2](x, saved[3 - k])
            xt = self.tdecoder[k + 1](xt, savedt[3 - k], lengths[3 - k])

        x = x * std + mean
        x = x.reshape(B, S, 4, x.shape[-2], x.shape[-1])
        zout = cac_unpack_torch(x)
        wave_spec = ispec_torch(zout, L, cfg.nfft)
        xt = xt * stdt + meant
        xt = xt.reshape(B, S, cfg.audio_channels, L)
        return wave_spec + xt
