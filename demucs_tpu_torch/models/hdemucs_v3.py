"""Demucs v3 Hybrid (hdemucs_mmi) as a PyTorch module.

The port of `demucs_tpu/models/hdemucs_v3.py`. `HDemucsV3.forward(mix)`
is `hdemucs_v3_segment(params, mix, cfg)`: (B, 2, L) -> (B, S, 2, L).
Encoders 0-3 are the v4 layers (`HEncLayer`, `TEncLayer`) with a DConv
compression of 4; the rest is v3's own:

  * tencoder 4: a plain strided Conv1d 384 -> 768;
  * freq encoder 4, whose output (one frequency row) takes the time
    branch before its GroupNorm(4), and whose DConv sub-blocks carry a
    2-layer BiLSTM (the CUDA kernel K6 through `ops.bilstm`) and a
    LocalState attention, and whose tail (GroupNorm, GLU, LayerScale,
    residual) is the kernel K4 (the encoders 0-3's DConv sub-blocks are
    the kernel K5, through the shared `DConv`);
  * shared encoder 5 on the merged branch, with the same DConv;
  * shared decoder 0, freq decoder 1 and time decoder 0 with GroupNorm(4);
  * four common decoders per branch without DConv.

As in `models/htdemucs.py`, the torch modules hold the weights under the
state-dict names of `params.schema.hdemucs_v3_schema` and the forward
runs the functional ops of `ops/`. The BiLSTM's weights sit in an
`nn.LSTM` whose own forward is never called; `BLSTM.packed` keeps them
in the form K6's layer takes, packed once per set of weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import dsp, ops
from ..config import HDemucsV3Config
from ..utils.device import f32_precision
from ..utils.progress import report_stage
from .htdemucs import (HEncLayer, LayerScale, ScaledEmbedding, TEncLayer, dconv_tail,
                       denormalized_spec, load_module, normalized_inputs)


class Params(nn.Module):
    """A named group of weight-holding modules: one layer of the state
    dict, whose maths `HDemucsV3` writes out."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, module in modules.items():
            self.add_module(name, module)


class BLSTM(nn.Module):
    """The BiLSTM of a v3 DConv sub-block: `lstm`, a 2-layer bidirectional
    nn.LSTM(H, H) holding the weights, and `linear` (2H -> H)."""

    def __init__(self, dim: int):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, 2, bidirectional=True)
        self.linear = nn.Linear(2 * dim, dim)
        self._packed = None   # (key of the weights it was packed from, layers)

    def layers(self) -> list[dict]:
        """The weights in `ops.bilstm`'s structure."""
        return [{direction: {name: getattr(self.lstm, f"{name}_l{i}{suffix}")
                             for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
                 for direction, suffix in (("forward", ""), ("reverse", "_reverse"))}
                for i in range(self.lstm.num_layers)]

    def packed(self) -> list[ops.lstm.PackedLayer]:
        """The layers in `ops.bilstm_packed`'s form, packed on the first
        call and kept until a weight changes. The key is each parameter's
        storage, device, dtype and version counter: `load_state_dict` (in
        place or by assignment), `.to()` and in-place updates all change
        it (writes through `.data` bypass the counter, as they bypass
        autograd). Where autograd would record the packing (grad mode on
        and a weight that requires grad), it is packed anew on each call
        and kept nowhere, so the gradient path stays intact; so it is
        under `torch.export` (whose tensors have no storage to key on),
        and the exported program holds the packing."""
        weights = list(self.lstm.parameters())
        if torch.compiler.is_compiling() or (
                torch.is_grad_enabled() and any(w.requires_grad for w in weights)):
            return [ops.pack_bilstm_layer(layer) for layer in self.layers()]
        key = tuple((w.data_ptr(), w.device, w.dtype, w._version) for w in weights)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, [ops.pack_bilstm_layer(layer) for layer in self.layers()])
        return self._packed[1]


class LocalState(nn.Module):
    """LocalState's 1x1 convs (content, query, key, query_decay, proj)."""

    def __init__(self, ch: int, heads: int, ndecay: int):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay
        self.content = nn.Conv1d(ch, ch, 1)
        self.query = nn.Conv1d(ch, ch, 1)
        self.key = nn.Conv1d(ch, ch, 1)
        self.query_decay = nn.Conv1d(ch, heads * ndecay, 1)
        self.proj = nn.Conv1d(ch, ch, 1)


def _dconv_lstm_block(ch: int, hidden: int, dilation: int,
                      cfg: HDemucsV3Config) -> nn.Sequential:
    """One v3 encoder-4/5 DConv sub-block with Demucs' Sequential indices:
    0 conv, 1 norm, 2 GELU, 3 BLSTM, 4 LocalState, 5 conv, 6 norm, 7 GLU,
    8 LayerScale."""
    return nn.Sequential(
        nn.Conv1d(ch, hidden, 3, padding=dilation, dilation=dilation),
        nn.GroupNorm(1, hidden), nn.GELU(),
        BLSTM(hidden), LocalState(hidden, cfg.local_attn_heads, cfg.local_attn_ndecay),
        nn.Conv1d(hidden, 2 * ch, 1), nn.GroupNorm(1, 2 * ch), nn.GLU(1),
        LayerScale(ch))


class DConvLSTM(nn.Module):
    """The v3 encoder-4/5 DConv on (B, C, T). Per sub-block: compress conv
    (k=3, dilation 2^j) -> GroupNorm(1) + GELU -> BiLSTM over time, linear,
    skip -> LocalState -> expand 1x1 conv -> GroupNorm(1) -> GLU ->
    LayerScale -> residual, the tail through `dconv_tail` (K4 on CUDA)."""

    def __init__(self, ch: int, hidden: int, cfg: HDemucsV3Config):
        super().__init__()
        self.layers = nn.ModuleList(
            _dconv_lstm_block(ch, hidden, 2 ** j, cfg) for j in range(cfg.dconv_depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, blk in enumerate(self.layers):
            dil = 2 ** j
            y = ops.conv1d(x, blk[0].weight, blk[0].bias, padding=dil, dilation=dil)
            y = ops.group_norm(y, blk[1].weight, blk[1].bias, 1)
            y = ops.gelu(y)
            seq = y.transpose(1, 2)                                  # (B, T, C)
            h = ops.bilstm_packed(seq, blk[3].packed())
            h = ops.linear(h, blk[3].linear.weight, blk[3].linear.bias)
            y = (h + seq).transpose(1, 2)
            y = ops.local_attention(y, blk[4], blk[4].heads, blk[4].ndecay)
            y = ops.conv1d(y, blk[5].weight, blk[5].bias)
            x = dconv_tail(y, blk[6], blk[8], x)
        return x


class HDemucsV3(nn.Module):
    """hdemucs_mmi: forward(mix (B, 2, L)) -> (B, S, 2, L), float32; the
    network in the dtype of `encoder[0].conv.weight`, as `HTDemucs`."""

    def __init__(self, cfg: HDemucsV3Config):
        super().__init__()
        self.cfg = cfg
        chans = cfg.enc_channels                     # 48, 96, 192, 384
        cac_in = 2 * cfg.audio_channels
        S = cfg.num_sources
        c3, c4, c5 = chans[-1], 2 * chans[-1], 4 * chans[-1]  # 384, 768, 1536
        h4, h5 = cfg.lstm_hidden
        gn4 = lambda ch: nn.GroupNorm(4, ch)  # noqa: E731

        encoder = [HEncLayer(cac_in if i == 0 else chans[i - 1], ch, cfg)
                   for i, ch in enumerate(chans)]
        tencoder = [TEncLayer(cfg.audio_channels if i == 0 else chans[i - 1], ch, cfg)
                    for i, ch in enumerate(chans)]
        tencoder.append(Params(conv=nn.Conv1d(c3, c4, 8, 4, 2)))
        encoder.append(Params(conv=nn.Conv2d(c3, c4, (8, 1), (4, 1)), norm1=gn4(c4),
                              rewrite=nn.Conv2d(c4, 2 * c4, 1), norm2=gn4(2 * c4),
                              dconv=DConvLSTM(c4, h4, cfg)))
        encoder.append(Params(conv=nn.Conv1d(c4, c5, 4, 2, 1), norm1=gn4(c5),
                              rewrite=nn.Conv1d(c5, 2 * c5, 1), norm2=gn4(2 * c5),
                              dconv=DConvLSTM(c5, h5, cfg)))
        decoder = [
            Params(rewrite=nn.Conv1d(c5, 2 * c5, 3, padding=1), norm1=gn4(2 * c5),
                   conv_tr=nn.ConvTranspose1d(c5, c4, 4, 2), norm2=gn4(c4)),
            Params(rewrite=nn.Conv2d(c4, 2 * c4, 3, padding=1), norm1=gn4(2 * c4),
                   conv_tr=nn.ConvTranspose2d(c4, c3, (8, 1), (4, 1)), norm2=gn4(c3)),
        ]
        tdecoder = [Params(conv_tr=nn.ConvTranspose1d(c4, c3, 8, 4), norm2=gn4(c3))]
        for k in range(4):
            chin = c3 // cfg.growth ** k             # 384, 192, 96, 48
            last = k == 3
            chout_f = cac_in * S if last else chin // cfg.growth
            chout_t = cfg.audio_channels * S if last else chin // cfg.growth
            decoder.append(Params(rewrite=nn.Conv2d(chin, 2 * chin, 3, padding=1),
                                  conv_tr=nn.ConvTranspose2d(chin, chout_f, (8, 1), (4, 1))))
            tdecoder.append(Params(rewrite=nn.Conv1d(chin, 2 * chin, 3, padding=1),
                                   conv_tr=nn.ConvTranspose1d(chin, chout_t, 8, 4)))
        self.encoder = nn.ModuleList(encoder)
        self.tencoder = nn.ModuleList(tencoder)
        self.decoder = nn.ModuleList(decoder)
        self.tdecoder = nn.ModuleList(tdecoder)
        self.freq_emb = ScaledEmbedding(cfg.freq_bins // 4, cfg.channels)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        with f32_precision():
            return self._segment(mix.float())

    def remat_blocks(self) -> list[nn.Module]:
        """The modules `train.l1_loss(remat=True)` rematerializes one at a
        time: encoders 0-3 of both branches and the DConvs of encoders 4
        and 5 (the rest of the graph is written out in `_segment`, and its
        activations are kept)."""
        return [*self.encoder[:4], *self.tencoder[:4], self.encoder[4].dconv,
                self.encoder[5].dconv]

    def _segment(self, mix: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, _, L = mix.shape
        S = cfg.num_sources

        x, mean, std, xt, meant, stdt = normalized_inputs(
            mix, cfg.nfft, self.encoder[0].conv.weight.dtype)

        # stage marks (no-ops unless enabled), as the JAX graph's 22: spec,
        # 8 for encoders 0-3, encoder 4, encoder 5, the shared decoder 0,
        # freq decoder 1, time decoder 0, 8 for the common decoders
        stage = iter(range(1, 23))

        def mark(msg):
            report_stage(next(stage) / 22, msg)

        mark("spec + normalize")
        # --- encoders 0-3 (the v4 layers)
        saved, savedt, lengths = [], [], []
        for i in range(4):
            lengths.append(xt.shape[-1])
            xt = self.tencoder[i](xt)
            mark(f"tencoder {i}")
            x = self.encoder[i](x)
            if i == 0:
                emb = self.freq_emb.embedding.weight
                x = x + cfg.freq_emb_scale * emb[None, :, :, None]
            mark(f"encoder {i}")
            saved.append(x)
            savedt.append(xt)

        # --- tencoder 4: a plain strided conv, input padded to the stride
        pad = (-xt.shape[-1]) % 4
        xt4_len = xt.shape[-1]
        if pad:
            xt = F.pad(xt, (0, pad))
        te4 = self.tencoder[4].conv
        xt4 = ops.conv1d(xt, te4.weight, te4.bias, stride=4, padding=2)

        # --- freq encoder 4 with the time branch injected (F 8 -> 1)
        e4 = self.encoder[4]
        y = ops.freq_conv_fmajor(x, e4.conv.weight, e4.conv.bias, stride=4, padding=0)
        y = y[:, 0] + xt4                                    # (B, 768, T)
        y = ops.group_norm(y, e4.norm1.weight, e4.norm1.bias, 4)
        y = ops.gelu(y)
        y = e4.dconv(y)
        y = ops.conv1d(y, ops.dense(e4.rewrite.weight)[:, :, :, 0], e4.rewrite.bias)
        y = ops.group_norm(y, e4.norm2.weight, e4.norm2.bias, 4)
        x4 = ops.glu(y, 1)
        mark("tencoder 4 + freq encoder 4")

        # --- shared encoder 5 (T -> T/2)
        e5 = self.encoder[5]
        y = ops.conv1d(x4, e5.conv.weight, e5.conv.bias, stride=2, padding=1)
        y = ops.group_norm(y, e5.norm1.weight, e5.norm1.bias, 4)
        y = ops.gelu(y)
        y = e5.dconv(y)
        y = ops.conv1d(y, e5.rewrite.weight, e5.rewrite.bias)
        y = ops.group_norm(y, e5.norm2.weight, e5.norm2.bias, 4)
        x5 = ops.glu(y, 1)                                   # (B, 1536, T/2)
        mark("shared encoder 5")

        # --- shared decoder 0 (zeros + skip x5) seeds both branches
        d0 = self.decoder[0]
        y = ops.conv1d(x5, d0.rewrite.weight, d0.rewrite.bias, padding=1)
        y = ops.group_norm(y, d0.norm1.weight, d0.norm1.bias, 4)
        y = ops.glu(y, 1)
        y = ops.conv_transpose1d(y, d0.conv_tr.weight, d0.conv_tr.bias, stride=2)
        y = ops.group_norm(y, d0.norm2.weight, d0.norm2.bias, 4)
        y = ops.gelu(y)
        xshared = y[:, :, 1:1 + x4.shape[-1]]                # (B, 768, T)
        mark("shared decoder 0")

        # --- freq decoder 1 (F-major, F = 1): freq x_3 and the time seed
        d1 = self.decoder[1]
        y = (xshared + x4)[:, None]                          # (B, 1, 768, T)
        y = ops.freq_conv3x3_fmajor(y, d1.rewrite.weight, d1.rewrite.bias)
        y = ops.group_norm_fmajor(y, d1.norm1.weight, d1.norm1.bias, 4)
        pre = ops.glu(y, 2)                                  # (B, 1, 768, T)
        y = ops.freq_convtr_fmajor(pre, d1.conv_tr.weight, d1.conv_tr.bias, stride=4)
        y = ops.group_norm_fmajor(y, d1.norm2.weight, d1.norm2.bias, 4)
        x = ops.gelu(y)                                      # (B, 8, 384, T)
        mark("freq decoder 1")

        # --- time decoder 0, seeded by `pre`; GroupNorm before the trim
        td0 = self.tdecoder[0]
        y = ops.conv_transpose1d(pre[:, 0], td0.conv_tr.weight, td0.conv_tr.bias, stride=4)
        y = ops.group_norm(y, td0.norm2.weight, td0.norm2.bias, 4)
        xt = ops.gelu(y)[:, :, 2:2 + xt4_len]                # (B, 384, 1344)
        mark("time decoder 0")

        # --- common decoders (no DConv, no norms); the last freq decoder
        # emits the untrimmed bin axis, which the inverse STFT slices
        for k in range(4):
            last = k == 3
            dec, tdec = self.decoder[k + 2], self.tdecoder[k + 1]
            y = ops.freq_conv3x3_fmajor(x + saved[3 - k], dec.rewrite.weight)
            y = ops.glu(y, 2, bias=dec.rewrite.bias)
            y = ops.freq_convtr_fmajor(y, dec.conv_tr.weight, dec.conv_tr.bias,
                                       stride=4, padding=0 if last else 2)
            x = y if last else ops.gelu(y)
            mark(f"decoder {k + 2}")

            y = ops.conv1d(xt + savedt[3 - k], tdec.rewrite.weight, tdec.rewrite.bias,
                           padding=1)
            y = ops.glu(y, 1)
            y = ops.conv_transpose1d(y, tdec.conv_tr.weight, tdec.conv_tr.bias, stride=4)
            y = y[:, :, 2:2 + lengths[3 - k]]
            xt = y if last else ops.gelu(y)
            mark(f"tdecoder {k + 1}")

        # --- epilogue: denorm, un-CaC, ISTFT, sum with the time branch
        x = denormalized_spec(x, mean, std)
        wave_spec = dsp.ispec_cac_fmajor(x, S, L, cfg.nfft, bin_offset=2)
        xt = (xt.float() * stdt + meant).reshape(B, S, cfg.audio_channels, L)
        return wave_spec + xt


def build_hdemucs_v3(cfg: HDemucsV3Config, state_dict: dict[str, torch.Tensor],
                     device: str | torch.device = "cuda", train: bool = False,
                     quant_dtype: torch.dtype = torch.float32) -> HDemucsV3:
    """An HDemucsV3 holding `state_dict`, as `htdemucs.load_module` places
    it: on `device`, in eval mode, or with `train=True` trainable (its own
    weights, all requiring grad; a quantized state dict refused). The
    module is built on the meta device, so no weights are initialised
    only to be overwritten."""
    with torch.device("meta"):
        model = HDemucsV3(cfg)
    return load_module(model, state_dict, device, train, quant_dtype)
