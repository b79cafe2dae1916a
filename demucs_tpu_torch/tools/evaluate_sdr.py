"""Museval-style BSS-eval v4 evaluation without museval.

The port's own copy of `demucs_tpu/tools/evaluate_sdr.py` (numpy only;
it reads WAVs through the port's `audio.py`), which is the counterpart of
the reference's scripts/evaluate-demixed-output.py:20-44: the
reference calls museval's BSS-eval v4 (SDR/SIR/ISR/SAR over 1-second
windows, median-aggregated). museval/musdb are not in this environment,
so the v4 math is reimplemented in numpy, including museval's default
512-tap distortion filters: each window decomposes the estimate of
source j against the span of ALL reference stems' channels, each
delayed by 0..L-1 taps (L = filters_len, museval default 512):

    P_j    = least-squares filtered projection onto ref_j's channels
    P_all  = least-squares filtered projection onto all J*C channels
    e_spat   = P_j   - ref_j
    e_interf = P_all - P_j
    e_artif  = est_j - P_all

    SDR = 10log10 ||ref_j||^2            / ||est_j - ref_j||^2
    ISR = 10log10 ||ref_j||^2            / ||e_spat||^2
    SIR = 10log10 ||ref_j + e_spat||^2   / ||e_interf||^2
    SAR = 10log10 ||ref_j + e_spat + e_interf||^2 / ||e_artif||^2

(note e_spat + e_interf + e_artif == est_j - ref_j for ANY filter
length — the decomposition telescopes — so v4 SDR is the plain energy
ratio and is filter-free; the filters only shape ISR/SIR/SAR). The
Gram of the delayed basis is block-Toeplitz and is built from FFT
cross-correlations like bss_eval_images; projections follow the
original convention of length T + L - 1 (estimate zero-padded).
Median over non-silent windows, like museval.

Usage:
    python -m demucs_tpu_torch.tools.evaluate_sdr REF_DIR EST_DIR \
        [--stems drums bass other vocals] [--sdr-only] [--filter-len 512]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

SAMPLE_RATE = 44100


def sdr_framewise(ref: np.ndarray, est: np.ndarray,
                  win: int = SAMPLE_RATE, hop: int | None = None
                  ) -> np.ndarray:
    """Per-window SDR (dB) for (C, N) stems — bsseval v4 convention."""
    hop = hop or win
    n = min(ref.shape[-1], est.shape[-1])
    ref, est = ref[..., :n], est[..., :n]
    scores = []
    for start in range(0, n - win + 1, hop):
        r = ref[..., start:start + win]
        e = est[..., start:start + win]
        num = np.sum(np.square(r), dtype=np.float64)
        den = np.sum(np.square(r - e), dtype=np.float64)
        if num < 1e-10:       # silent reference window: skip (museval does)
            continue
        scores.append(10.0 * np.log10(num / max(den, 1e-12)))
    return np.asarray(scores)


def median_sdr(ref: np.ndarray, est: np.ndarray) -> float:
    s = sdr_framewise(ref, est)
    return float(np.median(s)) if s.size else float("nan")


def _db(num: float, den: float) -> float:
    if num < 1e-10:
        return float("nan")
    return 10.0 * np.log10(num / max(den, 1e-12))


def _filtered_projection(S: np.ndarray, E: np.ndarray, L: int) -> np.ndarray:
    """Least-squares projection with L-tap distortion filters.

    S (K, T): basis signals; E (M, T): signals to project. Returns
    P (M, T + L - 1), the LS projection of each row of E onto
    span{ S[k] delayed by 0..L-1 } — the bss_eval_images construction
    (projection length follows the original: full convolution support).

    The Gram G[(a,i),(b,j)] = sum_t S_a[t-i] S_b[t-j] = c_ab[i-j] is
    block-Toeplitz in the cross-correlations c_ab, built via one FFT
    per signal instead of the O(K^2 L T) direct sums.
    """
    K, T = S.shape
    M = E.shape[0]
    nfft = 1 << int(np.ceil(np.log2(T + L)))
    F_s = np.fft.rfft(S, nfft)                        # (K, nf)
    F_e = np.fft.rfft(E, nfft)                        # (M, nf)

    # c_ab[d] = sum_u S_a[u] S_b[u + d]  (d may be negative: index mod nfft)
    cc = np.fft.irfft(np.conj(F_s)[:, None] * F_s[None, :], nfft)  # (K, K, nfft)
    lag = (np.arange(L)[:, None] - np.arange(L)[None, :]) % nfft    # (L, L)
    G = cc[:, :, lag].transpose(0, 2, 1, 3).reshape(K * L, K * L)

    # D[(a, tau), m] = sum_u S_a[u] E_m[u + tau], tau in [0, L)
    ce = np.fft.irfft(np.conj(F_s)[:, None] * F_e[None, :], nfft)  # (K, M, nfft)
    D = ce[:, :, :L].transpose(0, 2, 1).reshape(K * L, M)

    # tiny ridge keeps near-singular windows (correlated/silent basis
    # rows) solvable; fall back to lstsq on exact singularity
    ridge = 1e-10 * (np.trace(G) / max(K * L, 1) + 1e-30)
    try:
        coef = np.linalg.solve(G + ridge * np.eye(K * L), D)
    except np.linalg.LinAlgError:
        coef = np.linalg.lstsq(G, D, rcond=None)[0]

    # P_m = sum_a conv(S_a, coef_{a,:,m}), full length T + L - 1
    Cf = np.fft.rfft(coef.reshape(K, L, M), nfft, axis=1)          # (K, nf, M)
    P = np.fft.irfft(np.einsum("kf,kfm->mf", F_s, Cf), nfft)
    return P[:, :T + L - 1]


def bss_eval_framewise(refs: np.ndarray, ests: np.ndarray,
                       win: int = SAMPLE_RATE, hop: int | None = None,
                       filters_len: int = 512) -> dict[str, np.ndarray]:
    """BSS-eval v4 metrics for all sources at once.

    refs/ests: (J, C, N). filters_len: distortion-filter taps for the
    ISR/SIR/SAR projections (museval v4 default 512; SDR is filter-free
    either way). Returns {"SDR"|"ISR"|"SIR"|"SAR": (J, n_win)} with NaN
    for windows whose reference stem is silent.
    """
    hop = hop or win
    L = max(int(filters_len), 1)
    J, C, n_ref = refs.shape
    n = min(n_ref, ests.shape[-1])
    refs, ests = refs[..., :n], ests[..., :n]
    starts = list(range(0, n - win + 1, hop))
    out = {k: np.full((J, len(starts)), np.nan)
           for k in ("SDR", "ISR", "SIR", "SAR")}

    for w, start in enumerate(starts):
        R = refs[..., start:start + win].astype(np.float64)  # (J, C, T)
        E = ests[..., start:start + win].astype(np.float64)
        B = R.reshape(J * C, win)                 # all-stems basis
        # one factorization of the big Gram serves every source's
        # estimate channels (J*C right-hand sides)
        P_all_flat = _filtered_projection(B, E.reshape(J * C, win), L)
        P_all_all = P_all_flat.reshape(J, C, -1)  # (J, C, T+L-1)
        for j in range(J):
            r = R[j]                              # (C, T)
            e = E[j]
            num_ref = float(np.sum(r * r))
            if num_ref < 1e-10:
                continue
            r_pad = np.pad(r, ((0, 0), (0, L - 1)))
            e_pad = np.pad(e, ((0, 0), (0, L - 1)))
            P_j = _filtered_projection(r, e, L)   # own-stem projection
            P_all = P_all_all[j]

            e_spat = P_j - r_pad
            e_interf = P_all - P_j
            e_artif = e_pad - P_all
            out["SDR"][j, w] = _db(num_ref, float(np.sum((e - r) ** 2)))
            out["ISR"][j, w] = _db(num_ref, float(np.sum(e_spat ** 2)))
            out["SIR"][j, w] = _db(float(np.sum(P_j ** 2)),
                                   float(np.sum(e_interf ** 2)))
            out["SAR"][j, w] = _db(float(np.sum(P_all ** 2)),
                                   float(np.sum(e_artif ** 2)))
    return out


def median_bss_eval(refs: np.ndarray, ests: np.ndarray,
                    filters_len: int = 512) -> dict[str, list]:
    """Median-over-windows BSS-eval v4 per source (museval aggregation)."""
    frames = bss_eval_framewise(refs, ests, filters_len=filters_len)
    return {k: [round(float(np.nanmedian(v[j])), 3)
                if np.isfinite(v[j]).any() else float("nan")
                for j in range(v.shape[0])]
            for k, v in frames.items()}


def _find_stem(d: Path, stem: str) -> Path:
    """Locate the wav for `stem`, preferring exact naming over substring.

    Priority: `{stem}.wav` == exact, then the CLI's `target_{i}_{stem}.wav`,
    then word-boundary match, then bare substring (so 'other' never
    grabs 'another.wav' when a real 'other' file exists)."""
    wavs = sorted(p for p in d.iterdir() if p.suffix == ".wav")
    low = stem.lower()
    for pat in (lambda n: n == f"{low}.wav",
                lambda n: re.fullmatch(rf"target_\d+_{re.escape(low)}\.wav", n),
                lambda n: re.search(rf"(^|[^a-z]){re.escape(low)}([^a-z]|$)", n),
                lambda n: low in n):
        hits = [p for p in wavs if pat(p.name.lower())]
        if hits:
            return hits[0]
    raise FileNotFoundError(f"no {stem} wav in {d}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="BSS-eval v4 (SDR/ISR/SIR/SAR)")
    ap.add_argument("reference_dir")
    ap.add_argument("estimate_dir")
    ap.add_argument("--stems", nargs="+",
                    default=["drums", "bass", "other", "vocals"])
    ap.add_argument("--sdr-only", action="store_true",
                    help="plain per-stem SDR (no projections; faster)")
    ap.add_argument("--filter-len", type=int, default=512,
                    help="distortion-filter taps for ISR/SIR/SAR "
                         "(museval v4 default 512; 1 = instantaneous, "
                         "much faster; SDR is unaffected)")
    args = ap.parse_args(argv)

    from .. import audio
    refs, ests = [], []
    for stem in args.stems:
        ref, _ = audio.read_wav(_find_stem(Path(args.reference_dir), stem))
        est, _ = audio.read_wav(_find_stem(Path(args.estimate_dir), stem))
        refs.append(ref)
        ests.append(est)

    if args.sdr_only:
        results = {stem: round(median_sdr(r, e), 3)
                   for stem, r, e in zip(args.stems, refs, ests)}
    else:
        n = min(min(r.shape[-1] for r in refs), min(e.shape[-1] for e in ests))
        med = median_bss_eval(np.stack([r[..., :n] for r in refs]),
                              np.stack([e[..., :n] for e in ests]),
                              filters_len=args.filter_len)
        results = {stem: {k: med[k][j] for k in med}
                   for j, stem in enumerate(args.stems)}
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
