"""Token-level timestamps via DTW over cross-attention, held against the
JAX package's ``models/timestamps.py``.

The reference service gets per-token timestamps from whisper.cpp
(``token_timestamps=true``). As in the JAX package they are computed the
openai-whisper way: one teacher-forced decoder pass collects the
cross-attention weights (``alignment_scores``, on the device: the plain
prefill of ``models/whisper.decoder_apply`` with the reduced collection,
the mean over heads and the upper half of the layers), the text → audio
frame alignment is found with DTW, and token boundaries are read off the
monotone path. The O(T × F) DTW runs on the host in numpy
(``median_filter``, ``dtw_path``, ``token_boundaries``,
``compute_token_times``: copies of the JAX package's).
"""

from __future__ import annotations

import numpy as np
import torch

from .graphs import to_device, to_host
from .whisper import WhisperConfig, decoder_apply, init_kv_cache, text_heads

AUDIO_TIME_PER_FRAME = 0.02  # one encoder position = 20 ms


@torch.inference_mode()
def alignment_scores(
    cfg: WhisperConfig,
    model,
    xa_kv: dict,
    tokens: torch.Tensor,  # [B, T] full sequence incl. prompt
) -> torch.Tensor:
    """Teacher-forced pass → averaged alignment-head attention [B, T, F],
    on ``tokens``' device, normalized per token position.

    Without a model-specific alignment-head dump, heads from the upper half
    of decoder layers are used (openai-whisper's generic fallback). The
    reduced collection keeps one [B, T, F] fp32 accumulator, never the
    stacked [L, B, H, T, F] weights."""
    B, T = tokens.shape
    kv = init_kv_cache(cfg, B, max(64, -(-T // 64) * 64), device=tokens.device,
                       n_head=text_heads(cfg, model))
    _, _, w = decoder_apply(
        cfg, model, tokens, 0, kv, xa_kv,
        collect_cross_attn=True,
        cross_attn_layer_begin=cfg.n_text_layer // 2,
    )
    mean = w.mean(dim=-1, keepdim=True)
    std = w.std(dim=-1, unbiased=False, keepdim=True) + 1e-6
    return (w - mean) / std


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last (audio-frame) axis."""
    if width < 3:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotone alignment through cost [T, F] (lower = better match).

    Returns (text_idx, time_idx) along the optimal path. The forward pass
    is vectorized per row: with m0[j] = min(diag, up), the left-neighbor
    recurrence D[i,j] = c[j] + min(m0[j], D[i,j-1]) is a min-plus prefix
    scan, solved with cumsum + minimum.accumulate — O(T·F) with numpy
    row ops instead of a Python double loop."""
    T, F = cost.shape
    D = np.full((T + 1, F + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, T + 1):
        c = cost[i - 1].astype(np.float64)
        m0 = np.minimum(D[i - 1, :-1], D[i - 1, 1:])  # [F]: min(diag, up)
        ccum = np.cumsum(c)
        # D[i,j] = ccum[j-1] + min_{k<=j}(m0[k-1] - ccum[k-2])
        base = m0 - np.concatenate(([0.0], ccum[:-1]))
        with np.errstate(invalid="ignore"):
            run = np.minimum.accumulate(base)
        D[i, 1:] = ccum + run
    # Traceback by re-evaluating the three candidates (diag, up, left),
    # tie-broken in that order.
    i, j = T, F
    text_idx, time_idx = [], []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        c0 = D[i - 1, j - 1]
        c1 = D[i - 1, j]
        c2 = D[i, j - 1]
        m = min(c0, c1, c2)
        if m == c0:
            i, j = i - 1, j - 1
        elif m == c1:
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def token_boundaries(
    scores: np.ndarray,  # [T, F] alignment scores (higher = aligned)
    n_frames: int,
) -> np.ndarray:
    """Per-token (start, end) times in seconds; shape [T, 2]."""
    T = scores.shape[0]
    cost = -median_filter(scores[:, :n_frames], 7)
    text_idx, time_idx = dtw_path(cost)
    jumps = np.diff(text_idx, prepend=-1) > 0  # first frame of each token
    starts = time_idx[jumps] * AUDIO_TIME_PER_FRAME
    bounds = np.zeros((T, 2), np.float64)
    bounds[:, 0] = starts
    bounds[:-1, 1] = starts[1:]
    bounds[-1, 1] = n_frames * AUDIO_TIME_PER_FRAME
    return bounds


def align_bucket(n: int) -> int:
    """Sequence length of the alignment pass: the JAX package pads to these
    coarse buckets (its compiled shape classes). The port pads the same
    way, so its pass sees the same rows: padding rows are causal-masked,
    sliced off before the DTW. Callers clamp to cfg.n_text_ctx."""
    for b in (64, 128, 256, 448):
        if n <= b:
            return b
    return -(-n // 32) * 32


def compute_token_times(
    cfg: WhisperConfig,
    model,
    xa_kv: dict,
    full_tokens: np.ndarray,  # [T] incl. prompt, up to (not incl.) EOT
    sample_begin: int,
    n_audio_frames: int,
) -> np.ndarray:
    """[n_sampled, 2] start/end seconds for the sampled tokens of one
    window (B=1 path used by the engine)."""
    return times_of_scores(window_scores(cfg, model, xa_kv, full_tokens), sample_begin,
                           n_audio_frames)


def window_scores(cfg: WhisperConfig, model, xa_kv: dict, full_tokens: np.ndarray) -> np.ndarray:
    """The device half of ``compute_token_times``: the alignment scores
    [T, F] of one window's T tokens, on the host."""
    T = len(full_tokens)
    padded = np.zeros((min(align_bucket(T), cfg.n_text_ctx),), np.int64)
    padded[:T] = full_tokens
    device = next(iter(xa_kv.values())).device
    scores = alignment_scores(cfg, model, xa_kv, to_device(padded[None], device))[0]
    return to_host(scores).numpy()[:T]


def times_of_scores(scores: np.ndarray, sample_begin: int, n_audio_frames: int) -> np.ndarray:
    """The host half: [n_sampled, 2] token times from ``window_scores``."""
    sampled_scores = scores[sample_begin:]
    if sampled_scores.shape[0] == 0:
        return np.zeros((0, 2))
    return token_boundaries(sampled_scores, n_audio_frames)
