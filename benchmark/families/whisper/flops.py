"""A Whisper model's FLOPs from its configuration: a multiply and an add
count as two. ``mfu_pct`` sums them over the work a run completed
(``served_flops``)."""

from __future__ import annotations


def encode_flops(cfg: dict) -> float:
    """One 30 s window through the encoder at its full positions: the two
    convolutions, and per layer q, k, v, o, the MLP and attention."""
    d, t, m = cfg["d_model"], cfg["max_source_positions"], cfg["num_mel_bins"]
    ff = cfg["encoder_ffn_dim"]
    convs = 2 * (2 * t) * 3 * m * d + 2 * t * 3 * d * d
    layer = 2 * t * 4 * d * d + 2 * t * 2 * d * ff + 4 * t * t * d
    return convs + cfg["encoder_layers"] * layer


def cross_kv_flops(cfg: dict) -> float:
    """The cross-attention K and V of every decoder layer for one window."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    return cfg["decoder_layers"] * 2 * (2 * t * d * d)


def token_flops(cfg: dict, position: int) -> float:
    """One token at ``position`` through every decoder layer (self q, k, v,
    o over the positions before it, cross q and o over the audio, the MLP)
    and the tied logits."""
    d, t, ff = cfg["d_model"], cfg["max_source_positions"], cfg["decoder_ffn_dim"]
    layer = 2 * 6 * d * d + 2 * 2 * d * ff + 4 * (position + 1) * d + 4 * t * d
    return cfg["decoder_layers"] * layer + 2 * d * cfg["vocab_size"]


def window_flops(cfg: dict, n_tokens: int, beams: int = 1) -> float:
    """A decoded window: its encode, its cross K/V, and ``n_tokens``
    positions (prompt and served tokens) for each of ``beams`` beams."""
    return (encode_flops(cfg) + cross_kv_flops(cfg)
            + beams * sum(token_flops(cfg, p) for p in range(n_tokens)))
