"""Greedy autoregressive decoding with whisper's suppression and timestamp
rules, held against the JAX package's ``models/sampling.py``.

The JAX package runs the token loop as one device ``lax.while_loop``; here
it is a Python loop over ``decoder_step`` that stops at ``max_len`` or when
every row has written EOT (a CUDA graph of the step is later work). The
rules are vectorized [B, vocab] logit masks, as in the JAX package:

  * static suppression set (non-speech tokens, sot/notimestamps/...),
  * blank and EOT suppression at sample start,
  * whisper timestamp pairing rules + monotonicity + max_initial_timestamp,
  * "sum of timestamp probs > max text prob ⇒ force timestamp",
  * temperature 0 = argmax (the first maximum on ties, as ``jnp.argmax``).

Sampling at temperature > 0, best-of, language detection, abortable
chunking and self-cache read buckets come with the engine slice; the
arguments that would ask for them raise ``NotImplementedError``. The JAX
package's ``prefill_len`` and ``sample_cap`` (for the engine's streaming
ticks) are not arguments here yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .whisper import WhisperConfig, decoder_apply, decoder_step, init_kv_cache

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class TokenIds:
    """Static token ids needed by the decoding rules."""

    eot: int
    sot: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int
    n_vocab: int
    max_initial_timestamp_index: int = 50  # 1.0 s
    blank: int = 220  # token for " " in whisper vocabs; set from tokenizer

    @classmethod
    def from_tokenizer(cls, tok, max_initial_timestamp: float = 1.0):
        s = tok.special
        blank_ids = tok.encode(" ")
        return cls(
            eot=s.eot,
            sot=s.sot,
            sot_prev=s.sot_prev,
            no_speech=s.no_speech,
            no_timestamps=s.no_timestamps,
            timestamp_begin=s.timestamp_begin,
            n_vocab=s.n_vocab,
            max_initial_timestamp_index=int(round(max_initial_timestamp / 0.02)),
            blank=blank_ids[0] if blank_ids else 220,
        )


def build_suppress_mask(
    n_vocab: int,
    ids: TokenIds,
    non_speech_tokens: tuple[int, ...] = (),
    suppress_nst: bool = True,
    extra: tuple[int, ...] = (),
) -> np.ndarray:
    """Static additive mask [n_vocab]: -inf at always-suppressed tokens."""
    mask = np.zeros((n_vocab,), np.float32)
    always = [
        ids.sot,
        ids.sot_prev,
        ids.no_timestamps,
        ids.no_speech,
    ]
    # whisper suppresses everything from sot up to timestamp_begin except
    # eot: language/task/special tokens can never be sampled mid-text.
    always += list(range(ids.sot, ids.timestamp_begin))
    if suppress_nst:
        always += list(non_speech_tokens)
    always += list(extra)
    for t in always:
        if 0 <= t < n_vocab:
            mask[t] = -np.inf
    mask[ids.eot] = 0.0
    mask[ids.timestamp_begin :] = 0.0  # timestamps governed by their own rules
    return mask


def apply_timestamp_rules(
    logits: torch.Tensor,  # [B, V] fp32
    tokens: torch.Tensor,  # [B, ctx] int (full buffer)
    pos,  # int or [B]: index where the next token goes
    sample_begin,  # int or [B]
    ids: TokenIds,
) -> torch.Tensor:
    """Vectorized port of whisper's ApplyTimestampRules."""
    dev = logits.device
    B, V = logits.shape
    tb = ids.timestamp_begin
    vocab_idx = torch.arange(V, device=dev)[None, :]
    is_ts_col = vocab_idx >= tb
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).expand(B)
    sample_begin = torch.as_tensor(sample_begin, dtype=torch.int64, device=dev).expand(B)

    def tok_at(idx):  # [B] gather of tokens[b, idx[b]]
        return torch.gather(tokens, 1, idx.clamp(min=0)[:, None].to(torch.int64))[:, 0]

    last = torch.where(pos > sample_begin, tok_at(pos - 1), -1)
    penult = torch.where(pos > sample_begin + 1, tok_at(pos - 2), -1)
    last_was_ts = last >= tb
    # whisper semantics: with fewer than two sampled tokens the penultimate
    # counts as a timestamp (so the token right after the initial timestamp
    # is forced to be text).
    penult_was_ts = (penult >= tb) | (pos < sample_begin + 2)

    # Pairing: after a single timestamp, the next token must be a timestamp
    # (no text); after a pair, no timestamp.
    force_ts = last_was_ts & ~penult_was_ts  # mask text (except EOT)
    forbid_ts = last_was_ts & penult_was_ts  # mask timestamps
    text_mask = (~is_ts_col) & (vocab_idx != ids.eot)
    logits = logits.masked_fill(force_ts[:, None] & text_mask, NEG_INF)
    logits = logits.masked_fill(forbid_ts[:, None] & is_ts_col, NEG_INF)

    # Monotonic timestamps: new ts must be >= max sampled ts so far.
    positions = torch.arange(tokens.shape[1], device=dev)[None, :]
    sampled = (positions >= sample_begin[:, None]) & (positions < pos[:, None])
    ts_vals = torch.where(sampled & (tokens >= tb), tokens, -1)
    max_ts = ts_vals.amax(dim=1)  # [B], -1 if none
    has_ts = max_ts >= 0
    # After a lone timestamp the same value may repeat (segment end); after
    # a completed pair the next must be strictly greater.
    min_allowed = torch.where(force_ts, max_ts, max_ts + 1)
    too_small = is_ts_col & (vocab_idx < min_allowed[:, None])
    logits = logits.masked_fill(has_ts[:, None] & too_small, NEG_INF)

    # First sampled token must be a timestamp, capped at max_initial.
    at_start = (pos == sample_begin)[:, None]
    init_cap = vocab_idx > (tb + ids.max_initial_timestamp_index)
    logits = logits.masked_fill(at_start & (~is_ts_col | init_cap), NEG_INF)

    # If total timestamp probability beats the best text token, force a
    # timestamp (the softmax normalizer cancels on both sides).
    ts_logprob = torch.logsumexp(logits[:, tb:], dim=-1)
    max_text = logits[:, :tb].amax(dim=-1)
    force2 = ts_logprob > max_text
    return logits.masked_fill(force2[:, None] & ~is_ts_col, NEG_INF)


# The JAX package buckets prompt lengths to bound its compiled prefill
# shapes. The bucket is kept because it sets the prefill length (the prompt
# plus EOT padding), which the decode must match token for token.
PROMPT_BUCKETS = (4, 8, 16, 32, 64, 128, 232)


def prompt_bucket(n: int) -> int:
    """Smallest bucket ≥ n (prompt prefill shape class)."""
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    return PROMPT_BUCKETS[-1]


class DecodeResult(NamedTuple):
    tokens: torch.Tensor  # [B, ctx] int64, full buffer incl. prompt
    lengths: torch.Tensor  # [B]: total tokens written (incl. prompt+EOT)
    sum_logprobs: torch.Tensor  # [B] fp32: over sampled tokens (incl. EOT)
    avg_logprobs: torch.Tensor  # [B]
    no_speech_probs: torch.Tensor  # [B]
    token_logprobs: torch.Tensor  # [B, ctx] fp32: logprob of each sampled token


@dataclasses.dataclass
class _DecodeState:
    tokens: torch.Tensor  # [B, ctx] int64
    kv: dict
    pos: int  # where the next token goes (shared by every row)
    done: torch.Tensor  # [B] bool
    sum_lp: torch.Tensor  # [B] f32
    tok_lps: torch.Tensor  # [B, ctx] f32
    last_logits: torch.Tensor  # [B, V] f32: logits for position pos


def decode_window(
    cfg: WhisperConfig,
    model,
    xa_kv: dict,
    tokens_init: torch.Tensor,  # [B, ctx] int, prompt in [0, sample_begin)
    sample_begin: int,
    sot_index: int,
    ids: TokenIds,
    suppress_mask: torch.Tensor,  # [V] additive
    temperature: float = 0.0,
    max_len: Optional[int] = None,
    use_timestamps: bool = True,
    self_dtype: Optional[torch.dtype] = None,
    cvalid_rows: Optional[int] = None,
    should_abort=None,
) -> DecodeResult:
    """Greedy-decode one batch of 30 s windows to EOT or ``max_len``.

    The prompt prefills at its bucket length (``prompt_bucket``);
    positions in [sample_begin, bucket) hold EOT padding whose K/V entries
    are never attended — each decode step overwrites its cache row before
    reading it. ``self_dtype`` overrides the self-KV-cache storage dtype
    (``torch.float8_e4m3fn``)."""
    if float(temperature) > 0.0:
        raise NotImplementedError("sampling at temperature > 0 comes with the engine slice")
    if should_abort is not None:
        raise NotImplementedError("abortable chunked decoding comes with the engine slice")
    if cvalid_rows:
        raise NotImplementedError("self-cache read buckets (cvalid_rows) are not ported")
    sample_begin, sot_index = int(sample_begin), int(sot_index)
    max_len = max_len or cfg.n_text_ctx

    state, no_speech_probs = _decode_setup(
        cfg, model, xa_kv, tokens_init, sample_begin, sot_index, ids, max_len,
        prompt_bucket(sample_begin), self_dtype,
    )
    step = _decode_step_fn(cfg, model, xa_kv, ids, suppress_mask, sample_begin, use_timestamps)
    while state.pos < max_len and not bool(state.done.all()):
        step(state)
    return _decode_result(state, no_speech_probs, sample_begin, ids)


def self_cache_len(ctx: int, max_len: int) -> int:
    """Rows of the self-attention KV slab: right-sized to ``max_len`` (every
    step reads all of it) at the JAX package's 32-row granularity."""
    return min(ctx, -(-max_len // 32) * 32)


def _decode_setup(
    cfg, model, xa_kv, tokens_init, sample_begin, sot_index, ids, max_len,
    prefill_len, self_dtype,
):
    """Prefill + initial loop state. Returns (state, no_speech_probs)."""
    B = tokens_init.shape[0]
    ctx = cfg.n_text_ctx
    dev = tokens_init.device
    kv = init_kv_cache(cfg, B, self_cache_len(ctx, max_len), dtype=self_dtype, device=dev)
    tokens = tokens_init.to(torch.int64).clone()

    prefill_logits, kv = decoder_apply(cfg, model, tokens[:, :prefill_len], 0, kv, xa_kv)
    probs_at_sot = torch.softmax(prefill_logits[:, sot_index], dim=-1)
    no_speech_probs = probs_at_sot[:, ids.no_speech]

    state = _DecodeState(
        tokens=tokens,
        kv=kv,
        pos=sample_begin,
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        sum_lp=torch.zeros((B,), dtype=torch.float32, device=dev),
        tok_lps=torch.zeros((B, ctx), dtype=torch.float32, device=dev),
        # logits after the last REAL prompt token (the prefill's trailing
        # positions are padding).
        last_logits=prefill_logits[:, sample_begin - 1],
    )
    return state, no_speech_probs


def logit_processor(n_vocab, ids, suppress_mask, sample_begin, use_timestamps):
    """``process(logits [R, V], tokens [R, ctx], pos)``: the static
    suppression row (with blank and EOT barred as the first sample), then
    the timestamp rules. Shared by greedy and beam decoding."""
    vocab_idx = torch.arange(n_vocab, device=suppress_mask.device)
    start_row = torch.where(
        (vocab_idx == ids.blank) | (vocab_idx == ids.eot), NEG_INF, 0.0
    ).to(torch.float32)
    at_start_mask = suppress_mask + start_row

    def process(logits, tokens, pos):
        row = at_start_mask if pos == sample_begin else suppress_mask
        logits = logits + row[None, :]
        if use_timestamps:
            logits = apply_timestamp_rules(logits, tokens, pos, sample_begin, ids)
        return logits

    return process


def _decode_step_fn(cfg, model, xa_kv, ids, suppress_mask, sample_begin, use_timestamps):
    """The greedy step over a ``_DecodeState``, which it advances in place."""
    process_logits = logit_processor(cfg.n_vocab, ids, suppress_mask, sample_begin,
                                     use_timestamps)

    def step(st: _DecodeState) -> None:
        logits = process_logits(st.last_logits, st.tokens, st.pos)
        next_tok = torch.argmax(logits, dim=-1)
        # logprob of the chosen token = logit - logsumexp.
        tok_lp = logits.gather(1, next_tok[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
        next_tok = torch.where(st.done, ids.eot, next_tok)
        tok_lp = torch.where(st.done, 0.0, tok_lp)
        st.sum_lp = st.sum_lp + tok_lp
        st.tokens[:, st.pos] = next_tok
        st.tok_lps[:, st.pos] = tok_lp
        st.done = st.done | (next_tok == ids.eot)
        # Run the decoder on the token just written to get the next logits.
        st.last_logits, st.kv = decoder_step(cfg, model, next_tok, st.pos, st.kv, xa_kv)
        st.pos += 1

    return step


def _decode_result(state: _DecodeState, no_speech_probs, sample_begin, ids) -> DecodeResult:
    """lengths/avg over the final loop state: index of first EOT at/after
    sample_begin, else pos."""
    tokens, pos = state.tokens, state.pos
    ctx = tokens.shape[1]
    positions = torch.arange(ctx, device=tokens.device)[None, :]
    is_eot = (tokens == ids.eot) & (positions >= sample_begin) & (positions < pos)
    first_eot = torch.where(is_eot, positions, ctx).amin(dim=1)
    lengths = torch.clamp(first_eot + 1, max=pos)
    n_sampled = torch.clamp(lengths - sample_begin, min=1)
    return DecodeResult(
        tokens=tokens,
        lengths=lengths,
        sum_logprobs=state.sum_lp,
        avg_logprobs=state.sum_lp / n_sampled.float(),
        no_speech_probs=no_speech_probs,
        token_logprobs=state.tok_lps,
    )
