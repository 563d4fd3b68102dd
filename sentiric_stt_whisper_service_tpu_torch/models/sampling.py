"""Greedy and sampled autoregressive decoding with whisper's suppression
and timestamp rules, held against the JAX package's ``models/sampling.py``.

The JAX package runs a window's token loop on the device: one jitted
``lax.while_loop`` from prefill to finalize, or host chunks of it when the
decode can be aborted. Here the step is one function over the loop state in
tensors, which it updates in place, with the position, the end of the
window and the "every row is done" flag on the device; the host replays it
(``models/graphs.py``): on CUDA as a captured CUDA graph, one per self-cache
read bound, and on the CPU, or on CUDA with ``graph=False``, by calling the
same function eagerly. The host keeps its own count of the position and
reads the device once per chunk (and polls ``should_abort``, when given,
before each). The rules are vectorized [B, vocab] logit masks, as in the
JAX package:

  * static suppression set (non-speech tokens, sot/notimestamps/...),
  * blank and EOT suppression at sample start,
  * whisper timestamp pairing rules + monotonicity + max_initial_timestamp,
  * "sum of timestamp probs > max text prob ⇒ force timestamp",
  * temperature 0 = argmax (the first maximum on ties, as ``jnp.argmax``),
    else a categorical draw: the argmax of logits / T plus Gumbel noise
    from a ``torch.Generator`` (``jax.random.categorical``'s method; the
    draws differ from JAX's). The temperature is a device scalar, so every
    rung of a fallback ladder above 0 shares one graph.

Best-of sampling (``decode_window_best_of``) and language detection
(``detect_language``) are here too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .graphs import DecodeGraphs, graphable, run_window, to_host, window_loop
from .whisper import WhisperConfig, decoder_apply, decoder_step, init_kv_cache, text_heads

# Steps between two reads of the device when nothing is polled: each read
# stalls the host once, and a window whose rows all finish mid-chunk runs
# the rest of the chunk's replays as no-ops.
SYNC_STEPS = 16


def cvalid_buckets(cache_len: int, granularity: Optional[int] = None) -> list:
    """Self-cache read bounds of the greedy loop: a step at position p reads
    rows [0, b) for the first bound b above p (exact: rows past p are
    masked). ``granularity`` rows apart, the last the whole slab; 0 or None
    reads the whole slab every step (the JAX package's default)."""
    g = granularity or 0
    if g <= 0 or g >= cache_len:
        return [cache_len]
    return list(range(g, cache_len, g)) + [cache_len]


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

    ctx = tokens.shape[1]

    def tok_at(idx):
        """[B] gather of tokens[b, idx[b]]; past the buffer's end (a
        speculative round's overshoot) int32's minimum, as
        ``jnp.take_along_axis`` fills it."""
        got = torch.gather(tokens, 1, idx.clamp(0, ctx - 1)[:, None].to(torch.int64))[:, 0]
        return torch.where(idx < ctx, got, -2**31)

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
    """The greedy loop's state, updated in place by the step."""

    tokens: torch.Tensor  # [B, ctx] int64
    kv: dict
    pos: torch.Tensor  # [1] int64: where the next token goes (shared by every row)
    until: torch.Tensor  # [1] int64: the window's last position + 1
    sample_begin: torch.Tensor  # [1] int64
    done: torch.Tensor  # [B] bool
    sum_lp: torch.Tensor  # [B] f32
    tok_lps: torch.Tensor  # [B, ctx] f32
    last_logits: torch.Tensor  # [B, V] f32: logits for position pos


def self_cache_len(ctx: int, max_len: int) -> int:
    """Rows of the self-attention KV slab: right-sized to ``max_len`` (every
    step reads all of it) at the JAX package's 32-row granularity."""
    return min(ctx, -(-max_len // 32) * 32)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.full((1,), value, dtype=dtype, device=device)


def xa_signature(xa_kv: dict) -> tuple:
    """The cross slab's form, part of a graph's shape class."""
    return tuple((name, tuple(t.shape), t.dtype) for name, t in sorted(xa_kv.items()))


@torch.inference_mode()
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
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    use_timestamps: bool = True,
    prefill_len: Optional[int] = None,
    self_dtype: Optional[torch.dtype] = None,
    cvalid_rows: Optional[int] = None,
    should_abort=None,
    abort_chunk: int = 32,
    sample_cap: Optional[int] = None,
    graphs: Optional[DecodeGraphs] = None,
    graph: bool = True,
) -> Optional[DecodeResult]:
    """Decode one batch of 30 s windows to EOT or ``max_len``.

    The prompt prefills at ``prefill_len`` (default: its bucket,
    ``prompt_bucket``); positions in [sample_begin, prefill_len) hold EOT
    padding whose K/V entries are never attended — each decode step
    overwrites its cache row before reading it. ``sample_cap`` bounds the
    sampled tokens (the window stops at ``sample_begin + sample_cap`` if that
    is before ``max_len``). ``self_dtype`` overrides the self-KV-cache
    storage dtype (``torch.float8_e4m3fn``). ``cvalid_rows`` reads the self
    cache in buckets of that many rows (``cvalid_buckets``).

    ``temperature`` > 0 samples, drawing from ``generator`` (default: the
    device's default generator). ``should_abort``, polled before the prefill
    and before every ``abort_chunk`` steps, as in the JAX package, returns
    None from the window when it fires.

    On CUDA the step replays as a CUDA graph of its shape class, kept in
    ``graphs`` (the caller's cache; one made for this call if none is
    given); ``graph=False`` decodes eagerly. Both give the same result.

    On a mesh (``parallel/mesh.shard_params``) each rank decodes its dp rows
    of ``tokens_init`` and ``xa_kv`` with its tp heads, in a self cache of
    those heads; a model split over tp decodes eagerly (a CUDA graph would
    not capture its all-reduces over gloo, which run on the host)."""
    sample_begin, sot_index = int(sample_begin), int(sot_index)
    prefill_len = prefill_len or prompt_bucket(sample_begin)
    max_len = max_len or cfg.n_text_ctx
    hard_stop = max_len if sample_cap is None else min(max_len, sample_begin + int(sample_cap))
    if should_abort is not None and should_abort():
        return None
    B, ctx = tokens_init.shape
    dev = tokens_init.device
    cache_len = self_cache_len(ctx, max_len)
    bounds = cvalid_buckets(cache_len, cvalid_rows)
    sampled = float(temperature) > 0.0
    kv_dtype = self_dtype or cfg.dtype
    n_head = text_heads(cfg, model)
    graph = graph and graphable(model)
    inputs = {"xa": xa_kv, "suppress": suppress_mask,
              "temperature": _scalar(float(temperature), torch.float32, dev)}

    def make(inp, gen):
        state = _DecodeState(
            tokens=torch.zeros((B, ctx), dtype=torch.int64, device=dev),
            kv=init_kv_cache(cfg, B, cache_len, dtype=kv_dtype, device=dev, n_head=n_head),
            pos=_scalar(0, torch.int64, dev),
            until=_scalar(0, torch.int64, dev),
            sample_begin=_scalar(0, torch.int64, dev),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            sum_lp=torch.zeros((B,), dtype=torch.float32, device=dev),
            tok_lps=torch.zeros((B, ctx), dtype=torch.float32, device=dev),
            last_logits=torch.zeros((B, cfg.n_vocab), dtype=torch.float32, device=dev),
        )
        return state, _decode_step_fn(cfg, model, inp, ids, use_timestamps, sampled, gen)

    key = ("greedy", id(model), B, ctx, cache_len, tuple(bounds), kv_dtype,
           xa_signature(xa_kv), ids, use_timestamps, sampled, generator is not None)
    loop = window_loop(dev, graph, graphs, key, make, inputs, bounds, generator)
    st = loop.state
    no_speech_probs = _decode_setup(cfg, model, st, xa_kv, tokens_init, sample_begin,
                                    sot_index, ids, prefill_len, hard_stop)
    with loop.drawing_from(generator):
        if not run_window(loop, sample_begin, hard_stop, bounds,
                          lambda: bool(to_host(st.done.all())),
                          should_abort, abort_chunk if should_abort else SYNC_STEPS):
            return None
    return _decode_result(st, no_speech_probs, sample_begin, ids)


def _decode_setup(cfg, model, st: _DecodeState, xa_kv, tokens_init, sample_begin, sot_index,
                  ids, prefill_len, hard_stop):
    """Prefill into the loop's state and set its scalars. Returns
    no_speech_probs [B]."""
    st.tokens.copy_(tokens_init)
    for t in st.kv.values():
        t.zero_()
    prefill_logits, _ = decoder_apply(cfg, model, st.tokens[:, :prefill_len], 0, st.kv, xa_kv)
    probs_at_sot = torch.softmax(prefill_logits[:, sot_index], dim=-1)
    st.pos.fill_(sample_begin)
    st.until.fill_(hard_stop)
    st.sample_begin.fill_(sample_begin)
    st.done.zero_()
    st.sum_lp.zero_()
    st.tok_lps.zero_()
    # logits after the last REAL prompt token (the prefill's trailing
    # positions are padding).
    st.last_logits.copy_(prefill_logits[:, sample_begin - 1])
    return probs_at_sot[:, ids.no_speech]


def logit_processor(n_vocab, ids, suppress_mask, use_timestamps):
    """``process(logits [R, V], tokens [R, ctx], pos, sample_begin)`` (the
    last two device scalars): the static suppression row, with blank and EOT
    barred as the first sample, then the timestamp rules. Shared by greedy
    and beam decoding."""
    vocab_idx = torch.arange(n_vocab, device=suppress_mask.device)
    start_row = torch.where(
        (vocab_idx == ids.blank) | (vocab_idx == ids.eot), NEG_INF, 0.0
    ).to(torch.float32)

    def process(logits, tokens, pos, sample_begin):
        at_start = pos == sample_begin
        logits = logits + (suppress_mask + torch.where(at_start, start_row, 0.0))[None, :]
        if use_timestamps:
            logits = apply_timestamp_rules(logits, tokens, pos, sample_begin, ids)
        return logits

    return process


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One categorical draw per row at ``temperature`` (a device scalar):
    the argmax of logits / max(T, 1e-6) plus Gumbel noise -log(-log(u)),
    u uniform from ``generator`` on the logits' device."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits / temperature.clamp(min=1e-6) - torch.log(-torch.log(u)), dim=-1)


def write_column(buf: torch.Tensor, pos: torch.Tensor, value: torch.Tensor, active) -> None:
    """``buf[:, pos] = value`` in place where ``active`` (a device flag),
    for a device ``pos`` ([1] int64)."""
    old = buf.index_select(1, pos)[:, 0]
    buf.index_copy_(1, pos, torch.where(active, value, old)[:, None])


def _decode_step_fn(cfg, model, inp, ids, use_timestamps, sampled, generator):
    """The greedy (or sampled) step over a ``_DecodeState`` and the loop's
    inputs ``inp``; ``step(state, c_valid)`` updates the state in place.
    Every update of the small state is gated by ``active = pos < until and
    not every row done``, the JAX package's ``cond_fn``, so a step past the
    end of the window changes nothing that ``_decode_result`` reads (its
    K/V row, written at the frozen position, is never read)."""
    process_logits = logit_processor(cfg.n_vocab, ids, inp["suppress"], use_timestamps)
    xa_kv = inp["xa"]

    def step(st: _DecodeState, c_valid: int) -> None:
        active = (st.pos < st.until) & ~st.done.all()
        logits = process_logits(st.last_logits, st.tokens, st.pos, st.sample_begin)
        if sampled:
            next_tok = sample_tokens(logits, inp["temperature"], generator)
        else:
            next_tok = torch.argmax(logits, dim=-1)
        # logprob of the chosen token = logit - logsumexp.
        tok_lp = logits.gather(1, next_tok[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)
        next_tok = torch.where(st.done, ids.eot, next_tok)
        tok_lp = torch.where(st.done, 0.0, tok_lp)
        write_column(st.tokens, st.pos, next_tok, active)
        write_column(st.tok_lps, st.pos, tok_lp, active)
        st.sum_lp.copy_(torch.where(active, st.sum_lp + tok_lp, st.sum_lp))
        st.done.copy_(torch.where(active, st.done | (next_tok == ids.eot), st.done))
        # Run the decoder on the token just written to get the next logits.
        logits, _ = decoder_step(cfg, model, next_tok, st.pos, st.kv, xa_kv, c_valid=c_valid)
        st.last_logits.copy_(torch.where(active, logits, st.last_logits))
        st.pos.add_(active.to(torch.int64))

    return step


def _decode_result(state: _DecodeState, no_speech_probs, sample_begin, ids) -> DecodeResult:
    """lengths/avg over the final loop state: index of first EOT at/after
    sample_begin, else pos. The outputs are copies: the state may be a graph
    class's, which its next request overwrites."""
    tokens, pos = state.tokens, state.pos
    ctx = tokens.shape[1]
    positions = torch.arange(ctx, device=tokens.device)[None, :]
    is_eot = (tokens == ids.eot) & (positions >= sample_begin) & (positions < pos)
    first_eot = torch.where(is_eot, positions, ctx).amin(dim=1)
    lengths = torch.minimum(first_eot + 1, pos)
    n_sampled = torch.clamp(lengths - sample_begin, min=1)
    return DecodeResult(
        tokens=tokens.clone(),
        lengths=lengths,
        sum_logprobs=state.sum_lp.clone(),
        avg_logprobs=state.sum_lp / n_sampled.float(),
        no_speech_probs=no_speech_probs,
        token_logprobs=state.tok_lps.clone(),
    )


def select_best_of(res: DecodeResult, batch: int, best_of: int) -> DecodeResult:
    """Per item, the sample with the best average log-probability (the first
    on ties, as ``jnp.argmax``) of ``best_of`` samples in rows b*G .. b*G+G-1."""
    best = torch.argmax(res.avg_logprobs.reshape(batch, best_of), dim=1)
    sel = torch.arange(batch, device=best.device) * best_of + best
    return DecodeResult(*(x[sel] for x in res))


@torch.inference_mode()
def decode_window_best_of(
    cfg: WhisperConfig,
    model,
    xa_kv: dict,
    tokens_init: torch.Tensor,
    sample_begin: int,
    sot_index: int,
    ids: TokenIds,
    suppress_mask: torch.Tensor,
    temperature: float,
    generator: Optional[torch.Generator] = None,
    best_of: int = 5,
    **kwargs,
) -> Optional[DecodeResult]:
    """``best_of`` independent samples per item (temperature > 0), the winner
    by average log-probability: openai-whisper's n_group sampling, batched as
    [B*G] rows with the cross slab repeated over the batch axis, as the JAX
    package's ``decode_window_best_of``. ``kwargs`` go to ``decode_window``;
    None if aborted."""
    B = tokens_init.shape[0]
    res = decode_window(
        cfg, model, {k: v.repeat_interleave(best_of, dim=1) for k, v in xa_kv.items()},
        tokens_init.repeat_interleave(best_of, dim=0), sample_begin, sot_index, ids,
        suppress_mask, temperature, generator, **kwargs)
    return None if res is None else select_best_of(res, B, best_of)


@torch.inference_mode()
def detect_language(cfg: WhisperConfig, model, xa_kv: dict, sot: int, lang_begin: int,
                    n_langs: int) -> torch.Tensor:
    """One decoder step from [sot], masked to the language tokens: [B,
    n_langs] probabilities (whisper's detect_language, the JAX package's
    ``detect_language``)."""
    B = next(iter(xa_kv.values())).shape[1]
    dev = next(iter(xa_kv.values())).device
    kv = init_kv_cache(cfg, B, 64, device=dev, n_head=text_heads(cfg, model))
    tokens = torch.full((B, 1), sot, dtype=torch.int64, device=dev)
    logits, _ = decoder_apply(cfg, model, tokens, 0, kv, xa_kv)
    return torch.softmax(logits[:, 0, lang_begin:lang_begin + n_langs], dim=-1)
