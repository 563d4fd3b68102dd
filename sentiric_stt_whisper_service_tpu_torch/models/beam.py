"""Beam-search decoding of one batch of 30 s windows, held against the JAX
package's ``models/beam.py``.

The JAX package runs the search as one device ``lax.while_loop`` (or host
chunks of it when it can be aborted); here, as for greedy decoding
(``models/sampling.py``), the step is one function over the search state in
tensors, updated in place with the position and the flags on the device,
that the host replays: a CUDA graph per self-cache read bucket on CUDA
(``models/graphs.py``), or eagerly. Beams ride the batch dimension: beam k
of item b is row b*K + k.

The KV cache is never reordered: each beam appends into its own slot, and
adopting a parent rewrites only the ancestry mask ``anc[b, kd, ks, c]`` (beam
kd reads position c from slot ks). The prompt is prefilled once at batch B
into slot 0 of each item, and the K beams of an item share its cross slab.

The rules are openai-whisper's BeamSearchDecoder, as in the JAX package:

  * each live beam proposes its top-(K+1) tokens, picked on the raw logits
    and then shifted to log-probabilities; at the first step only beam 0 is
    live;
  * the K best non-EOT candidates by cumulative log-probability become the
    next beams (a stable sort: the lower candidate index wins a tie, as
    ``lax.top_k``);
  * an EOT candidate is banked as finished if it outranks the K-th surviving
    non-EOT candidate, at most K per item over the window, in score order
    with the lower lane first on ties;
  * the window ends at ``max_len`` or, with ``early_stop``, once every item
    has banked K (the banked set cannot change after that; the host reads
    it once per chunk, and the device's flag freezes the state at once);
  * the winner has the best average log-probability over its sampled tokens
    among the banked hypotheses, the live lanes joining for items that banked
    fewer than K.

Self-cache reads are bounded to the JAX package's 128-row buckets of the slab
(exact: rows from the current position on are masked); ``cache_buckets=False``
reads the whole slab every step. Any beam size decodes: on CUDA, K5 and K6
take beam sizes above 8 in groups of at most 8 query beams
(``ops/beam_attention.py``). The folded rank-6 self cache of the JAX package
(``SSTW_BEAM_FOLD``, off by default there) is a TPU layout experiment and is
not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .graphs import DecodeGraphs, graphable, read_bound, run_window, to_host, window_loop
from .sampling import (
    NEG_INF,
    SYNC_STEPS,
    DecodeResult,
    TokenIds,
    _scalar,
    logit_processor,
    prompt_bucket,
    self_cache_len,
    xa_signature,
)
from .whisper import WhisperConfig, decoder_apply, decoder_step_beam, init_kv_cache, text_heads

READ_BUCKET = 128  # rows: the JAX package's self-cache read buckets


def topk_small(logits: torch.Tensor, k: int):
    """Top-k over the last axis as k argmax passes → (values, indices).

    ``torch.argmax`` returns the first maximum, as ``jnp.argmax``, and each
    winner is masked to NEG_INF before the next pass, so ties come out in
    index order: the JAX package's ``topk_small``, which equals
    ``lax.top_k`` while each row has k entries above NEG_INF."""
    x = logits.clone()
    vals, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(x, dim=-1, keepdim=True)
        vals.append(x.gather(-1, idx))
        idxs.append(idx)
        x.scatter_(-1, idx, NEG_INF)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def read_bucket(pos: int, cache_len: int) -> int:
    """Self-cache rows a step at ``pos`` reads: the smallest 128-row bucket
    past ``pos``, else the whole slab."""
    return read_bound(pos, read_bounds(cache_len))


@dataclasses.dataclass
class _BeamState:
    """The search state, updated in place by the step."""

    tokens: torch.Tensor  # [BK, ctx] int64
    kv: dict  # slot caches [L, BK, H, C, hd]
    anc: torch.Tensor  # [B, K, K, C] bool
    pos: torch.Tensor  # [1] int64: where the next token goes (shared by every beam)
    until: torch.Tensor  # [1] int64: the window's last position + 1
    sample_begin: torch.Tensor  # [1] int64
    sum_lp: torch.Tensor  # [BK] f32
    tok_lps: torch.Tensor  # [BK, ctx] f32
    last_logits: torch.Tensor  # [BK, V] f32: logits for position pos
    bank_count: torch.Tensor  # [B] int64: finished hypotheses banked
    best_avg: torch.Tensor  # [B] f32: the best banked hypothesis ...
    best_sum: torch.Tensor  # [B] f32
    best_len: torch.Tensor  # [B] int64
    best_tokens: torch.Tensor  # [B, ctx] int64
    best_lps: torch.Tensor  # [B, ctx] f32


def read_bounds(cache_len: int, cache_buckets: bool = True) -> list:
    """The step's self-cache read bounds: the 128-row buckets of the slab, or
    the whole slab only."""
    if not cache_buckets:
        return [cache_len]
    return list(range(READ_BUCKET, cache_len, READ_BUCKET)) + [cache_len]


@torch.inference_mode()
def decode_window_beam(
    cfg: WhisperConfig,
    model,
    xa_kv: dict,  # [L, B, H, hd, 1500] KF (+ scales when quantized)
    tokens_init: torch.Tensor,  # [B, ctx] int, prompt in [0, sample_begin)
    sample_begin: int,
    sot_index: int,
    ids: TokenIds,
    suppress_mask: torch.Tensor,  # [V] additive
    beam_size: int = 5,
    max_len: Optional[int] = None,
    use_timestamps: bool = True,
    prefill_len: Optional[int] = None,
    self_dtype: Optional[torch.dtype] = None,
    cache_buckets: bool = True,
    early_stop: bool = True,
    should_abort=None,
    abort_chunk: int = 32,
    graphs: Optional[DecodeGraphs] = None,
    graph: bool = True,
) -> Optional[DecodeResult]:
    """Beam-search decode; the best hypothesis per item, with the contract of
    greedy ``decode_window``'s ``DecodeResult``.

    Self-cache storage: on CUDA the slab is stored in the compute dtype
    (``cfg.dtype``, bf16), the form K5 reads, whatever ``self_dtype`` asks.
    This mirrors the JAX package's ``decode_window_beam``
    (``models/beam.py:141-148``), which stores it so whenever its fused beam
    kernel runs, always on the TPU; it is not a fallback. On the CPU
    ``self_dtype`` is honoured (``torch.float8_e4m3fn``), as the JAX package
    does off the TPU. ``early_stop=False`` runs to ``max_len``; its output is
    the same. ``prefill_len``, ``should_abort`` / ``abort_chunk``, ``graphs``
    and ``graph`` as in ``decode_window``; None if aborted."""
    K = int(beam_size)
    sample_begin, sot_index = int(sample_begin), int(sot_index)
    prefill_len = prefill_len or prompt_bucket(sample_begin)
    max_len = max_len or cfg.n_text_ctx
    if should_abort is not None and should_abort():
        return None
    B, ctx = tokens_init.shape
    dev = tokens_init.device
    if dev.type == "cuda":
        self_dtype = None
    kv_dtype = self_dtype or cfg.dtype
    cache_len = self_cache_len(ctx, max_len)
    bounds = read_bounds(cache_len, cache_buckets)
    inputs = {"xa": xa_kv, "suppress": suppress_mask}
    n_head = text_heads(cfg, model)
    graph = graph and graphable(model)

    def make(inp, _gen):
        f32 = dict(dtype=torch.float32, device=dev)
        state = _BeamState(
            tokens=torch.zeros((B * K, ctx), dtype=torch.int64, device=dev),
            kv=init_kv_cache(cfg, B * K, cache_len, dtype=kv_dtype, device=dev, n_head=n_head),
            anc=torch.zeros((B, K, K, cache_len), dtype=torch.bool, device=dev),
            pos=_scalar(0, torch.int64, dev),
            until=_scalar(0, torch.int64, dev),
            sample_begin=_scalar(0, torch.int64, dev),
            sum_lp=torch.zeros((B * K,), **f32),
            tok_lps=torch.zeros((B * K, ctx), **f32),
            last_logits=torch.zeros((B * K, cfg.n_vocab), **f32),
            bank_count=torch.zeros((B,), dtype=torch.int64, device=dev),
            best_avg=torch.zeros((B,), **f32),
            best_sum=torch.zeros((B,), **f32),
            best_len=torch.zeros((B,), dtype=torch.int64, device=dev),
            best_tokens=torch.zeros((B, ctx), dtype=torch.int64, device=dev),
            best_lps=torch.zeros((B, ctx), **f32),
        )
        return state, _beam_step_fn(cfg, model, inp, ids, K, B, use_timestamps, early_stop)

    key = ("beam", id(model), B, K, ctx, cache_len, tuple(bounds), kv_dtype,
           xa_signature(xa_kv), ids, use_timestamps, early_stop)
    loop = window_loop(dev, graph, graphs, key, make, inputs, bounds, None)
    st = loop.state
    no_speech_probs = _beam_setup(cfg, model, st, xa_kv, tokens_init, sample_begin, sot_index,
                                  ids, K, prefill_len, max_len, kv_dtype)

    def finished() -> bool:
        return early_stop and bool(to_host((st.bank_count >= K).all()))

    if not run_window(loop, sample_begin, max_len, bounds, finished, should_abort,
                      abort_chunk if should_abort else SYNC_STEPS):
        return None
    return _beam_result(st, no_speech_probs, sample_begin, K)


def _beam_setup(cfg, model, st: _BeamState, xa_kv, tokens_init, sample_begin, sot_index, ids,
                K, prefill_len, max_len, kv_dtype):
    """Prefill once at batch B into slot 0 of each item, and the initial
    search state. Returns no_speech_probs [B]."""
    B = tokens_init.shape[0]
    dev = tokens_init.device
    tokens = tokens_init.to(torch.int64)
    kv_b = init_kv_cache(cfg, B, st.anc.shape[-1], dtype=kv_dtype, device=dev,
                         n_head=text_heads(cfg, model))
    prefill_logits, kv_b = decoder_apply(cfg, model, tokens[:, :prefill_len], 0, kv_b, xa_kv)
    for name, t in kv_b.items():
        slots = st.kv[name].view(t.shape[0], B, K, *t.shape[2:])
        slots.zero_()
        slots[:, :, 0] = t
    # Every beam reads the prompt positions from slot 0.
    st.anc.zero_()
    st.anc[:, :, 0, :sample_begin] = True
    st.tokens.copy_(tokens.repeat_interleave(K, dim=0))
    st.pos.fill_(sample_begin)
    st.until.fill_(max_len)
    st.sample_begin.fill_(sample_begin)
    st.sum_lp.zero_()
    st.tok_lps.zero_()
    st.last_logits.copy_(prefill_logits[:, sample_begin - 1].repeat_interleave(K, dim=0))
    st.bank_count.zero_()
    st.best_avg.fill_(NEG_INF)
    st.best_sum.zero_()
    st.best_len.zero_()
    st.best_tokens.copy_(tokens)
    st.best_lps.zero_()
    return torch.softmax(prefill_logits[:, sot_index], dim=-1)[:, ids.no_speech]


def _beam_step_fn(cfg, model, inp, ids, K, B, use_timestamps, early_stop):
    """The beam step over a ``_BeamState`` and the loop's inputs ``inp``;
    ``step(state, c_valid)`` updates the state in place. Every update is
    gated by ``active = pos < until`` (and, with ``early_stop``, some item
    short of K banked), the JAX package's ``cond_fn``."""
    process_logits = logit_processor(cfg.n_vocab, ids, inp["suppress"], use_timestamps)
    xa_kv = inp["xa"]
    dev = inp["suppress"].device
    BK = B * K
    lane_of = torch.arange(BK, device=dev) % K
    item_base = torch.arange(B, device=dev) * K
    items = torch.arange(B, device=dev)[:, None]
    eye_k = torch.eye(K, dtype=torch.bool, device=dev)
    lane = torch.arange(K, device=dev)

    def step(st: _BeamState, c_valid: int) -> None:
        pos, sb = st.pos, st.sample_begin
        active = pos < st.until
        if early_stop:
            active = active & ~(st.bank_count >= K).all()
        logits = process_logits(st.last_logits, st.tokens, pos, sb)  # [BK, V]
        top_val, top_tok = topk_small(logits, K + 1)
        top_lp = top_val - torch.logsumexp(logits, dim=-1)[:, None]
        lane_live = ~((pos == sb) & (lane_of > 0))

        # The next live lanes: the K best non-EOT candidates of each item.
        is_eot = top_tok == ids.eot  # [BK, K+1]
        noneot_lp = torch.where(is_eot, NEG_INF, top_lp)
        cand = torch.where(lane_live[:, None], st.sum_lp[:, None] + noneot_lp, NEG_INF)
        best_scores, best_idx = torch.sort(cand.reshape(B, K * (K + 1)), dim=1,
                                           descending=True, stable=True)
        best_scores, best_idx = best_scores[:, :K], best_idx[:, :K]
        kth_score = best_scores[:, K - 1]

        # Bank the EOT candidates that outrank the K-th live candidate, at
        # most K per item, in score order; keep the best by average.
        eot_lp = torch.where(is_eot, top_lp, 0.0).sum(dim=-1)  # [BK]
        has_eot = is_eot.any(dim=-1) & lane_live
        eot_score = torch.where(has_eot, st.sum_lp + eot_lp, NEG_INF).reshape(B, K)
        valid = eot_score > kth_score[:, None]
        s = torch.where(valid, eot_score, NEG_INF)
        beats = (s[:, None, :] > s[:, :, None]) | (
            (s[:, None, :] == s[:, :, None]) & (lane[None, None, :] < lane[None, :, None]))
        rank = (valid[:, None, :] & beats).sum(dim=-1)  # [B, K]
        quota = (K - st.bank_count).clamp(min=0)
        accepted = valid & (rank < quota[:, None])
        bank_count = st.bank_count + accepted.sum(dim=-1)

        n_tok = (pos + 1 - sb).clamp(min=1).float()
        avg_acc = torch.where(accepted, eot_score / n_tok, NEG_INF)
        step_lane = torch.argmax(avg_acc, dim=-1)  # [B]
        step_avg = avg_acc.gather(1, step_lane[:, None])[:, 0]
        improve = step_avg > st.best_avg
        sel = item_base + step_lane
        rows_tok = st.tokens[sel]
        rows_tok.index_fill_(1, pos, ids.eot)
        rows_lp = st.tok_lps[sel]
        rows_lp.index_copy_(1, pos, eot_lp[sel][:, None])
        best_tokens = torch.where(improve[:, None], rows_tok, st.best_tokens)
        best_lps = torch.where(improve[:, None], rows_lp, st.best_lps)
        best_sum = torch.where(improve, eot_score.gather(1, step_lane[:, None])[:, 0],
                               st.best_sum)
        best_avg = torch.where(improve, step_avg, st.best_avg)
        best_len = torch.where(improve, pos + 1, st.best_len)

        # Advance the live lanes: gather the small per-beam state by parent;
        # the KV cache stays, only the ancestry mask adopts the parent's path
        # and each beam's next row lands in its own slot at pos.
        parent = best_idx // (K + 1)
        tok_sel = top_tok.reshape(B, K * (K + 1)).gather(1, best_idx)
        lp_sel = noneot_lp.reshape(B, K * (K + 1)).gather(1, best_idx)
        gather_idx = (item_base[:, None] + parent).reshape(BK)
        next_tok = tok_sel.reshape(BK)
        tokens = st.tokens[gather_idx]
        tokens.index_copy_(1, pos, next_tok[:, None])
        tok_lps = st.tok_lps[gather_idx]
        tok_lps.index_copy_(1, pos, lp_sel.reshape(BK, 1))
        anc = st.anc[items, parent]
        anc.index_copy_(3, pos, anc.index_select(3, pos) | eye_k[:, :, None])

        logits, _ = decoder_step_beam(cfg, model, next_tok, pos, st.kv, xa_kv, anc, K,
                                      c_valid=c_valid)
        for buf, new in ((st.tokens, tokens), (st.tok_lps, tok_lps),
                         (st.sum_lp, best_scores.reshape(BK)), (st.anc, anc),
                         (st.last_logits, logits), (st.bank_count, bank_count),
                         (st.best_avg, best_avg), (st.best_sum, best_sum),
                         (st.best_len, best_len), (st.best_tokens, best_tokens),
                         (st.best_lps, best_lps)):
            buf.copy_(torch.where(active, new, buf))
        st.pos.add_(active.to(torch.int64))

    return step


def _beam_result(state: _BeamState, no_speech_probs, sample_begin, K) -> DecodeResult:
    """The winner per item: the best banked hypothesis by average
    log-probability, or the best live lane for an item that banked fewer
    than K and whose live lane averages better (openai's finalize fill).
    Every output is a new tensor, not a view of the state."""
    BK = state.tokens.shape[0]
    B = BK // K
    item_base = torch.arange(B, device=state.tokens.device) * K
    avg_live = (state.sum_lp / (state.pos - sample_begin).clamp(min=1).float()).reshape(B, K)
    live_best = torch.argmax(avg_live, dim=1)
    live_avg = avg_live.gather(1, live_best[:, None])[:, 0]
    use_live = (state.bank_count < K) & (live_avg > state.best_avg)
    sel = item_base + live_best
    return DecodeResult(
        tokens=torch.where(use_live[:, None], state.tokens[sel], state.best_tokens),
        lengths=torch.where(use_live, state.pos, state.best_len),
        sum_logprobs=torch.where(use_live, state.sum_lp[sel], state.best_sum),
        avg_logprobs=torch.where(use_live, live_avg, state.best_avg),
        no_speech_probs=no_speech_probs,
        token_logprobs=torch.where(use_live[:, None], state.tok_lps[sel], state.best_lps),
    )
