"""Beam-search decoding of one batch of 30 s windows, held against the JAX
package's ``models/beam.py``.

The JAX package runs the search as one device ``lax.while_loop``; here it is
a Python loop over ``decoder_step_beam`` (``models/whisper.py``), as greedy
``models/sampling.decode_window`` loops over ``decoder_step``. Beams ride the
batch dimension: beam k of item b is row b*K + k.

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
    has banked K (the banked set cannot change after that);
  * the winner has the best average log-probability over its sampled tokens
    among the banked hypotheses, the live lanes joining for items that banked
    fewer than K.

Self-cache reads are bounded to the JAX package's 128-row buckets of the slab
(exact: rows from the current position on are masked).

Abortable chunked decoding (``should_abort``) comes with the engine slice.
The folded rank-6 self cache of the JAX package (``SSTW_BEAM_FOLD``, off by
default there) is a TPU layout experiment and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .sampling import (
    NEG_INF,
    DecodeResult,
    TokenIds,
    logit_processor,
    prompt_bucket,
    self_cache_len,
)
from .whisper import WhisperConfig, decoder_apply, decoder_step_beam, init_kv_cache

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
    return min(cache_len, (pos // READ_BUCKET + 1) * READ_BUCKET)


@dataclasses.dataclass
class _BeamState:
    tokens: torch.Tensor  # [BK, ctx] int64
    kv: dict  # slot caches [L, BK, H, C, hd]
    anc: torch.Tensor  # [B, K, K, C] bool
    pos: int  # where the next token goes (shared by every beam)
    sum_lp: torch.Tensor  # [BK] f32
    tok_lps: torch.Tensor  # [BK, ctx] f32
    last_logits: torch.Tensor  # [BK, V] f32: logits for position pos
    bank_count: torch.Tensor  # [B] int64: finished hypotheses banked
    best_avg: torch.Tensor  # [B] f32: the best banked hypothesis ...
    best_sum: torch.Tensor  # [B] f32
    best_len: torch.Tensor  # [B] int64
    best_tokens: torch.Tensor  # [B, ctx] int64
    best_lps: torch.Tensor  # [B, ctx] f32


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
    self_dtype: Optional[torch.dtype] = None,
    early_stop: bool = True,
    should_abort=None,
) -> DecodeResult:
    """Beam-search decode; the best hypothesis per item, with the contract of
    greedy ``decode_window``'s ``DecodeResult``.

    Self-cache storage: on CUDA the slab is stored in the compute dtype
    (``cfg.dtype``, bf16), the form K5 reads, whatever ``self_dtype`` asks.
    This mirrors the JAX package's ``decode_window_beam``
    (``models/beam.py:141-148``), which stores it so whenever its fused beam
    kernel runs, always on the TPU; it is not a fallback. On the CPU
    ``self_dtype`` is honoured (``torch.float8_e4m3fn``), as the JAX package
    does off the TPU. ``early_stop=False`` runs to ``max_len``; its output is
    the same."""
    if should_abort is not None:
        raise NotImplementedError("abortable chunked decoding comes with the engine slice")
    K = int(beam_size)
    sample_begin, sot_index = int(sample_begin), int(sot_index)
    max_len = max_len or cfg.n_text_ctx
    if tokens_init.device.type == "cuda":
        self_dtype = None
    state, no_speech_probs = _beam_setup(
        cfg, model, xa_kv, tokens_init, sample_begin, sot_index, ids, K, max_len, self_dtype)
    step = _beam_step_fn(cfg, model, xa_kv, ids, suppress_mask, K, tokens_init.shape[0],
                         sample_begin, use_timestamps)
    while state.pos < max_len:
        if early_stop and bool((state.bank_count >= K).all()):
            break
        step(state)
    return _beam_result(state, no_speech_probs, sample_begin, K)


def _beam_setup(cfg, model, xa_kv, tokens_init, sample_begin, sot_index, ids, K, max_len,
                self_dtype):
    """Prefill once at batch B into slot 0 of each item; the initial state.
    Returns (state, no_speech_probs)."""
    B, ctx = tokens_init.shape
    dev = tokens_init.device
    cache_len = self_cache_len(ctx, max_len)
    tokens = tokens_init.to(torch.int64)
    kv_b = init_kv_cache(cfg, B, cache_len, dtype=self_dtype, device=dev)
    prefill_logits, kv_b = decoder_apply(
        cfg, model, tokens[:, : prompt_bucket(sample_begin)], 0, kv_b, xa_kv)
    kv = init_kv_cache(cfg, B * K, cache_len, dtype=self_dtype, device=dev)
    for name, t in kv_b.items():
        kv[name].view(t.shape[0], B, K, *t.shape[2:])[:, :, 0] = t
    # Every beam reads the prompt positions from slot 0.
    anc = torch.zeros((B, K, K, cache_len), dtype=torch.bool, device=dev)
    anc[:, :, 0, :sample_begin] = True

    no_speech_probs = torch.softmax(prefill_logits[:, sot_index], dim=-1)[:, ids.no_speech]
    state = _BeamState(
        tokens=tokens.repeat_interleave(K, dim=0),
        kv=kv,
        anc=anc,
        pos=sample_begin,
        sum_lp=torch.zeros((B * K,), dtype=torch.float32, device=dev),
        tok_lps=torch.zeros((B * K, ctx), dtype=torch.float32, device=dev),
        last_logits=prefill_logits[:, sample_begin - 1].repeat_interleave(K, dim=0),
        bank_count=torch.zeros((B,), dtype=torch.int64, device=dev),
        best_avg=torch.full((B,), NEG_INF, dtype=torch.float32, device=dev),
        best_sum=torch.zeros((B,), dtype=torch.float32, device=dev),
        best_len=torch.zeros((B,), dtype=torch.int64, device=dev),
        best_tokens=tokens.clone(),
        best_lps=torch.zeros((B, ctx), dtype=torch.float32, device=dev),
    )
    return state, no_speech_probs


def _beam_step_fn(cfg, model, xa_kv, ids, suppress_mask, K, B, sample_begin, use_timestamps):
    """The beam step over a ``_BeamState``, which it advances in place."""
    process_logits = logit_processor(cfg.n_vocab, ids, suppress_mask, sample_begin,
                                     use_timestamps)
    dev = suppress_mask.device
    BK = B * K
    lane_of = torch.arange(BK, device=dev) % K
    item_base = torch.arange(B, device=dev) * K
    items = torch.arange(B, device=dev)[:, None]
    eye_k = torch.eye(K, dtype=torch.bool, device=dev)
    lane = torch.arange(K, device=dev)

    def step(st: _BeamState) -> None:
        pos = st.pos
        logits = process_logits(st.last_logits, st.tokens, pos)  # [BK, V]
        top_val, top_tok = topk_small(logits, K + 1)
        top_lp = top_val - torch.logsumexp(logits, dim=-1)[:, None]
        lane_live = ~((pos == sample_begin) & (lane_of > 0))

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
        st.bank_count = st.bank_count + accepted.sum(dim=-1)

        avg_acc = torch.where(accepted, eot_score / float(max(pos + 1 - sample_begin, 1)),
                              NEG_INF)
        step_lane = torch.argmax(avg_acc, dim=-1)  # [B]
        step_avg = avg_acc.gather(1, step_lane[:, None])[:, 0]
        improve = step_avg > st.best_avg
        sel = item_base + step_lane
        rows_tok = st.tokens[sel]
        rows_tok[:, pos] = ids.eot
        rows_lp = st.tok_lps[sel]
        rows_lp[:, pos] = eot_lp[sel]
        st.best_tokens = torch.where(improve[:, None], rows_tok, st.best_tokens)
        st.best_lps = torch.where(improve[:, None], rows_lp, st.best_lps)
        st.best_sum = torch.where(improve, eot_score.gather(1, step_lane[:, None])[:, 0],
                                  st.best_sum)
        st.best_avg = torch.where(improve, step_avg, st.best_avg)
        st.best_len = torch.where(improve, pos + 1, st.best_len)

        # Advance the live lanes: gather the small per-beam state by parent;
        # the KV cache stays, only the ancestry mask adopts the parent's path
        # and each beam's next row lands in its own slot at pos.
        parent = best_idx // (K + 1)
        tok_sel = top_tok.reshape(B, K * (K + 1)).gather(1, best_idx)
        lp_sel = noneot_lp.reshape(B, K * (K + 1)).gather(1, best_idx)
        gather_idx = (item_base[:, None] + parent).reshape(BK)
        st.tokens = st.tokens[gather_idx]
        st.tok_lps = st.tok_lps[gather_idx]
        st.sum_lp = best_scores.reshape(BK)
        st.anc = st.anc[items, parent]
        st.anc[:, :, :, pos] |= eye_k
        next_tok = tok_sel.reshape(BK)
        st.tokens[:, pos] = next_tok
        st.tok_lps[:, pos] = lp_sel.reshape(BK)

        st.last_logits, st.kv = decoder_step_beam(
            cfg, model, next_tok, pos, st.kv, xa_kv, st.anc, K,
            c_valid=read_bucket(pos, st.anc.shape[-1]))
        st.pos += 1

    return step


def _beam_result(state: _BeamState, no_speech_probs, sample_begin, K) -> DecodeResult:
    """The winner per item: the best banked hypothesis by average
    log-probability, or the best live lane for an item that banked fewer
    than K and whose live lane averages better (openai's finalize fill)."""
    BK = state.tokens.shape[0]
    B = BK // K
    item_base = torch.arange(B, device=state.tokens.device) * K
    avg_live = (state.sum_lp / float(max(state.pos - sample_begin, 1))).reshape(B, K)
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
