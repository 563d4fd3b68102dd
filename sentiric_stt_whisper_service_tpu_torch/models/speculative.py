"""Speculative decoding: a draft model proposes, the target verifies. Held
against the JAX package's ``models/speculative.py``.

A round runs ``gamma`` greedy steps of the draft (``decoder_step``: K4 on
the int4 slab, K3 on int8 or bf16), then one pass of the target over the
gamma + 1 positions from the last emitted token (``decoder_verify``: its
cross read is K6 with the positions as the beams of one item), then the
sequential accept scan: the target's processed argmax lands at every
position up to and including the first that disagrees with the draft. The
emitted tokens are the target's greedy tokens whatever the draft proposes;
a bad draft only costs rounds. Rows the rejected proposals wrote into
either self cache sit at or past the new position and are overwritten
before they are read.

Batch 1 only (the latency path), as in the JAX package.

The JAX package runs the whole window as one ``lax.while_loop``. Here the
round is one function over the loop state in tensors (the position, the
done flag, the token buffer and the log-probability sums), updated in place
with every index on the device, so that on CUDA one graph per class (gamma,
the slabs' forms) replays it (``models/graphs.py``); the host reads the
position and the done flag every ``SYNC_ROUNDS`` rounds. The eager round is
the graph's check: both give the same ``DecodeResult``. Both self caches
span the whole context, where the JAX package sizes them to ``max_len``
plus a round: the rows past a position are masked, and no slice clamps
before the context's end, so the tokens are the same and one class serves
every ``max_len``.

Near the end of the context the JAX package's dynamic slices clamp their
starts (the draft's token read, the verify input, the cache rows and
position embeddings of both passes) and its ``take_along_axis`` reads past
the buffer as the most negative int32. The round reproduces both, so that a
window whose round overshoots ``n_text_ctx`` gives the JAX package's
tokens, which there can differ from ``decode_window``'s (ROADMAP, "Known
gaps").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..parallel.replay import current as replay_channel
from .graphs import DecodeGraphs, StepLoop, graphable, to_host, window_loop
from .sampling import (
    DecodeResult,
    TokenIds,
    logit_processor,
    prompt_bucket,
    write_column,
    xa_signature,
)
from .whisper import (
    WhisperConfig,
    decoder_apply,
    decoder_step,
    decoder_verify,
    init_kv_cache,
    text_heads,
)

# Rounds between two reads of the device: a round emits 1 to gamma + 1
# tokens, and the rounds replayed after the window ends change nothing.
SYNC_ROUNDS = 4


@dataclasses.dataclass
class _SpecState:
    """The speculative loop's state, updated in place by the round."""

    tokens: torch.Tensor  # [1, ctx] int64
    kv_t: dict  # the target's self cache
    kv_d: dict  # the draft's self cache
    pos: torch.Tensor  # [1] int64: where the next token goes
    until: torch.Tensor  # [1] int64: max_len
    sample_begin: torch.Tensor  # [1] int64
    done: torch.Tensor  # [1] bool
    sum_lp: torch.Tensor  # [1] f32
    tok_lps: torch.Tensor  # [1, ctx] f32
    rounds: torch.Tensor  # [1] int64: rounds run
    accepted: torch.Tensor  # [1] int64: draft tokens the target accepted


@dataclasses.dataclass
class SpecStats:
    """What one speculative window did: its rounds, the tokens it emitted
    (each round emits the accepted drafts and one token of the target's)
    and the draft tokens the target accepted."""

    rounds: int = 0
    emitted: int = 0
    accepted: int = 0


def _round_fn(cfg, model, draft_cfg, draft, inp, ids, gamma, use_timestamps):
    """One round over a ``_SpecState`` and the loop's inputs ``inp`` (the
    two cross slabs and the suppression row); ``round_(state, bound)``
    updates the state in place. Every write of the small state is gated by
    ``active = pos < until and not done``, the JAX package's ``cond_fn``, so
    a round replayed past the window's end changes nothing the result
    reads."""
    G = gamma
    ctx = cfg.n_text_ctx
    process = logit_processor(cfg.n_vocab, ids, inp["suppress"], use_timestamps)

    def round_(st: _SpecState, _bound: int) -> None:
        pos, sb = st.pos, st.sample_begin
        active = (pos < st.until) & ~st.done

        # -- the draft: G greedy steps, their tokens written into the buffer
        for i in range(G):
            tok_in = st.tokens.index_select(1, (pos - 1 + i).clamp(0, ctx - 1))[:, 0]
            logits, _ = decoder_step(draft_cfg, draft, tok_in, (pos - 1 + i).clamp(0, ctx - 1),
                                     st.kv_d, inp["dxa"])
            d_tok = torch.argmax(process(logits, st.tokens, pos + i, sb), dim=-1)
            write_column(st.tokens, (pos + i).clamp(max=ctx - 1), d_tok, active)

        # -- the target: one pass over the G + 1 positions from pos - 1
        start = (pos - 1).clamp(0, ctx - (G + 1))
        verify_in = st.tokens.index_select(1, start + torch.arange(G + 1, device=pos.device))
        v_logits = decoder_verify(cfg, model, verify_in, pos - 1, st.kv_t, inp["xa"])

        # -- the accept scan, sequential: the rules at pos + i read the
        # prefix, this round's emissions included
        emitted = torch.zeros_like(pos)
        still, done = active.clone(), st.done.clone()
        for i in range(G + 1):
            at = (pos + i).clamp(max=ctx - 1)
            proc = process(v_logits[:, i], st.tokens, pos + i, sb)
            t_pred = torch.argmax(proc, dim=-1)
            lp = proc.gather(1, t_pred[:, None])[:, 0] - torch.logsumexp(proc, dim=-1)
            emit = still & ~done & (pos + i < st.until)
            matched = t_pred == st.tokens.index_select(1, at)[:, 0]
            write_column(st.tokens, at, t_pred, emit)
            write_column(st.tok_lps, at, lp, emit)
            st.sum_lp.copy_(torch.where(emit, st.sum_lp + lp, st.sum_lp))
            emitted += emit.to(torch.int64)
            done = done | (emit & (t_pred == ids.eot))
            if i < G:
                st.accepted.add_((emit & matched).to(torch.int64))
                still = emit & matched
        st.done.copy_(done)
        st.rounds.add_(active.to(torch.int64))
        st.pos.add_(emitted)

    return round_


def _result(st: _SpecState, no_speech_probs, sample_begin: int, eot: int) -> DecodeResult:
    """The JAX package's finish: positions at or past ``pos`` blanked to
    EOT, the length to the first EOT sampled. Copies, as the state may be a
    graph class's."""
    ctx = st.tokens.shape[1]
    positions = torch.arange(ctx, device=st.tokens.device)[None, :]
    tokens = torch.where(positions >= st.pos, eot, st.tokens)
    is_eot = (tokens == eot) & (positions >= sample_begin) & (positions < st.pos)
    first_eot = torch.where(is_eot, positions, ctx).amin(dim=1)
    lengths = torch.minimum(first_eot + 1, st.pos)
    n_sampled = torch.clamp(lengths - sample_begin, min=1)
    return DecodeResult(
        tokens=tokens,
        lengths=lengths,
        sum_logprobs=st.sum_lp.clone(),
        avg_logprobs=st.sum_lp / n_sampled.float(),
        no_speech_probs=no_speech_probs,
        token_logprobs=st.tok_lps.clone(),
    )


def run_rounds(loop: StepLoop, sample_begin: int, max_len: int) -> None:
    """The host side: replay ``SYNC_ROUNDS`` rounds (one when eager) between
    reads of the position and the done flag, until the window ends. A round
    emits at least one token, so ``max_len - sample_begin`` rounds always
    suffice. Inside an op of a mesh's replay channel
    (``parallel/replay.py``) whether the window goes on is rank 0's
    answer, which every rank takes (as ``graphs.run_window`` routes a
    window's stop); only without a channel does the read also shorten the
    last batch of rounds to the tokens left."""
    st = loop.state
    channel = replay_channel()
    left = max(0, max_len - sample_begin)

    def read() -> tuple[int, bool]:
        pos, done = to_host(torch.cat([st.pos, st.done.to(torch.int64)])).tolist()
        return pos, bool(done) or pos >= max_len

    while left > 0:
        n = min(left, SYNC_ROUNDS if loop.graphed else 1)
        for _ in range(n):
            loop.advance(0)
        left -= n
        if channel is not None:
            if channel.decide(lambda: read()[1]):
                return
            continue
        pos, over = read()
        if over:
            return
        left = min(left, max_len - pos)


@torch.inference_mode()
def decode_window_spec(
    cfg: WhisperConfig,
    model,
    xa_kv: dict,
    draft_cfg: WhisperConfig,
    draft,
    draft_xa_kv: dict,
    tokens_init: torch.Tensor,  # [1, ctx] int, prompt in [0, sample_begin)
    sample_begin: int,
    sot_index: int,
    ids: TokenIds,
    suppress_mask: torch.Tensor,  # [V] additive
    max_len: Optional[int] = None,
    gamma: int = 4,
    use_timestamps: bool = True,
    prefill_len: Optional[int] = None,
    self_dtype: Optional[torch.dtype] = None,
    graphs: Optional[DecodeGraphs] = None,
    graph: bool = True,
    stats: Optional[SpecStats] = None,
) -> DecodeResult:
    """Greedy speculative decode of one window (batch 1): the contract of
    ``decode_window`` at temperature 0, whose tokens it reproduces.
    ``gamma`` is the draft's tokens per round. On CUDA the round replays as
    a CUDA graph of its class, kept in ``graphs`` (one made for this call
    if none is given); ``graph=False`` runs it eagerly; both give the same
    result. ``stats``, when given, receives the window's rounds, emitted
    tokens and accepted drafts."""
    if tokens_init.shape[0] != 1:
        raise ValueError("decode_window_spec is the B=1 latency path")
    if draft_cfg.n_vocab != cfg.n_vocab:
        raise ValueError("draft and target must share a vocabulary")
    sample_begin, sot_index, G = int(sample_begin), int(sot_index), int(gamma)
    if G < 1:
        raise ValueError(f"gamma must be at least 1, got {gamma}")
    prefill_len = prefill_len or prompt_bucket(sample_begin)
    max_len = max_len or cfg.n_text_ctx
    ctx = tokens_init.shape[1]
    dev = tokens_init.device
    kv_dtype = self_dtype or cfg.dtype
    inputs = {"xa": xa_kv, "dxa": draft_xa_kv, "suppress": suppress_mask}
    graph = graph and graphable(model) and graphable(draft)

    def make(inp, _generator):
        def scalar(dtype):
            return torch.zeros((1,), dtype=dtype, device=dev)

        state = _SpecState(
            tokens=torch.zeros((1, ctx), dtype=torch.int64, device=dev),
            kv_t=init_kv_cache(cfg, 1, ctx, dtype=kv_dtype, device=dev,
                               n_head=text_heads(cfg, model)),
            kv_d=init_kv_cache(draft_cfg, 1, ctx, dtype=self_dtype or draft_cfg.dtype,
                               device=dev, n_head=text_heads(draft_cfg, draft)),
            pos=scalar(torch.int64), until=scalar(torch.int64),
            sample_begin=scalar(torch.int64), done=scalar(torch.bool),
            sum_lp=scalar(torch.float32),
            tok_lps=torch.zeros((1, ctx), dtype=torch.float32, device=dev),
            rounds=scalar(torch.int64), accepted=scalar(torch.int64),
        )
        return state, _round_fn(cfg, model, draft_cfg, draft, inp, ids, G, use_timestamps)

    key = ("spec", id(model), id(draft), ctx, G, kv_dtype, xa_signature(xa_kv),
           xa_signature(draft_xa_kv), ids, use_timestamps)
    loop = window_loop(dev, graph, graphs, key, make, inputs, [0], None)
    st = loop.state

    # -- the prefill of both models on the (bucketed) prompt
    st.tokens.copy_(tokens_init)
    for kv in (st.kv_t, st.kv_d):
        for t in kv.values():
            t.zero_()
    prompt = st.tokens[:, :prefill_len]
    prefill_logits, _ = decoder_apply(cfg, model, prompt, 0, st.kv_t, xa_kv)
    decoder_apply(draft_cfg, draft, prompt, 0, st.kv_d, draft_xa_kv)
    no_speech_probs = torch.softmax(prefill_logits[:, sot_index], dim=-1)[:, ids.no_speech]
    st.pos.fill_(sample_begin)
    st.until.fill_(max_len)
    st.sample_begin.fill_(sample_begin)
    for t in (st.done, st.sum_lp, st.tok_lps, st.rounds, st.accepted):
        t.zero_()

    run_rounds(loop, sample_begin, max_len)
    res = _result(st, no_speech_probs, sample_begin, ids.eot)
    if stats is not None:
        rounds, accepted, pos = to_host(torch.cat([st.rounds, st.accepted, st.pos])).tolist()
        stats.rounds, stats.accepted, stats.emitted = rounds, accepted, pos - sample_begin
    return res
