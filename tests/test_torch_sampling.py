"""Greedy and sampled decoding (models/sampling) against the JAX package:
the logit rules on random inputs, and ``decode_window`` token for token from
the same cross K/V (the JAX package's, carried across) on the fp32 ``test``
config, for every cross slab (bf16-path fp32, int8, int4); then each mode
of the window loop against the JAX package's: abort polls and chunks,
self-cache read buckets (``cvalid_rows``), ``prefill_len`` and
``sample_cap``, sampling at temperature > 0 (teacher-forced through the JAX
package, and the sampler's frequencies), best-of selection and language
detection.

Tolerances: token ids and lengths exact; log-probabilities 1e-4 per token
and 1e-3 over a window's sum (fp32 logits that agree to ~1e-6, summed over
≤ 24 tokens); language probabilities 1e-5 (one fp32 step's softmax). The
sampler's counts against the softmax: a chi-square statistic below its
1 - 1e-6 quantile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from sentiric_stt_whisper_service_tpu.models import sampling as ref_sampling
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.tokenizer import fallback_tokenizer as ref_tokenizer
from sentiric_stt_whisper_service_tpu_torch.models import sampling, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
SELF = {"bf16": (jnp.bfloat16, torch.bfloat16), "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def ids():
    mine = sampling.TokenIds.from_tokenizer(fallback_tokenizer(CFG.n_vocab))
    theirs = ref_sampling.TokenIds.from_tokenizer(ref_tokenizer(CFG.n_vocab))
    return mine, theirs


def test_token_ids_masks_and_buckets_match(ids):
    mine, theirs = ids
    assert vars(mine) == vars(theirs)
    tok = ref_tokenizer(CFG.n_vocab)
    np.testing.assert_array_equal(
        sampling.build_suppress_mask(CFG.n_vocab, mine, tok.non_speech_tokens, extra=(5, 9)),
        ref_sampling.build_suppress_mask(CFG.n_vocab, theirs, tok.non_speech_tokens, extra=(5, 9)))
    for n in (1, 4, 5, 100, 232, 500):
        assert sampling.prompt_bucket(n) == ref_sampling.prompt_bucket(n)


@pytest.mark.parametrize("pos", [3, 4, 5, 9])
def test_timestamp_rules_match(ids, pos):
    mine, theirs = ids
    rng = np.random.default_rng(pos)
    B, ctx, tb = 4, 16, mine.timestamp_begin
    logits = rng.standard_normal((B, CFG.n_vocab)).astype(np.float32)
    logits[1, tb:] += 6.0  # row 1: timestamp mass beats the best text token
    tokens = np.full((B, ctx), mine.eot, np.int32)
    tokens[:, :3] = [mine.sot, mine.sot + 1, mine.sot + 2]
    tokens[0, 3:pos] = tb + 10  # timestamps only
    tokens[1, 3:pos] = 100  # text only
    tokens[2, 3:pos] = [tb + 5, 40, 41, tb + 9, tb + 9, 7][: pos - 3]  # a closed pair
    tokens[3, 3:pos] = [tb + 3, 40, tb + 12, 50, 51, 52][: pos - 3]  # a lone timestamp
    got = sampling.apply_timestamp_rules(t(logits), t(tokens).long(), pos, 3, mine)
    want = ref_sampling.apply_timestamp_rules(jnp.asarray(logits), jnp.asarray(tokens), pos, 3, theirs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def model_and_slabs():
    params = ref.init_params(CFG_R, jax.random.key(0))
    rng = np.random.default_rng(0)
    xa = ref.encoder_apply(CFG_R, params, jnp.asarray(
        rng.standard_normal((2, 3000, CFG.n_mels)).astype(np.float32)))
    slabs = {bits: ref.precompute_xa_kv(CFG_R, params, xa, bits) for bits in (0, 8, 4)}
    return params, from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu"), slabs


def _decode_both(params, model, xa_r, ids, self_name, **kw):
    mine, theirs = ids
    tok = ref_tokenizer(CFG.n_vocab)
    sup = ref_sampling.build_suppress_mask(CFG.n_vocab, theirs, tok.non_speech_tokens)
    sot = tok.sot_sequence("en")
    tinit = np.full((2, CFG.n_text_ctx), theirs.eot, np.int32)
    tinit[:, : len(sot)] = sot
    sd_r, sd = SELF[self_name]
    mine_abort, their_abort = kw.pop("should_abort", (None, None))
    want = ref_sampling.decode_window(
        CFG_R, params, xa_r, jnp.asarray(tinit), len(sot), 0, theirs, jnp.asarray(sup),
        jnp.float32(0.0), jax.random.key(1), self_dtype=sd_r, should_abort=their_abort, **kw)
    with torch.inference_mode():
        got = sampling.decode_window(
            CFG, model, {n: t(a) for n, a in xa_r.items()}, t(tinit), len(sot), 0, mine,
            t(sup), self_dtype=sd, should_abort=mine_abort, **kw)
    return got, want


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.token_logprobs.numpy(), np.asarray(want.token_logprobs), atol=1e-4)
    np.testing.assert_allclose(got.sum_logprobs.numpy(), np.asarray(want.sum_logprobs), atol=1e-3)
    np.testing.assert_allclose(got.avg_logprobs.numpy(), np.asarray(want.avg_logprobs), atol=1e-4)
    np.testing.assert_allclose(got.no_speech_probs.numpy(), np.asarray(want.no_speech_probs),
                               atol=1e-6)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["xa_fp", "xa_int8", "xa_int4"])
def test_decode_window_token_exact(model_and_slabs, ids, bits):
    """The fp8 self cache runs here in the no-timestamps case and, for
    every slab, in tests/test_torch_pipeline.py."""
    params, model, slabs = model_and_slabs
    got, want = _decode_both(params, model, slabs[bits], ids, "bf16", max_len=3 + 24)
    _assert_same_result(got, want)


def test_no_timestamps_rules(model_and_slabs, ids):
    params, model, slabs = model_and_slabs
    got, want = _decode_both(params, model, slabs[4], ids, "f8", max_len=3 + 12,
                             use_timestamps=False)
    _assert_same_result(got, want)
    assert int(got.lengths.max()) <= 3 + 12


def _polls(fire_after=None):
    """A ``should_abort`` that counts its polls and fires on poll
    ``fire_after`` + 1 (never, without it)."""
    polls = []

    def should_abort():
        polls.append(1)
        return fire_after is not None and len(polls) > fire_after

    return should_abort, polls


def test_abort_polls_that_never_fire_change_nothing(model_and_slabs, ids):
    """Chunks of 8 steps, polled between: the same result as no callback,
    and as the JAX package's chunked path, after the same polls."""
    params, model, slabs = model_and_slabs
    plain, _ = _decode_both(params, model, slabs[4], ids, "bf16", max_len=3 + 24)
    mine, mine_polls = _polls()
    theirs, their_polls = _polls()
    got, want = _decode_both(params, model, slabs[4], ids, "bf16", max_len=3 + 24,
                             should_abort=(mine, theirs), abort_chunk=8)
    _assert_same_result(got, want)
    for name in DecodeResultFields:
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert len(mine_polls) == len(their_polls) >= 3


@pytest.mark.parametrize("fire_after", [0, 1, 3])
def test_abort_returns_none_after_the_same_polls(model_and_slabs, ids, fire_after):
    params, model, slabs = model_and_slabs
    mine, mine_polls = _polls(fire_after)
    theirs, their_polls = _polls(fire_after)
    got, want = _decode_both(params, model, slabs[4], ids, "bf16", max_len=3 + 40,
                             should_abort=(mine, theirs), abort_chunk=8)
    assert got is None and want is None
    assert len(mine_polls) == len(their_polls) == fire_after + 1


def test_cvalid_rows_read_buckets(model_and_slabs, ids):
    """16-row read buckets over a 64-row cache (the steps cross three
    bucket boundaries), against the JAX package's lax.switch over the same."""
    params, model, slabs = model_and_slabs
    got, want = _decode_both(params, model, slabs[8], ids, "bf16", max_len=3 + 40,
                             cvalid_rows=16, use_timestamps=False)
    _assert_same_result(got, want)
    assert int(got.lengths.max()) > 3 + 16 * 2


def test_prefill_len_and_sample_cap(model_and_slabs, ids):
    """A prefill pinned wider than the prompt's bucket, and a cap on the
    sampled tokens below ``max_len``."""
    params, model, slabs = model_and_slabs
    got, want = _decode_both(params, model, slabs[0], ids, "bf16", max_len=3 + 24,
                             prefill_len=16, sample_cap=10)
    _assert_same_result(got, want)
    assert int(got.lengths.max()) <= 3 + 10


DecodeResultFields = sampling.DecodeResult._fields


def _ref_process(logits, tokens, pos, sb, sup, ids):
    """The JAX package's per-step logit processing (``_decode_loop_fns``'s
    ``process_logits``), composed from its public pieces."""
    vocab_idx = jnp.arange(logits.shape[-1])
    start_row = jnp.where((vocab_idx == ids.blank) | (vocab_idx == ids.eot),
                          ref_sampling.NEG_INF, 0.0)
    logits = logits + (sup + jnp.where(pos == sb, start_row, 0.0))[None, :]
    return ref_sampling.apply_timestamp_rules(logits, tokens, pos, sb, ids)


@pytest.mark.parametrize("pos", [3, 5])
def test_processed_logits_match(ids, pos):
    mine, theirs = ids
    rng = np.random.default_rng(pos)
    tok = ref_tokenizer(CFG.n_vocab)
    sup = ref_sampling.build_suppress_mask(CFG.n_vocab, theirs, tok.non_speech_tokens)
    logits = rng.standard_normal((3, CFG.n_vocab)).astype(np.float32)
    tokens = np.full((3, 16), mine.eot, np.int64)
    tokens[:, :5] = [mine.sot, mine.sot + 1, mine.sot + 2, mine.timestamp_begin + 4, 300]
    process = sampling.logit_processor(CFG.n_vocab, mine, t(sup), use_timestamps=True)
    got = process(t(logits), t(tokens), torch.tensor([pos]), torch.tensor([3]))
    want = _ref_process(jnp.asarray(logits), jnp.asarray(tokens, jnp.int32), pos, 3,
                        jnp.asarray(sup), theirs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_window_teacher_forced_through_jax(model_and_slabs, ids):
    """A window sampled at T = 0.8: every sampled token's log-probability
    (under the processed, unscaled logits, as the JAX package keeps it) and
    the window's sum equal the JAX package's on the same tokens, forced
    through its prefill."""
    params, model, slabs = model_and_slabs
    mine, theirs = ids
    tok = ref_tokenizer(CFG.n_vocab)
    sup = ref_sampling.build_suppress_mask(CFG.n_vocab, theirs, tok.non_speech_tokens)
    sot = tok.sot_sequence("en")
    sb = len(sot)
    tinit = torch.full((2, CFG.n_text_ctx), mine.eot, dtype=torch.int64)
    tinit[:, :sb] = torch.tensor(sot)
    xa = {n: t(a) for n, a in slabs[0].items()}
    gen = torch.Generator().manual_seed(5)
    got = sampling.decode_window(CFG, model, xa, tinit, sb, 0, mine, t(sup), temperature=0.8,
                                 generator=gen, max_len=sb + 16)
    greedy = sampling.decode_window(CFG, model, xa, tinit, sb, 0, mine, t(sup), max_len=sb + 16)
    assert not torch.equal(got.tokens, greedy.tokens)  # it did sample
    toks, lengths = got.tokens.numpy(), got.lengths.tolist()
    T = max(lengths)
    logits, _, _ = ref.decoder_apply(CFG_R, params, jnp.asarray(toks[:, :T], jnp.int32),
                                     jnp.int32(0), ref.init_kv_cache(CFG_R, 2, 32), slabs[0])
    for p in range(sb, T):
        lp = jax.nn.log_softmax(_ref_process(logits[:, p - 1], jnp.asarray(toks, jnp.int32), p,
                                             sb, jnp.asarray(sup), theirs), axis=-1)
        for b in range(2):
            if p < lengths[b]:
                want = float(lp[b, toks[b, p]])
                assert np.isfinite(want)
                assert abs(float(got.token_logprobs[b, p]) - want) <= 1e-4, (b, p)
    for b in range(2):
        want_sum = float(got.token_logprobs[b, sb:lengths[b]].sum())
        assert abs(float(got.sum_logprobs[b]) - want_sum) <= 1e-3


def test_sampler_frequencies_match_the_softmax():
    """200,000 draws over six tokens (one barred) at T = 0.7 from a seeded
    generator: the counts against softmax(logits / T), chi-square with 4
    degrees of freedom below its 1 - 1e-6 quantile (27.9 would be 1e-5)."""
    logits = torch.tensor([0.0, 1.0, -1.0, 0.5, 2.0, sampling.NEG_INF])
    n, temp = 200_000, 0.7
    draws = sampling.sample_tokens(logits.expand(n, -1), torch.tensor([temp]),
                                   torch.Generator().manual_seed(0))
    counts = torch.bincount(draws, minlength=6).double()
    assert counts[5] == 0
    expect = torch.softmax(logits.double() / temp, dim=0) * n
    chi2 = float(((counts[:5] - expect[:5]) ** 2 / expect[:5]).sum())
    assert chi2 < stats.chi2.ppf(1 - 1e-6, df=4), chi2


def test_best_of_at_temperature_zero_is_the_window(model_and_slabs, ids):
    _, model, slabs = model_and_slabs
    mine, _ = ids
    tok = fallback_tokenizer(CFG.n_vocab)
    sup = torch.from_numpy(sampling.build_suppress_mask(CFG.n_vocab, mine, tok.non_speech_tokens))
    sot = tok.sot_sequence("en")
    tinit = torch.full((2, CFG.n_text_ctx), mine.eot, dtype=torch.int64)
    tinit[:, :3] = torch.tensor(sot)
    xa = {n: t(a) for n, a in slabs[8].items()}
    one = sampling.decode_window(CFG, model, xa, tinit, 3, 0, mine, sup, max_len=3 + 12)
    best = sampling.decode_window_best_of(CFG, model, xa, tinit, 3, 0, mine, sup, 0.0,
                                          best_of=3, max_len=3 + 12)
    assert torch.equal(best.tokens, one.tokens) and torch.equal(best.lengths, one.lengths)
    for name in ("sum_logprobs", "avg_logprobs", "no_speech_probs", "token_logprobs"):
        torch.testing.assert_close(getattr(best, name), getattr(one, name), atol=1e-5, rtol=0)


def test_best_of_picks_the_jax_winner(monkeypatch):
    """The same per-sample results (ties included) through both packages'
    ``decode_window_best_of``: the same winners."""
    B, G, ctx = 3, 4, 8
    rng = np.random.default_rng(2)
    avg = np.array([[-1.0, -0.5, -0.5, -2.0], [-3.0, -3.0, -3.0, -3.0], [-0.1, -0.4, 0.0, -9.0]],
                   np.float32)
    fields = dict(tokens=rng.integers(0, 100, (B * G, ctx)), lengths=rng.integers(3, 8, B * G),
                  sum_logprobs=rng.standard_normal(B * G), avg_logprobs=avg.reshape(-1),
                  no_speech_probs=rng.random(B * G),
                  token_logprobs=rng.standard_normal((B * G, ctx)))
    fields = {k: np.asarray(v, np.int32 if k in ("tokens", "lengths") else np.float32)
              for k, v in fields.items()}
    monkeypatch.setattr(ref_sampling, "decode_window", lambda *a, **kw: ref_sampling.DecodeResult(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    monkeypatch.setattr(sampling, "decode_window", lambda *a, **kw: sampling.DecodeResult(
        **{k: torch.from_numpy(v) for k, v in fields.items()}))
    xa = {"k": np.zeros((1, B, 1, 1, 1), np.float32)}
    tinit = np.zeros((B, ctx), np.int32)
    want = ref_sampling.decode_window_best_of(
        CFG_R, None, {k: jnp.asarray(v) for k, v in xa.items()}, jnp.asarray(tinit), 3, 0, None,
        None, 0.5, None, best_of=G)
    got = sampling.decode_window_best_of(CFG, None, {k: t(v) for k, v in xa.items()}, t(tinit),
                                         3, 0, None, None, 0.5, best_of=G)
    for name in DecodeResultFields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("bits", [0, 4], ids=["xa_fp", "xa_int4"])
def test_detect_language_matches(model_and_slabs, ids, bits):
    params, model, slabs = model_and_slabs
    mine, _ = ids
    lang_begin, n_langs = mine.sot + 1, 99
    want = ref_sampling.detect_language(CFG_R, params, slabs[bits], mine.sot, lang_begin, n_langs)
    got = sampling.detect_language(CFG, model, {n: t(a) for n, a in slabs[bits].items()},
                                   mine.sot, lang_begin, n_langs)
    assert got.shape == (2, n_langs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
