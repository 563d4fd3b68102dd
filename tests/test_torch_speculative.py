"""Speculative decoding (``models/speculative.py``) against the JAX package's
``decode_window_spec`` and against the port's own ``decode_window`` at
t = 0, on the fp32 ``test`` config with the JAX package's weights carried
across (``from_jax_numpy``), the target and the draft each from its own
key: the draft equal to the target (most proposals accepted), an
independent draft (nearly every round corrected), the ``max_len`` clamp of
the JAX package's test, and windows whose rounds overshoot the end of the
context (where the JAX package clamps its slices). Every ``DecodeResult``
field matches: tokens and lengths exactly, log-probabilities within 1e-5.

The verify pass (``whisper.decoder_verify``, T = γ + 1 at a device
position) is held against ``decoder_apply`` of both packages (logits within
1e-5), also where its slices clamp at the context's end. The engine with a
draft gives the segments of the JAX engine with the same draft and of the
port's plain engine, and engages at ``parallel_requests=2`` while the
batcher is idle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import sampling as ref_sampling
from sentiric_stt_whisper_service_tpu.models import speculative as ref_spec
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.tokenizer import fallback_tokenizer as ref_tokenizer
from sentiric_stt_whisper_service_tpu_torch.models import sampling, speculative, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
LP_TOL = 1e-5


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    """Target (key 0) and draft (key 7) on both sides, each model's cross
    K/V of a 3 s clip, the ids, the suppression row and the prompt."""
    from sentiric_stt_whisper_service_tpu.ops import log_mel_spectrogram

    params = ref.init_params(CFG_R, jax.random.key(0))
    draft = ref.init_params(CFG_R, jax.random.key(7))
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(16000 * 3) * 0.1).astype(np.float32)
    mel = jnp.asarray(np.asarray(log_mel_spectrogram(audio, n_mels=CFG.n_mels))[None])
    xa = ref.precompute_xa_kv(CFG_R, params, ref.encoder_apply(CFG_R, params, mel))
    xa_d = ref.precompute_xa_kv(CFG_R, draft, ref.encoder_apply(CFG_R, draft, mel))
    tok = ref_tokenizer(CFG.n_vocab)
    ids_r = ref_sampling.TokenIds.from_tokenizer(tok)
    ids = sampling.TokenIds.from_tokenizer(fallback_tokenizer(CFG.n_vocab))
    sup = ref_sampling.build_suppress_mask(CFG.n_vocab, ids_r, tok.non_speech_tokens)
    sot = tok.sot_sequence("en")
    tinit = np.full((1, CFG.n_text_ctx), ids.eot, np.int32)
    tinit[0, : len(sot)] = sot

    def carry(p):
        return from_jax_numpy(jax.tree.map(np.asarray, p), CFG, "cpu")

    return dict(params=params, draft=draft, xa=xa, xa_d=xa_d, model=carry(params),
                draft_model=carry(draft), ids=ids, ids_r=ids_r, sup=sup, tinit=tinit,
                sb=len(sot))


def _torch_slab(xa):
    return {n: t(a) for n, a in xa.items()}


def _spec_both(s, draft: str, max_len, gamma, tinit=None, sb=None, prefill_len=None):
    """(the port's result, the JAX package's, the port's SpecStats)."""
    tinit = s["tinit"] if tinit is None else tinit
    sb = s["sb"] if sb is None else sb
    d_params, d_xa, d_model = ((s["params"], s["xa"], s["model"]) if draft == "same"
                               else (s["draft"], s["xa_d"], s["draft_model"]))
    want = ref_spec.decode_window_spec(
        CFG_R, s["params"], s["xa"], CFG_R, d_params, d_xa, jnp.asarray(tinit), sb, 0,
        s["ids_r"], jnp.asarray(s["sup"]), max_len=max_len, gamma=gamma,
        prefill_len=prefill_len)
    stats = speculative.SpecStats()
    got = speculative.decode_window_spec(
        CFG, s["model"], _torch_slab(s["xa"]), CFG, d_model, _torch_slab(d_xa),
        t(tinit).long(), sb, 0, s["ids"], t(s["sup"]), max_len=max_len, gamma=gamma,
        prefill_len=prefill_len, stats=stats)
    return got, want, stats


def _greedy(s, max_len, tinit=None, sb=None, prefill_len=None):
    tinit = s["tinit"] if tinit is None else tinit
    sb = s["sb"] if sb is None else sb
    return sampling.decode_window(
        CFG, s["model"], _torch_slab(s["xa"]), t(tinit).long(), sb, 0, s["ids"], t(s["sup"]),
        max_len=max_len, prefill_len=prefill_len)


def _assert_same(got, want, lp_tol=LP_TOL):
    """Every DecodeResult field: ids exact, log-probabilities within lp_tol."""
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    for name in ("token_logprobs", "sum_logprobs", "avg_logprobs", "no_speech_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=lp_tol, err_msg=name)


def _assert_greedy_equal(got, greedy, sb):
    """Token-exact with decode_window up to the length, lengths equal, and
    every other field (decode_window fills done rows with EOT too)."""
    n = int(greedy.lengths[0])
    assert int(got.lengths[0]) == n
    np.testing.assert_array_equal(got.tokens[0, :n].numpy(), greedy.tokens[0, :n].numpy())
    np.testing.assert_allclose(got.token_logprobs[0, sb:n].numpy(),
                               greedy.token_logprobs[0, sb:n].numpy(), atol=LP_TOL)
    for name in ("sum_logprobs", "avg_logprobs", "no_speech_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(greedy, name).numpy(),
                                   atol=LP_TOL, err_msg=name)


@pytest.mark.parametrize("where", ["mid", "context_end"])
def test_verify_pass_matches_decoder_apply(setup, where):
    """T = 5 tokens at a device position against decoder_apply: the port's
    (an int offset) and the JAX package's (a traced offset, whose slices
    clamp). At the context's end (cache of n_text_ctx rows, offset 446) the
    rows land clamped while the mask keeps the true offset."""
    s = setup
    T = 5
    rng = np.random.default_rng(3)
    ctx = CFG.n_text_ctx
    pos, cache_len = (40, 64) if where == "mid" else (446, ctx)
    history = rng.integers(0, 50000, size=(1, ctx)).astype(np.int32)
    toks = history[:, min(pos, ctx - T): min(pos, ctx - T) + T]
    kv_r = ref.init_kv_cache(CFG_R, 1, cache_len, paired=False, dtype=jnp.float32)
    _, kv_r, _ = ref.decoder_apply(CFG_R, s["params"], jnp.asarray(history[:, :pos]),
                                   jnp.int32(0), kv_r, s["xa"])
    want, kv_r, _ = jax.jit(ref.decoder_apply, static_argnums=0)(
        CFG_R, s["params"], jnp.asarray(toks), jnp.int32(pos), kv_r, s["xa"])
    kv = whisper.init_kv_cache(CFG, 1, cache_len)
    slab = _torch_slab(s["xa"])
    with torch.inference_mode():
        whisper.decoder_apply(CFG, s["model"], t(history[:, :pos]).long(), 0, kv, slab)
        got = whisper.decoder_verify(CFG, s["model"], t(toks).long(),
                                     torch.tensor([pos]), kv, slab)
        if where == "mid":
            kv2 = whisper.init_kv_cache(CFG, 1, cache_len)
            whisper.decoder_apply(CFG, s["model"], t(history[:, :pos]).long(), 0, kv2, slab)
            plain, _ = whisper.decoder_apply(CFG, s["model"], t(toks).long(), pos, kv2, slab)
            np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(kv_r["k"]), atol=1e-5)


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_spec_same_draft_token_exact(setup, gamma):
    """Draft == target: most proposals accepted; equal to the JAX package's
    decode_window_spec and to the port's decode_window."""
    s = setup
    max_len = s["sb"] + 20
    got, want, stats = _spec_both(s, "same", max_len, gamma)
    _assert_same(got, want)
    with torch.inference_mode():
        _assert_greedy_equal(got, _greedy(s, max_len), s["sb"])
    assert stats.emitted == int(got.lengths[0]) - s["sb"]
    # Not every draft is kept: after a round that keeps all of them the
    # draft's cache lacks its last proposal's row, as in the JAX package.
    assert 0 < stats.accepted < stats.emitted


@pytest.mark.parametrize("gamma", [2, 4])
def test_spec_bad_draft_token_exact(setup, gamma):
    """An independent draft: the correction path reproduces target greedy."""
    s = setup
    max_len = s["sb"] + 16
    got, want, stats = _spec_both(s, "other", max_len, gamma)
    _assert_same(got, want)
    with torch.inference_mode():
        _assert_greedy_equal(got, _greedy(s, max_len), s["sb"])
    assert stats.rounds > stats.emitted // (gamma + 1)  # rejections cost rounds
    assert stats.accepted < stats.emitted


@pytest.mark.parametrize("max_new", [1, 2, 5])
def test_spec_max_len_clamp(setup, max_new):
    """The round's overshoot stops at max_len exactly, as decode_window."""
    s = setup
    max_len = s["sb"] + max_new
    got, want, _ = _spec_both(s, "same", max_len, 4)
    _assert_same(got, want)
    with torch.inference_mode():
        _assert_greedy_equal(got, _greedy(s, max_len), s["sb"])


@pytest.mark.parametrize("draft", ["same", "other"])
def test_spec_context_end(setup, draft):
    """max_len = n_text_ctx after a 420-token prompt: the last rounds
    overshoot the context, where the JAX package clamps the draft's reads,
    the verify input and both passes' rows. The port gives the JAX
    package's tokens, and the window must reach the context's end."""
    s = setup
    ctx = CFG.n_text_ctx
    sb = 420
    rng = np.random.default_rng(5)
    tinit = np.full((1, ctx), s["ids"].eot, np.int32)
    tinit[0, : sb - 3] = rng.integers(300, 20000, size=sb - 3)
    tinit[0, 0] = s["ids"].sot_prev
    tinit[0, sb - 3: sb] = s["tinit"][0, :3]
    got, want, _ = _spec_both(s, draft, None, 4, tinit=tinit, sb=sb, prefill_len=sb)
    _assert_same(got, want)
    assert int(got.lengths[0]) == ctx, "the window ended before the context's end"


@pytest.fixture(scope="module")
def engines(setup):
    """(port engine with the draft, the JAX engine with the same draft, the
    port's plain engine): fp32 ``test`` target (key 0) and draft (key 7),
    gates relaxed, spec_gamma 3. The JAX engine draws its random draft from
    its own key; the test's draft replaces it, fused as the engine fuses."""
    from sentiric_stt_whisper_service_tpu.config import Settings as RefSettings
    from sentiric_stt_whisper_service_tpu.ops.quant import fuse_decoder_qkv as ref_fuse
    from sentiric_stt_whisper_service_tpu.runtime import engine as ref_engine
    from sentiric_stt_whisper_service_tpu_torch.config import Settings
    from sentiric_stt_whisper_service_tpu_torch.runtime import engine
    from test_torch_engine import RELAXED

    s = setup
    spec = dict(RELAXED, draft_model="test", spec_gamma=3)
    theirs = ref_engine.SttEngine(RefSettings(**spec), model_name="test", params=s["params"],
                                  random_init=True)
    theirs.cfg, theirs.draft_cfg, theirs.draft_params = CFG_R, CFG_R, ref_fuse(s["draft"])

    def carry(p):
        return from_jax_numpy(jax.tree.map(np.asarray, p), CFG, "cpu")

    mine = engine.SttEngine(Settings(device="cpu", **spec), model_name="test",
                            params=carry(s["params"]), draft_params=carry(s["draft"]))
    plain = engine.SttEngine(Settings(device="cpu", **RELAXED), model_name="test",
                             params=carry(s["params"]))
    mine.warmup()  # the speculative class among the rest (eager on the CPU: nothing kept)
    return mine, theirs, plain


@pytest.mark.parametrize("case", ["pinned", "prompt"])
def test_engine_with_draft_matches(engines, case):
    """Segments equal to the JAX engine's with the same draft and to the
    port's plain engine; the request's spec counts show the route ran."""
    from sentiric_stt_whisper_service_tpu_torch.runtime import engine
    from test_torch_engine import CLIP, assert_same_results, ref_options

    mine, theirs, plain = engines
    opts = engine.RequestOptions(**(dict(language="en") if case == "pinned" else
                                    dict(prompt="hello there")))
    metrics = engine.PerformanceMetrics()
    got = mine.transcribe(CLIP, 16000, opts, metrics)
    assert_same_results(got, theirs.transcribe(CLIP, 16000, ref_options(opts)))
    assert_same_results(got, plain.transcribe(CLIP, 16000, opts))
    assert metrics.spec["rounds"] > 0 and metrics.spec["emitted"] >= metrics.spec["rounds"]
    assert 0 <= metrics.spec["accepted"] < metrics.spec["emitted"]


def test_engine_spec_engages_when_batcher_idle(setup):
    """parallel_requests=2: a lone greedy request (the batcher idle) takes
    the speculative route, and its segments equal the plain engine's."""
    from sentiric_stt_whisper_service_tpu_torch.config import Settings
    from sentiric_stt_whisper_service_tpu_torch.runtime import engine
    from test_torch_engine import CLIP, RELAXED, assert_same_results

    def carry(p):
        return from_jax_numpy(jax.tree.map(np.asarray, p), CFG, "cpu")

    base = dict(RELAXED, parallel_requests=2)
    eng = engine.SttEngine(Settings(device="cpu", draft_model="test", spec_gamma=3, **base),
                           model_name="test", params=carry(setup["params"]),
                           draft_params=carry(setup["draft"]))
    plain = engine.SttEngine(Settings(device="cpu", **base), model_name="test",
                             params=carry(setup["params"]))
    calls = []
    orig = eng._encode_window_with_draft
    eng._encode_window_with_draft = lambda w, n_ctx=None: calls.append(1) or orig(w, n_ctx)
    try:
        opts = engine.RequestOptions(language="en")
        metrics = engine.PerformanceMetrics()
        got = eng.transcribe(CLIP, 16000, opts, metrics)
        assert calls, "the speculative route did not engage at parallel_requests=2"
        assert metrics.spec["rounds"] > 0
        assert_same_results(got, plain.transcribe(CLIP, 16000, opts))
    finally:
        eng.shutdown()
        plain.shutdown()
