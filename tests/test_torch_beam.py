"""Beam-search decoding (models/beam, models/whisper.decoder_step_beam)
against the JAX package on the fp32 ``test`` config, with the JAX package's
weights carried across by ``models/params.from_jax_numpy``:

  * the step's logits under random forced parents and tokens (the pattern of
    tests/test_beam.py), for each cross slab, the port reading its self cache
    through a 128-row bucket where the JAX package reads all of it;
  * ``topk_small``'s values and tie order;
  * the chain ``compute_log_mel → encode_xa_kv(_q) → decode_window_beam`` at
    K = 5, B = 2, token for token, for each cross slab and self-cache storage,
    and once with EOT favoured so that hypotheses are banked and the search
    stops early;
  * ``early_stop`` changing nothing, and beam 1 equal to greedy;
  * the window loop's modes against the JAX package's: abort polls and
    chunks, ``cache_buckets=False``, a carried prompt whose decode crosses
    the 128-row read bucket, ``prefill_len``, and beam 9 (two groups of
    query beams in the card's kernels).

Tolerances: logits 1e-4 (fp32, the same products summed in another order,
as tests/test_torch_whisper.py); tokens and lengths exact; no-speech
probabilities 1e-6 and summed or averaged log-probabilities 1e-3, as
tests/test_torch_pipeline.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import beam as ref_beam
from sentiric_stt_whisper_service_tpu.models import sampling as ref_sampling
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.ops import compute_log_mel as ref_log_mel
from sentiric_stt_whisper_service_tpu.ops import quant as ref_quant
from sentiric_stt_whisper_service_tpu.tokenizer import fallback_tokenizer as ref_tokenizer
from sentiric_stt_whisper_service_tpu_torch.models import (
    DecodeResult,
    TokenIds,
    build_suppress_mask,
    decode_window,
    decode_window_beam,
    encode_xa_kv,
    encode_xa_kv_q,
    topk_small,
)
from sentiric_stt_whisper_service_tpu_torch.models import beam, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.ops import N_SAMPLES, compute_log_mel
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
SELF = {"bf16": (jnp.bfloat16, torch.bfloat16), "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
K = 5
BUDGET = 32
# Added to EOT's logit so that beams finish: at 0.75 hypotheses are banked and
# the search runs its budget; at 1.0 every item banks K within a few steps.
BANKED, EARLY = 0.75, 1.0


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def weights_and_audio():
    rng = np.random.default_rng(11)
    audio = (rng.standard_normal((2, N_SAMPLES)) * 0.1).astype(np.float32)
    audio[0, 6 * 16000:] = 0.0  # a 6 s request padded to the window
    return ref.init_params(CFG_R, jax.random.key(0)), audio


def _params(params, bits):
    return ref_quant.fuse_decoder_qkv(ref_quant.quantize_params(params)) if bits else params


def _prompt(tok, carried=0):
    """The prompt: ``carried`` earlier tokens after sot_prev, if any, then
    the sot sequence. Returns (tokens, sot_index)."""
    sot = list(tok.sot_sequence("en"))
    if not carried:
        return sot, 0
    rng = np.random.default_rng(carried)
    return [tok.special.sot_prev] + list(rng.integers(300, 5000, carried)) + sot, carried + 1


def _reference(params, audio, bits, self_dtype, eot_bias=0.0, beam_size=K, carried=0,
               budget=BUDGET, **kw):
    tok = ref_tokenizer(CFG_R.n_vocab)
    ids = ref_sampling.TokenIds.from_tokenizer(tok)
    sup = ref_sampling.build_suppress_mask(CFG_R.n_vocab, ids, tok.non_speech_tokens)
    sup[ids.eot] += eot_bias
    sot, sot_index = _prompt(tok, carried)
    tinit = np.full((2, CFG_R.n_text_ctx), ids.eot, np.int32)
    tinit[:, : len(sot)] = sot
    params = _params(params, bits)
    mel = ref_log_mel(jnp.asarray(audio), n_mels=CFG_R.n_mels, dtype=CFG_R.dtype)
    xa_kv = (ref.encode_xa_kv_q(CFG_R, params, mel, bits) if bits
             else ref.encode_xa_kv(CFG_R, params, mel))
    return ref_beam.decode_window_beam(
        CFG_R, params, xa_kv, jnp.asarray(tinit), len(sot), sot_index, ids, jnp.asarray(sup),
        beam_size=beam_size, max_len=len(sot) + budget, self_dtype=self_dtype, **kw)


def _port_inputs(params, audio, bits, eot_bias=0.0, carried=0):
    model = from_jax_numpy(jax.tree.map(np.asarray, _params(params, bits)), CFG, "cpu")
    tok = fallback_tokenizer(CFG.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sup = build_suppress_mask(CFG.n_vocab, ids, tok.non_speech_tokens)
    sup[ids.eot] += eot_bias
    sot, sot_index = _prompt(tok, carried)
    tinit = torch.full((2, CFG.n_text_ctx), ids.eot, dtype=torch.int64)
    tinit[:, : len(sot)] = torch.tensor(sot)
    with torch.inference_mode():
        mel = compute_log_mel(torch.from_numpy(audio), n_mels=CFG.n_mels, dtype=CFG.dtype)
        xa_kv = encode_xa_kv_q(CFG, model, mel, bits) if bits else encode_xa_kv(CFG, model, mel)
    return model, xa_kv, tinit, len(sot), ids, torch.from_numpy(sup), sot_index


def _port(inputs, self_dtype, beam_size=K, budget=BUDGET, **kw):
    model, xa_kv, tinit, sb, ids, sup, sot_index = inputs
    with torch.inference_mode():
        return decode_window_beam(CFG, model, xa_kv, tinit, sb, sot_index, ids, sup,
                                  beam_size=beam_size, max_len=sb + budget,
                                  self_dtype=self_dtype, **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.no_speech_probs.numpy(), np.asarray(want.no_speech_probs),
                               atol=1e-6)
    np.testing.assert_allclose(got.sum_logprobs.numpy(), np.asarray(want.sum_logprobs),
                               atol=1e-3)
    np.testing.assert_allclose(got.avg_logprobs.numpy(), np.asarray(want.avg_logprobs),
                               atol=1e-3)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["xa_fp", "xa_int8", "xa_int4"])
def test_decoder_step_beam_matches_jax(weights_and_audio, bits):
    params, audio = weights_and_audio
    params = _params(params, bits)
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    mel = ref_log_mel(jnp.asarray(audio), n_mels=CFG_R.n_mels, dtype=CFG_R.dtype)
    xa_r = (ref.encode_xa_kv_q(CFG_R, params, mel, bits) if bits
            else ref.encode_xa_kv(CFG_R, params, mel))
    xa = {name: t(x) for name, x in xa_r.items()}
    B, C = 2, 160  # the port reads the first 128 rows (its bucket), the JAX package all 160
    prefix = np.array([[50258, 50259, 50359]] * B, np.int32)
    P = prefix.shape[1]
    _, kv_b, _ = ref.decoder_apply(CFG_R, params, jnp.asarray(prefix), jnp.int32(0),
                                   ref.init_kv_cache(CFG_R, B, C), xa_r)
    kv_r = {name: jnp.zeros((x.shape[0], B, K) + x.shape[2:], x.dtype).at[:, :, 0].set(x)
            .reshape((x.shape[0], B * K) + x.shape[2:]) for name, x in kv_b.items()}
    kv = {name: t(x).clone() for name, x in kv_r.items()}
    anc = np.zeros((B, K, K, C), bool)
    anc[:, :, 0, :P] = True
    step_r = jax.jit(ref.decoder_step_beam, static_argnums=(0, 7))
    rng = np.random.default_rng(7 + bits)
    for pos in range(P, P + 4):
        parent = rng.integers(0, K, size=(B, K))
        toks = rng.integers(100, 40000, size=(B * K,)).astype(np.int32)
        anc = anc[np.arange(B)[:, None], parent]
        anc[:, :, :, pos] = np.eye(K, dtype=bool)[None]
        want, kv_r = step_r(CFG_R, params, jnp.asarray(toks), jnp.int32(pos), kv_r, xa_r,
                            jnp.asarray(anc), K)
        with torch.inference_mode():
            got, kv = whisper.decoder_step_beam(
                CFG, model, t(toks).long(), pos, kv, xa, torch.from_numpy(anc), K,
                c_valid=beam.read_bucket(pos, C))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_topk_small_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    logits = rng.integers(-3, 3, size=(6, 300)).astype(np.float32)  # ties everywhere
    logits[1, ::2] = -np.inf
    logits[2, 5:] = -1e30
    vals, idx = topk_small(torch.from_numpy(logits), K + 1)
    want_vals, want_idx = ref_beam.topk_small(jnp.asarray(logits), K + 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    _, lax_idx = jax.lax.top_k(jnp.asarray(logits[[0, 1, 3, 4, 5]]), K + 1)
    np.testing.assert_array_equal(idx.numpy()[[0, 1, 3, 4, 5]], np.asarray(lax_idx))


@pytest.mark.parametrize("self_name", ["bf16", "f8"])
@pytest.mark.parametrize("bits", [0, 8, 4], ids=["xa_fp", "xa_int8", "xa_int4"])
def test_chain_token_exact(weights_and_audio, bits, self_name):
    params, audio = weights_and_audio
    sd_r, sd = SELF[self_name]
    want = _reference(params, audio, bits, sd_r)
    got = _port(_port_inputs(params, audio, bits), sd)
    _assert_same(got, want)


@pytest.fixture(scope="module")
def eot_inputs(weights_and_audio):
    params, audio = weights_and_audio
    return {bias: _port_inputs(params, audio, 4, bias) for bias in (BANKED, EARLY)}


@pytest.mark.parametrize("bias", [BANKED, EARLY], ids=["banked", "early_stop"])
def test_chain_token_exact_with_banked_hypotheses(weights_and_audio, eot_inputs, bias):
    params, audio = weights_and_audio
    want = _reference(params, audio, 4, jnp.bfloat16, bias)
    got = _port(eot_inputs[bias], torch.bfloat16)
    _assert_same(got, want)
    assert (got.lengths < eot_inputs[bias][3] + BUDGET).all()  # the winners finished


def test_early_stop_changes_nothing(eot_inputs, monkeypatch):
    steps = []
    step = beam.decoder_step_beam
    monkeypatch.setattr(beam, "decoder_step_beam", lambda *a, **kw: steps.append(1) or step(*a, **kw))
    early = _port(eot_inputs[EARLY], torch.bfloat16)
    n_early = len(steps)
    full = _port(eot_inputs[EARLY], torch.bfloat16, early_stop=False)
    assert n_early < len(steps) - n_early == BUDGET  # it did stop early
    for name in ("tokens", "lengths", "sum_logprobs", "avg_logprobs", "no_speech_probs",
                 "token_logprobs"):
        assert torch.equal(getattr(early, name), getattr(full, name)), name


def test_beam_of_one_is_greedy(eot_inputs):
    model, xa_kv, tinit, sb, ids, sup, _ = eot_inputs[BANKED]
    got = _port(eot_inputs[BANKED], None, beam_size=1)
    with torch.inference_mode():
        want = decode_window(CFG, model, xa_kv, tinit, sb, 0, ids, sup, max_len=sb + BUDGET)
    assert torch.equal(got.lengths, want.lengths)
    for b, n in enumerate(want.lengths.tolist()):
        assert torch.equal(got.tokens[b, :n], want.tokens[b, :n])
    torch.testing.assert_close(got.no_speech_probs, want.no_speech_probs)


def _polls(fire_after=None):
    """A ``should_abort`` that counts its polls and fires on poll
    ``fire_after`` + 1 (never, without it)."""
    polls = []

    def should_abort():
        polls.append(1)
        return fire_after is not None and len(polls) > fire_after

    return should_abort, polls


@pytest.mark.parametrize("fire_after", [None, 2], ids=["never", "after_2"])
def test_abort_polls_match_jax(weights_and_audio, eot_inputs, fire_after):
    """Chunks of 8 steps polled between, as the JAX package's chunked path:
    a callback that never fires changes nothing; one that fires returns
    None after the same polls."""
    params, audio = weights_and_audio
    mine, mine_polls = _polls(fire_after)
    theirs, their_polls = _polls(fire_after)
    want = _reference(params, audio, 4, jnp.bfloat16, BANKED, should_abort=theirs,
                      abort_chunk=8)
    got = _port(eot_inputs[BANKED], torch.bfloat16, should_abort=mine, abort_chunk=8)
    assert len(mine_polls) == len(their_polls) >= 3
    if fire_after is None:
        _assert_same(got, want)
        plain = _port(eot_inputs[BANKED], torch.bfloat16)
        for name in DecodeResult._fields:
            assert torch.equal(getattr(got, name), getattr(plain, name)), name
    else:
        assert got is None and want is None


def test_whole_slab_reads_and_prefill_len(weights_and_audio, eot_inputs):
    """``cache_buckets=False`` and a prefill pinned wider than the prompt's
    bucket, each as the JAX package decodes them."""
    params, audio = weights_and_audio
    want = _reference(params, audio, 4, jnp.bfloat16, BANKED, cache_buckets=False,
                      prefill_len=16)
    got = _port(eot_inputs[BANKED], torch.bfloat16, cache_buckets=False, prefill_len=16)
    _assert_same(got, want)


def test_carried_prompt_crosses_the_read_bucket(weights_and_audio):
    """A 126-token prompt (sot_prev, 122 carried tokens, the sot sequence)
    prefilled at its 128 bucket: the decode crosses from the 128-row read
    bucket to the whole 160-row slab at position 128."""
    params, audio = weights_and_audio
    want = _reference(params, audio, 8, jnp.bfloat16, carried=122, budget=12)
    got = _port(_port_inputs(params, audio, 8, carried=122), torch.bfloat16, budget=12)
    _assert_same(got, want)
    assert int(got.lengths.min()) > 128


def test_beam_9_token_exact(weights_and_audio):
    """Nine beams (on the card, K5 and K6 serve them in two groups; here
    their plain versions), token for token with the JAX package."""
    params, audio = weights_and_audio
    want = _reference(params, audio, 4, jnp.bfloat16, BANKED, beam_size=9, budget=16)
    got = _port(_port_inputs(params, audio, 4, BANKED), torch.bfloat16, beam_size=9, budget=16)
    _assert_same(got, want)
