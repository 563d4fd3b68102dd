"""The port's continuous batcher (``runtime/batcher.py``) against the JAX
package's on the CPU, and against the port's own one-shot ``decode_window``.

The fp32 ``test`` config, the JAX package's weights carried across with
``from_jax_numpy``, windows of seeded noise as ``tests/test_batcher.py``
makes them. Each case must give the same tokens as the JAX package's batcher
on the same requests and as a solo ``decode_window`` of the port, with token
log-probabilities within 1e-4, sums and averages within 1e-3 and the
no-speech probability within 1e-5 (fp32 sums in another order; the JAX
tests' tolerances). Covered: one window, a truncated decode, concurrent
submissions, carried prompts (one capped at 255 rows, ``cache_len - 1``),
slot recycling with a slot reused by a shorter prompt, one encode per
admission tick, a cropped audio_ctx pool, a decode past the first read
bound, the int4 and int8 pools fed encoded slabs against the JAX package's
(both int8 containers), a raw window in an int4 pool (encoded at 8 bits,
token-exact with the JAX int4 pool, its int8 cross K/V handed back) and an
int4 carrier unpacked at admission (as the solo int4 decode), a
``quantize_kv=True`` pool (the int8 pool, as the JAX package reads it),
abort mid-decode and a failing admission. ``decoder_step`` with
per-row positions is held against the JAX package's vector-``pos`` step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import sampling as ref_sampling
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.ops import log_mel_spectrogram
from sentiric_stt_whisper_service_tpu.runtime import batcher as ref_batcher
from sentiric_stt_whisper_service_tpu.tokenizer import fallback_tokenizer as ref_tokenizer
from sentiric_stt_whisper_service_tpu_torch.models import sampling, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.ops import N_SAMPLES, compute_log_mel
from sentiric_stt_whisper_service_tpu_torch.runtime.batcher import ContinuousBatcher
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
TIMEOUT = 300


class Stack:
    def __init__(self):
        self.params = ref.init_params(CFG_R, jax.random.key(0))
        self.model = from_jax_numpy(jax.tree.map(np.asarray, self.params), CFG, "cpu")
        tok_r, tok = ref_tokenizer(), fallback_tokenizer()
        self.ids_r = ref_sampling.TokenIds.from_tokenizer(tok_r)
        self.ids = sampling.TokenIds.from_tokenizer(tok)
        sup = ref_sampling.build_suppress_mask(CFG.n_vocab, self.ids_r, tok_r.non_speech_tokens)
        self.sup_r, self.sup = jnp.asarray(sup), torch.from_numpy(sup)
        self.sot = list(tok.sot_sequence("en"))

    def pool(self, **kw) -> ContinuousBatcher:
        kw.setdefault("max_slots", 3)
        return ContinuousBatcher(CFG, self.model, self.ids, self.sup, **kw)

    def ref_pool(self, **kw):
        kw.setdefault("max_slots", 3)
        return ref_batcher.ContinuousBatcher(CFG_R, self.params, self.ids_r, self.sup_r, **kw)

    def encode(self, window, n_ctx=None, bits=0) -> dict:
        w = window if n_ctx is None else window[: n_ctx * 320]
        with torch.inference_mode():
            mel = compute_log_mel(torch.from_numpy(np.ascontiguousarray(w))[None],
                                  n_mels=CFG.n_mels)
            return whisper.precompute_xa_kv(CFG, self.model,
                                             whisper.encoder_apply(CFG, self.model, mel), bits)

    def solo(self, xa_kv, init, sot_index, max_tokens) -> dict:
        """The port's one-shot decode of one window, in the batcher's
        result form (its max_len rule: the prompt plus the budget, capped
        at cache_len - 1 = 255)."""
        sb = len(init)
        tinit = torch.full((1, CFG.n_text_ctx), self.ids.eot, dtype=torch.int64)
        tinit[0, :sb] = torch.tensor(init)
        res = sampling.decode_window(CFG, self.model, xa_kv, tinit, sb, sot_index, self.ids,
                                     self.sup, max_len=min(sb + max_tokens, 255))
        seq = res.tokens[0, sb : int(res.lengths[0])].numpy()
        seq = seq[seq != self.ids.eot]
        return dict(tokens=seq, token_logprobs=res.token_logprobs[0, sb : sb + len(seq)].numpy(),
                    sum_logprob=float(res.sum_logprobs[0]), avg_logprob=float(res.avg_logprobs[0]),
                    no_speech_prob=float(res.no_speech_probs[0]))


@pytest.fixture(scope="module")
def stack():
    return Stack()


@pytest.fixture(scope="module")
def pools(stack):
    """(port pool, JAX pool), 3 slots each, shared by the cases."""
    mine, theirs = stack.pool(), stack.ref_pool()
    yield mine, theirs
    mine.shutdown()
    theirs.shutdown()


def make_window(seed):
    rng = np.random.default_rng(seed)
    w = np.zeros(N_SAMPLES, np.float32)
    w[:48000] = rng.standard_normal(48000).astype(np.float32) * 0.05
    return w


def assert_same(got: dict, want: dict, what=""):
    np.testing.assert_array_equal(np.asarray(got["tokens"]), np.asarray(want["tokens"]), what)
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"], atol=1e-4,
                               err_msg=what)
    for name, tol in (("sum_logprob", 1e-3), ("avg_logprob", 1e-3), ("no_speech_prob", 1e-5)):
        assert got[name] == pytest.approx(want[name], abs=tol), (what, name)


def both(pools, requests):
    """Submit every (window, init, sot_index, max_tokens) to both pools at
    once; the results of each."""
    mine, theirs = pools
    futs = [(mine.submit(w, i, s, max_tokens=n), theirs.submit(w, i, s, max_tokens=n))
            for w, i, s, n in requests]
    return [(a.result(timeout=TIMEOUT), b.result(timeout=TIMEOUT)) for a, b in futs]


@pytest.mark.parametrize("max_tokens", [24, 4], ids=["matches_one_shot", "truncated_logprobs"])
def test_matches_one_shot(stack, pools, max_tokens):
    """One window: the JAX batcher's tokens and logprobs, and the solo
    decode's; at 4 tokens the decode is cut at max_len (no sampled EOT), so
    the forced EOT stays out of the sum and the average's denominator."""
    window = make_window(0)
    ((got, want),) = both(pools, [(window, stack.sot, 0, max_tokens)])
    assert_same(got, want, "jax batcher")
    solo = stack.solo(stack.encode(window), stack.sot, 0, max_tokens)
    assert_same(got, solo, "solo")
    if max_tokens == 4:
        assert len(got["tokens"]) == 4
    assert set(got["xa_kv"]) == {"k", "v"} and got["xa_kv"]["k"].shape[1] == 1


def test_concurrent_submissions(stack, pools):
    """Five windows at once into three slots: each equals its JAX batcher
    result and its solo decode."""
    results = both(pools, [(make_window(i), stack.sot, 0, 16) for i in range(5)])
    for i, (got, want) in enumerate(results):
        assert_same(got, want, f"window {i}")
        assert_same(got, stack.solo(stack.encode(make_window(i)), stack.sot, 0, 16), f"solo {i}")


@pytest.mark.parametrize("n_text,max_tokens", [(4, 16), (200, 224)], ids=["short", "cap_255"])
def test_carried_prompt(stack, pools, n_text, max_tokens):
    """A carried prompt (sot_prev + text + the sot sequence) through the
    bucketed prefill; at 204 prompt tokens and a 224-token budget the
    decode stops at row 255 (cache_len - 1), the JAX batcher's rule."""
    window = make_window(3)
    init = [stack.ids.sot_prev] + [500 + i for i in range(n_text)] + stack.sot
    ((got, want),) = both(pools, [(window, init, n_text + 1, max_tokens)])
    assert_same(got, want, "jax batcher")
    assert_same(got, stack.solo(stack.encode(window), init, n_text + 1, max_tokens), "solo")
    if n_text == 200:  # cut at row 255, not by an EOT
        assert len(init) + len(got["tokens"]) == 255


def test_slot_recycling_shorter_prompt(stack, pools):
    """Seven requests through three slots, long prompts first: later ones
    land in recycled slots behind longer prompts (rows past a new prompt
    hold the old request's K/V, masked and overwritten before read)."""
    def init(n):
        return ([stack.ids.sot_prev] + [600 + i for i in range(n)] if n else []) + stack.sot

    lengths = [60, 40, 20, 0, 5, 30, 0]
    requests = [(make_window(10 + i), init(n), n + 1 if n else 0, 8)
                for i, n in enumerate(lengths)]
    for (w, i, s, n), (got, want) in zip(requests, both(pools, requests)):
        assert_same(got, want, f"prompt {len(i)}")
        assert_same(got, stack.solo(stack.encode(w), i, s, n), f"solo, prompt {len(i)}")


def test_one_encode_per_admission_tick(stack):
    """The raw windows admitted in one tick share one encode (batch 3),
    and a batch-admitted window equals its solo decode."""
    pool = stack.pool(max_slots=4)
    pool._stop.set()  # park the worker: the test runs the ticks
    pool._wake.set()
    pool._thread.join(timeout=10)
    calls, encode = [], pool._encode

    def counting(audio):
        calls.append(audio.shape[0])
        return encode(audio)

    pool._encode = counting
    futs = [pool.submit(make_window(i), stack.sot, 0, max_tokens=8) for i in range(3)]
    for _ in range(100):
        pool._worker_tick()
        if all(f.done() for f in futs):
            break
    assert calls == [3]
    for i, f in enumerate(futs):
        assert_same(f.result(timeout=1), stack.solo(stack.encode(make_window(i)), stack.sot, 0, 8))


def test_cropped_audio_ctx_pool(stack):
    """A pool of half the encoder context crops its raw windows and decodes
    over the narrow slab."""
    n_ctx = CFG.n_audio_ctx // 2
    mine, theirs = stack.pool(max_slots=2, xa_ctx=n_ctx), stack.ref_pool(max_slots=2, xa_ctx=n_ctx)
    try:
        assert mine.state.xa_kv["k"].shape[-1] == n_ctx
        ((got, want),) = both((mine, theirs), [(make_window(2), stack.sot, 0, 8)])
    finally:
        mine.shutdown()
        theirs.shutdown()
    assert_same(got, want, "jax batcher")
    assert_same(got, stack.solo(stack.encode(make_window(2), n_ctx), stack.sot, 0, 8), "solo")


def test_decode_past_64_tokens(stack, pools):
    """140 tokens: past 64 and past the first self-cache read bound (128
    rows), where the host switches the step to the whole slab."""
    window = make_window(3)
    ((got, want),) = both(pools, [(window, stack.sot, 0, 140)])
    assert len(stack.sot) + len(got["tokens"]) > 128
    assert_same(got, want, "jax batcher")
    assert_same(got, stack.solo(stack.encode(window), stack.sot, 0, 140), "solo")


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_pool(stack, bits):
    """kv_bits=4 unpacks the packed carrier into its int8 container (read by
    K3's plain version here) and equals the JAX pool, which does the same;
    an int8 pool equals the JAX int8 pool. Both from the same quantized
    cross K/V, handed over encoded."""
    slabs_r = [ref.precompute_xa_kv(CFG_R, stack.params, encoder_out(stack, make_window(20 + i)),
                                    bits) for i in range(2)]
    mine, theirs = stack.pool(max_slots=2, kv_bits=bits), stack.ref_pool(max_slots=2, kv_bits=bits)
    try:
        futs = [(mine.submit_encoded({k: torch.tensor(np.asarray(v)) for k, v in xa.items()},
                                     stack.sot, 0, max_tokens=12),
                 theirs.submit_encoded(xa, stack.sot, 0, max_tokens=12)) for xa in slabs_r]
        results = [(a.result(timeout=TIMEOUT), b.result(timeout=TIMEOUT)) for a, b in futs]
    finally:
        mine.shutdown()
        theirs.shutdown()
    assert {"k_q", "v_q"} <= set(mine.state.xa_kv)
    for xa, (got, want) in zip(slabs_r, results):
        assert_same(got, want, f"jax int{bits} pool")
        solo = stack.solo({k: torch.tensor(np.asarray(v)) for k, v in xa.items()},
                          stack.sot, 0, 12)
        assert_same(got, solo, "solo")


def test_quantize_kv_pool(stack):
    """``quantize_kv=True`` with no ``kv_bits`` builds the int8 pool, as the
    JAX package reads it (``kv_bits=8``): a raw window decodes token-exact
    with the JAX pool built the same way, and equals the port's
    ``kv_bits=8`` pool, whose container it shares."""
    window = make_window(22)
    mine, theirs = stack.pool(max_slots=2, quantize_kv=True), \
        stack.ref_pool(max_slots=2, quantize_kv=True)
    eight = stack.pool(max_slots=2, kv_bits=8)
    try:
        ((got, want),) = both((mine, theirs), [(window, stack.sot, 0, 12)])
        got8 = eight.submit(window, stack.sot, 0, max_tokens=12).result(timeout=TIMEOUT)
    finally:
        for pool in (mine, theirs, eight):
            pool.shutdown()
    assert (mine.kv_bits, mine.quantize_kv) == (8, True)
    assert (theirs.kv_bits, theirs.quantize_kv) == (8, True)
    assert {n: (t.dtype, t.shape) for n, t in mine.state.xa_kv.items()} == \
        {n: (t.dtype, t.shape) for n, t in eight.state.xa_kv.items()}
    assert mine.state.xa_kv["k_q"].dtype == torch.int8
    assert_same(got, want, "jax quantize_kv pool")
    np.testing.assert_array_equal(got["tokens"], got8["tokens"])
    np.testing.assert_array_equal(got["token_logprobs"], got8["token_logprobs"])
    for name in ("sum_logprob", "avg_logprob", "no_speech_prob"):
        assert got[name] == got8[name], name
    for name, t in got8["xa_kv"].items():
        torch.testing.assert_close(got["xa_kv"][name], t, rtol=0, atol=0)


def test_int4_pool_raw_windows(stack):
    """A kv_bits=4 pool is an int8 container, as the JAX package's: a raw
    window is encoded at 8 bits, decodes token-exact with the JAX kv_bits=4
    pool and hands back its int8 cross K/V, equal to the JAX package's
    encoding; an int4 carrier from submit_encoded is unpacked at admission
    and decodes as the solo int4 path does."""
    window = make_window(21)
    xa4 = stack.encode(window, bits=4)
    mine, theirs = stack.pool(max_slots=2, kv_bits=4), stack.ref_pool(max_slots=2, kv_bits=4)
    try:
        ((got, want),) = both((mine, theirs), [(window, stack.sot, 0, 12)])
        carried = mine.submit_encoded(xa4, stack.sot, 0, max_tokens=12).result(timeout=TIMEOUT)
    finally:
        mine.shutdown()
        theirs.shutdown()
    assert {"k_q", "v_q", "k_scale", "v_scale"} == set(mine.state.xa_kv)
    assert mine.state.xa_kv["k_q"].dtype == torch.int8
    assert mine.state.xa_kv["k_q"].shape[-1] == CFG.n_audio_ctx
    assert_same(got, want, "jax kv_bits=4 pool")
    xa8 = stack.encode(window, bits=8)
    assert set(got["xa_kv"]) == set(xa8) == set(want["xa_kv"])
    for name, t in xa8.items():
        torch.testing.assert_close(got["xa_kv"][name], t, rtol=0, atol=0)
        theirs_t = torch.tensor(np.asarray(want["xa_kv"][name]))
        if name.endswith("scale"):
            torch.testing.assert_close(got["xa_kv"][name], theirs_t, rtol=1e-5, atol=0)
        else:  # fp32 encoders agree to ~1e-6: a value may sit on a rounding edge
            diff = (got["xa_kv"][name].int() - theirs_t.int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3, name
    assert_same(got, stack.solo(xa8, stack.sot, 0, 12), "solo over int8")
    assert_same(carried, stack.solo(xa4, stack.sot, 0, 12), "solo over the int4 carrier")


def encoder_out(stack, window):
    """The JAX package's encoder output for one window."""
    mel = log_mel_spectrogram(window[None], n_mels=CFG.n_mels)
    return ref.encoder_apply(CFG_R, stack.params, mel)


def test_abort_mid_decode_frees_slot(stack):
    """A request whose should_abort fires after two polls resolves None
    mid-decode; its slot is freed for the next request while the other
    finishes whole."""
    pool = stack.pool(max_slots=2, steps_per_sync=2)
    try:
        polls = []

        def abort():
            polls.append(1)
            return len(polls) > 2

        aborted = pool.submit(make_window(5), stack.sot, 0, max_tokens=60, should_abort=abort)
        other = pool.submit(make_window(6), stack.sot, 0, max_tokens=24)
        assert aborted.result(timeout=TIMEOUT) is None
        assert len(polls) == 3
        late = pool.submit(make_window(7), stack.sot, 0, max_tokens=8)  # needs the freed slot
        got_other, got_late = other.result(timeout=TIMEOUT), late.result(timeout=TIMEOUT)
    finally:
        pool.shutdown()
    assert_same(got_other, stack.solo(stack.encode(make_window(6)), stack.sot, 0, 24))
    assert_same(got_late, stack.solo(stack.encode(make_window(7)), stack.sot, 0, 8))


def test_failing_admission_rejects_futures(stack):
    """A request whose cross K/V does not fit the pool fails its tick's
    admission: every request of that tick is rejected (none orphaned), and
    the pool serves the next request."""
    pool = stack.pool(max_slots=2)
    pool._stop.set()
    pool._wake.set()
    pool._thread.join(timeout=10)
    try:
        bad = {"k_q": torch.zeros((2, 1, 2, 32, 1500), dtype=torch.int8)}
        f_bad = pool.submit_encoded(bad, stack.sot, 0, max_tokens=4)
        f_good = pool.submit(make_window(8), stack.sot, 0, max_tokens=4)
        pool._worker_tick()
        for f in (f_bad, f_good):
            with pytest.raises(ValueError, match="does not fit"):
                f.result(timeout=1)
        assert pool.is_idle()
        again = pool.submit(make_window(8), stack.sot, 0, max_tokens=4)
        for _ in range(20):
            pool._worker_tick()
            if again.done():
                break
        assert_same(again.result(timeout=1),
                    stack.solo(stack.encode(make_window(8)), stack.sot, 0, 4))
    finally:
        pool.shutdown()


def test_refused_arguments(stack):
    """A mesh that is not the one the model is sharded on (the batcher over
    a mesh: tests/test_torch_engine_mesh.py), and an odd int4 width."""
    for kw, match in ((dict(mesh=object()), "the mesh must be the one"),
                      (dict(kv_bits=4, xa_ctx=101), "must be even")):
        with pytest.raises(ValueError, match=match):
            stack.pool(**kw)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decoder_step_per_row_positions(stack, bits):
    """decoder_step with a [S] position per row against the JAX package's
    vector-pos step (no ring row): logits and the written cache rows."""
    rng = np.random.default_rng(bits)
    S, C = 3, 64
    pos = np.array([3, 17, 40], np.int32)
    tokens = np.array([50364, 400, 51000], np.int32)
    xa_out = rng.standard_normal((S, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32)
    xa_r = ref.precompute_xa_kv(CFG_R, stack.params, jnp.asarray(xa_out), bits)
    shape = (CFG.n_text_layer, S, CFG.n_text_head, C, CFG.n_text_state // CFG.n_text_head)
    k0 = rng.standard_normal(shape).astype(np.float32) * 0.5
    v0 = rng.standard_normal(shape).astype(np.float32) * 0.5
    want, kv_r = ref.decoder_step(CFG_R, stack.params, jnp.asarray(tokens), jnp.asarray(pos),
                                  {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, xa_r)
    kv = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    with torch.inference_mode():
        got, kv = whisper.decoder_step(CFG, stack.model, torch.from_numpy(tokens).long(),
                                       torch.from_numpy(pos).long(), kv,
                                       {k: torch.tensor(np.asarray(v)) for k, v in xa_r.items()},
                                       c_valid=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(kv_r[name]), atol=1e-5)
        assert not np.array_equal(kv[name].numpy(), k0 if name == "k" else v0)
