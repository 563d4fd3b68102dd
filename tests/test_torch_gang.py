"""The port's beam gang (``runtime/gang.py``) on the CPU: the cases of the
JAX package's ``tests/test_gang.py``.

The fp32 ``test`` config with the JAX package's weights carried across; each
member's cross K/V is the port's encode of seeded noise. A gang's results
must equal a solo ``decode_window_beam`` at B = 1 of each member: the same
tokens and lengths, log-probabilities within 1e-4. Gangs are formed without
timing: the members are queued before the worker collects (``drive``), or
the engine's in-flight hint decides, so no assertion rests on threads
meeting inside a wall-clock window.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import (
    TokenIds,
    build_suppress_mask,
    decode_window_beam,
    whisper,
)
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.models.sampling import DecodeResult
from sentiric_stt_whisper_service_tpu_torch.runtime import RequestOptions, SttEngine
from sentiric_stt_whisper_service_tpu_torch.runtime import gang as gang_mod
from sentiric_stt_whisper_service_tpu_torch.runtime.gang import BeamGang, GangKey
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)


@pytest.fixture(scope="module")
def stack():
    model = from_jax_numpy(jax.tree.map(np.asarray, ref.init_params(CFG_R, jax.random.key(0))),
                           CFG, "cpu")
    tok = fallback_tokenizer()
    ids = TokenIds.from_tokenizer(tok)
    sup = torch.from_numpy(build_suppress_mask(CFG.n_vocab, ids, ()))
    return model, ids, sup, list(tok.sot_sequence("en"))


def window(model, seed):
    mel = np.random.default_rng(seed).standard_normal((1, 96, CFG.n_mels)).astype(np.float32)
    with torch.inference_mode():
        return whisper.precompute_xa_kv(CFG, model,
                                        whisper.encoder_apply(CFG, model, torch.from_numpy(mel)))


def row(ids, sot):
    r = np.full((CFG.n_text_ctx,), ids.eot, np.int64)
    r[: len(sot)] = sot
    return r


def key_for(sot, xa, budget, beam=3):
    return GangKey(sample_begin=len(sot), sot_index=0, beam_size=beam, max_len=len(sot) + budget,
                   prefill_len=8, xa_f=xa["k"].shape[-1], use_timestamps=True)


def solo(stack, xa, key):
    model, ids, sup, sot = stack
    return decode_window_beam(CFG, model, xa, torch.from_numpy(row(ids, sot)[None]),
                              key.sample_begin, key.sot_index, ids, sup, beam_size=key.beam_size,
                              max_len=key.max_len, prefill_len=key.prefill_len)


def assert_same(got: DecodeResult, want: DecodeResult):
    assert got.tokens.shape[0] == 1
    for name in ("tokens", "lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy())
    for name in ("sum_logprobs", "avg_logprobs", "token_logprobs", "no_speech_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   atol=1e-4, err_msg=name)


def drive(gang: BeamGang, submissions) -> list:
    """Stop the worker, queue every submission, then run the worker's loop
    here: its first collection finds all of them queued."""
    gang._stop.set()
    gang._q.put(None)
    gang._worker.join(timeout=10)
    futs = [gang.submit(*s) for s in submissions]
    gang._q.put(None)
    gang._stop.clear()
    gang._run()
    return futs


def test_gang_matches_solo_decode(stack):
    model, ids, sup, sot = stack
    gang = BeamGang(CFG, model, ids, sup, window_ms=200, max_gang=4)
    try:
        xas = [window(model, 10 + i) for i in range(3)]
        key = key_for(sot, xas[0], 24)
        futs = drive(gang, [(xa, row(ids, sot), key) for xa in xas])
        for xa, f in zip(xas, futs):
            assert_same(f.result(timeout=1), solo(stack, xa, key))
    finally:
        gang.shutdown()


def test_gang_pads_to_batch_bucket(stack, monkeypatch):
    """Three members decode at the bucket batch of 4 (padded with copies of
    member 0); the real members' results are those of solo decodes."""
    model, ids, sup, sot = stack
    batches = []
    orig = gang_mod.decode_window_beam

    def spy(cfg, model_, xa_kv, tinit, *a, **kw):
        batches.append(int(tinit.shape[0]))
        return orig(cfg, model_, xa_kv, tinit, *a, **kw)

    monkeypatch.setattr(gang_mod, "decode_window_beam", spy)
    gang = BeamGang(CFG, model, ids, sup, window_ms=300, max_gang=8)
    try:
        xas = [window(model, 30 + i) for i in range(3)]
        key = key_for(sot, xas[0], 16)
        futs = drive(gang, [(xa, row(ids, sot), key) for xa in xas])
        assert batches == [4]
        assert_same(futs[1].result(timeout=1), solo(stack, xas[1], key))
    finally:
        gang.shutdown()
    assert [gang.batch_bucket(n) for n in (1, 2, 3, 5, 9)] == [1, 2, 4, 8, 8]


def test_gang_defers_other_keys(stack):
    """A member of another shape class waits for the next gang; both are
    served."""
    model, ids, sup, sot = stack
    gang = BeamGang(CFG, model, ids, sup, window_ms=50, max_gang=4)
    try:
        xa = window(model, 40)
        short, longer = key_for(sot, xa, 8), key_for(sot, xa, 12)
        futs = drive(gang, [(xa, row(ids, sot), short), (xa, row(ids, sot), longer)])
        assert_same(futs[0].result(timeout=1), solo(stack, xa, short))
        assert_same(futs[1].result(timeout=1), solo(stack, xa, longer))
    finally:
        gang.shutdown()


def test_gang_shutdown_rejects_queued(stack):
    model, ids, sup, sot = stack
    gang = BeamGang(CFG, model, ids, sup, window_ms=50, max_gang=4)
    gang._stop.set()  # the worker is gone: nothing queued now can be served
    gang._q.put(None)
    gang._worker.join(timeout=10)
    xa = window(model, 50)
    f1 = gang.submit(xa, row(ids, sot), key_for(sot, xa, 8))
    f2 = gang.submit(xa, row(ids, sot), key_for(sot, xa, 8))
    gang.shutdown()
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="shut down"):
            f.result(timeout=5)


def test_gang_lone_request_skips_wait(stack, monkeypatch):
    """With the in-flight hint at 1 the gang decodes at once, well inside a
    60 s window; without it a lone member waits the window out."""
    model, ids, sup, sot = stack

    def instant(cfg, model_, xa_kv, tinit, *a, **kw):
        B, ctx = tinit.shape
        z = torch.zeros((B,))
        return DecodeResult(tinit, torch.full((B,), len(sot) + 1), z, z, z, torch.zeros((B, ctx)))

    monkeypatch.setattr(gang_mod, "decode_window_beam", instant)
    xa = window(model, 60)
    key = key_for(sot, xa, 8)
    gang = BeamGang(CFG, model, ids, sup, window_ms=60_000, max_gang=4, others_hint=lambda: 1)
    try:
        assert gang.submit(xa, row(ids, sot), key).result(timeout=30) is not None
    finally:
        gang.shutdown()
    gang = BeamGang(CFG, model, ids, sup, window_ms=300, max_gang=4)
    try:
        t0 = time.monotonic()
        gang.submit(xa, row(ids, sot), key).result(timeout=30)
        assert time.monotonic() - t0 >= 0.25
    finally:
        gang.shutdown()


def test_gang_failure_rejects_all_futures(stack):
    """A poisoned gang (cross K/V of the wrong shape) rejects every
    member's future, none hangs."""
    model, ids, sup, sot = stack
    gang = BeamGang(CFG, model, ids, sup, window_ms=100, max_gang=4)
    try:
        bad = {"k": torch.zeros((1, 1, 2, 2, 2)), "v": torch.zeros((1, 1, 2, 2, 2))}
        key = GangKey(sample_begin=len(sot), sot_index=0, beam_size=3, max_len=len(sot) + 8,
                      prefill_len=8, xa_f=2, use_timestamps=True)
        futs = drive(gang, [(bad, row(ids, sot), key)] * 2)
        for f in futs:
            with pytest.raises(Exception):
                f.result(timeout=1)
    finally:
        gang.shutdown()


def test_gang_member_abort_mid_decode(stack):
    """One member aborts after its second poll (mid-decode: 80 steps in
    chunks of 32): its future resolves None, the other member's decode runs
    on to equal its solo decode."""
    model, ids, sup, sot = stack
    gang = BeamGang(CFG, model, ids, sup, window_ms=100, max_gang=2)
    try:
        xas = [window(model, 70 + i) for i in range(2)]
        key = key_for(sot, xas[0], 80)
        polls = []

        def abort():
            polls.append(1)
            return len(polls) > 2

        futs = drive(gang, [(xas[0], row(ids, sot), key, abort), (xas[1], row(ids, sot), key)])
        assert futs[0].result(timeout=1) is None and len(polls) == 3
        assert_same(futs[1].result(timeout=1), solo(stack, xas[1], key))
    finally:
        gang.shutdown()


def test_engine_beam_abort_stops_mid_decode():
    """A request whose should_abort turns true mid-window stops a beam decode
    on the gang path (the default strategy at parallel_requests > 1)."""
    s = Settings(device="cpu", enable_vad=False, beam_size=3, best_of=1, parallel_requests=2,
                 compute_type="float32", gang_window_ms=30)
    eng = SttEngine(s, model_name="test", random_init=True)
    try:
        rng = np.random.default_rng(1)
        audio = (rng.standard_normal(32000) * 3276).astype(np.int16)
        polls = []

        def abort():
            polls.append(1)
            return len(polls) > 3  # past the pre-checks, then inside the decode

        out = eng.transcribe_pcm16(audio, 16000, RequestOptions(language="en", should_abort=abort))
        assert out == [] and len(polls) > 3
        assert eng._beam_gang is not None
    finally:
        eng.shutdown()
