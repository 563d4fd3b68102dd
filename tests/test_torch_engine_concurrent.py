"""The port's engine at ``parallel_requests`` > 1 (``runtime/engine.py`` with
``runtime/batcher.py`` and ``runtime/gang.py``) against the JAX package's on
the CPU: requests in concurrent threads through both engines at the same
settings give equal segments (the fields and tolerances of
``tests/test_torch_engine.py``).

The fp32 ``test`` config with the JAX package's weights carried across, the
gates relaxed so that random weights keep their segments, a 32-token cap
(a window's result is then the same whichever path decodes it: the
batcher's 255-row cap is not reached), and the JAX engine decoding from the
port's cross K/V where it encodes a window itself (beam search over random
weights meets near-ties; ``tests/test_torch_engine.py`` holds the encode).
Routing is asserted: greedy t = 0 windows reach the batcher, beam t = 0 the
gang, a lone greedy request the engine's own path; and each request's
``stages_ms`` are its own while two overlap. A stress test holds the
engine's ``DeviceLock``: no shared hold overlaps an exclusive one.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.config import Settings as RefSettings
from sentiric_stt_whisper_service_tpu.models import whisper as ref_whisper
from sentiric_stt_whisper_service_tpu.runtime import engine as ref_engine
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import whisper
from sentiric_stt_whisper_service_tpu_torch.models.graphs import DeviceLock
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.runtime import batcher as batcher_mod
from sentiric_stt_whisper_service_tpu_torch.runtime import engine
from sentiric_stt_whisper_service_tpu_torch.runtime import gang as gang_mod
from test_torch_engine import assert_same_results, ref_options, speechlike
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref_whisper.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
RELAXED = dict(enable_vad=False, beam_size=1, quality_gate="off", logprob_threshold=-1e9,
               no_speech_threshold=1.0, min_segment_avg_prob=0.0, compute_type="float32",
               language="en", request_queue_timeout_ms=600_000)
TIMEOUT = 600


@pytest.fixture(scope="module")
def params():
    return ref_whisper.init_params(CFG_R, jax.random.key(0))


def make_pair(params, **settings):
    settings = {**RELAXED, **settings}
    theirs = ref_engine.SttEngine(RefSettings(**settings), model_name="test", params=params)
    theirs.cfg = CFG_R
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    mine = engine.SttEngine(Settings(device="cpu", **settings), model_name="test", params=model)
    # The reference decodes from the port's cross K/V where it encodes itself.
    theirs._encode_window = lambda windows, n_ctx=None: {
        k: jnp.asarray(v.numpy()) for k, v in mine._encode_window(windows, n_ctx).items()}
    return mine, theirs


def in_threads(fn, args_list):
    """fn(*args) for every args in its own thread, all started together;
    the results in order (an exception is re-raised)."""
    out, errors = [None] * len(args_list), []
    start = threading.Barrier(len(args_list))

    def run(i):
        try:
            start.wait(timeout=60)
            out[i] = fn(*args_list[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args_list))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIMEOUT)
    assert not any(th.is_alive() for th in threads)
    if errors:
        raise errors[0]
    return out


class Calls:
    """Counts calls of a method on every instance of a class."""

    def __init__(self, monkeypatch, cls, name):
        self.n = 0
        orig = getattr(cls, name)

        def counting(this, *a, **kw):
            self.n += 1
            return orig(this, *a, **kw)

        monkeypatch.setattr(cls, name, counting)


# Two greedy requests of one and two windows and one beam-3 request; at 4
# a carried-prompt greedy request and a second beam request join.
REQUESTS = [
    (speechlike(2.0, seed=1), dict()),
    (np.concatenate([speechlike(2.0, seed=s) for s in range(16)]), dict()),  # 32 s
    (speechlike(3.0, seed=2), dict(beam_size=3)),
    (speechlike(2.5, seed=3), dict(prompt="hello there")),
    (speechlike(1.5, seed=4), dict(beam_size=3)),
]


@pytest.mark.parametrize("n", [2, 4])
def test_concurrent_requests_equal_reference(params, monkeypatch, n):
    pair = make_pair(params, parallel_requests=n)
    mine, theirs = pair
    gang_submits = Calls(monkeypatch, gang_mod.BeamGang, "submit")
    requests = REQUESTS[: n + 1]
    try:
        got = in_threads(lambda a, o: mine.transcribe(
            a, 16000, engine.RequestOptions(max_decode_tokens=32, **o)), requests)
        want = in_threads(lambda a, o: theirs.transcribe(
            a, 16000, ref_options(engine.RequestOptions(max_decode_tokens=32, **o))), requests)
    finally:
        mine.shutdown()
        theirs.shutdown()
    for g, w in zip(got, want):
        assert g
        assert_same_results(g, w)
    n_beam = sum(o.get("beam_size", 1) > 1 for _, o in requests)
    assert gang_submits.n >= n_beam  # every beam t = 0 window rode the gang


def test_routing(params, monkeypatch):
    """A lone greedy request decodes on the engine's own path (no pool is
    built); with fused_idle_fastpath off every greedy t = 0 window rides
    the batcher, and the results are the same."""
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    submits = Calls(monkeypatch, batcher_mod.ContinuousBatcher, "_put")
    clip = speechlike(2.0, seed=5)
    opts = engine.RequestOptions(max_decode_tokens=32)
    lone = engine.SttEngine(Settings(device="cpu", parallel_requests=2, **RELAXED),
                            model_name="test", params=model)
    alone = lone.transcribe(clip, 16000, opts)
    assert submits.n == 0 and lone._batchers == {}
    pooled = engine.SttEngine(Settings(device="cpu", parallel_requests=2,
                                       fused_idle_fastpath=False, **RELAXED),
                              model_name="test", params=model)
    try:
        batched = pooled.transcribe(clip, 16000, opts)
        assert submits.n == 1 and list(pooled._batchers) == [CFG.n_audio_ctx]
    finally:
        pooled.shutdown()
    assert_same_results(batched, alone)


def test_stages_per_request(params):
    """Two overlapping requests, one pinned to "en" and one detecting its
    language: each request's stages_ms holds its own stages only."""
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    eng = engine.SttEngine(Settings(device="cpu", parallel_requests=2,
                                    **{**RELAXED, "language": "auto"}),
                           model_name="test", params=model)
    both_inside = threading.Barrier(2)
    resolve = eng._resolve_language

    def overlapping(audio, options):
        both_inside.wait(timeout=60)  # both requests admitted before either detects
        return resolve(audio, options)

    eng._resolve_language = overlapping
    metrics = [engine.PerformanceMetrics(), engine.PerformanceMetrics()]
    try:
        in_threads(lambda lang, m: eng.transcribe(
            speechlike(2.0), 16000, engine.RequestOptions(language=lang, max_decode_tokens=16), m),
            [("en", metrics[0]), ("auto", metrics[1])])
    finally:
        eng.shutdown()
    assert "detect" not in metrics[0].stages_ms
    assert {"detect", "encode", "decode"} <= set(metrics[1].stages_ms)
    assert "decode" in metrics[0].stages_ms


def test_device_lock_stress():
    """Twelve threads take the lock shared (nested too), and every fifth
    round ask for it exclusively from inside their shared hold (as a graph
    capture inside a request's decode does): no thread holds it shared
    while another holds it exclusively, and every thread finishes."""
    lock, guard = DeviceLock(), threading.Lock()
    holders, owner, faults = set(), [None], []

    def worker(i):
        me = threading.get_ident()
        for j in range(150):
            with lock.shared():
                with guard:
                    if owner[0] not in (None, me):
                        faults.append(("shared during exclusive", i, j))
                    holders.add(me)
                with lock.shared():  # nested: no second wait
                    pass
                if (i + j) % 5 == 0:
                    with guard:
                        holders.discard(me)  # the escalation gives the shared hold up
                    with lock.exclusive():
                        with guard:
                            if holders or owner[0] is not None:
                                faults.append(("exclusive during shared", i, j))
                            owner[0] = me
                        with lock.exclusive(), lock.shared():  # nested in the exclusive hold
                            pass
                        with guard:
                            owner[0] = None
                    with guard:
                        holders.add(me)
                with guard:
                    holders.discard(me)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not faults, faults[:5]
