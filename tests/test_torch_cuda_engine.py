"""Two threads through one engine at ``parallel_requests=2``: the greedy
request rides the continuous batcher and the beam request the beam gang
(``fused_idle_fastpath`` off, so a greedy window never takes the lone path),
and each gives what it gives when the two run one after the other: each is
alone in its pool or gang either way, so every window meets the same
admissions. Every window the batcher and the gang decoded is then replayed
through a fresh pool driven eagerly (``graph=False``) and a solo eager
``decode_window_beam`` at the gang's bucket of one, with the same
admissions, and must give the same result bit for bit.

The ``cuda`` case runs ``tiny`` at its published widths (head dim 64, which
the kernels take), bf16, ``compute_type="int4"`` (int8 weights, the packed
int4 cross slab, an fp8 self cache), random weights from a seed; the pool
and the gang replay CUDA graphs there. It skips where
``torch.cuda.is_available()`` is false (decided in the test). This file
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_engine.py

The ``cpu`` case runs the same on the ``test`` config in fp32 with a
32-token cap. Results must be equal field for field."""

import threading

import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import config_for, decode_window_beam, init_params
from sentiric_stt_whisper_service_tpu_torch.runtime import RequestOptions, SttEngine
from sentiric_stt_whisper_service_tpu_torch.runtime.batcher import ContinuousBatcher
from sentiric_stt_whisper_service_tpu_torch.runtime.gang import BeamGang
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

RELAXED = dict(enable_vad=False, parallel_requests=2, fused_idle_fastpath=False,
               quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
               min_segment_avg_prob=0.0, beam_size=1, language="en")


def clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = np.sin(2 * np.pi * (140 + 40 * seed) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.2 * x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def summary(results):
    return [(r.text, r.t0, r.t1, r.prob, r.speaker_id,
             [(k.text, k.p, k.t0, k.t1) for k in r.tokens]) for r in results]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_two_threads_equal_one_after_the_other(device, monkeypatch):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    name, dtype, cap, compute = (("tiny", torch.bfloat16, -1, "int4") if device == "cuda"
                                 else ("test", torch.float32, 32, "float32"))
    g = torch.Generator(device=device)
    g.manual_seed(0)
    model = init_params(config_for(name, dtype=dtype), g)
    eng = SttEngine(Settings(device=device, compute_type=compute, **RELAXED),
                    model_name=name, params=model)
    requests = [(clip(6.0, 1), RequestOptions(max_decode_tokens=cap)),
                (clip(4.0, 2), RequestOptions(beam_size=5, max_decode_tokens=cap,
                                              enable_diarization=True))]
    alone = [summary(eng.transcribe(a, 16000, o)) for a, o in requests]

    pooled, ganged = [], []  # (pool width, request) / (submit arguments, future)
    put, submit = ContinuousBatcher._put, BeamGang.submit

    def recording_put(pool, req):
        pooled.append((pool.xa_ctx, req))
        return put(pool, req)

    def recording_submit(gang, *args, **kw):
        fut = submit(gang, *args, **kw)
        ganged.append((args, fut))
        return fut

    monkeypatch.setattr(ContinuousBatcher, "_put", recording_put)
    monkeypatch.setattr(BeamGang, "submit", recording_submit)
    together, errors = [None, None], []

    def run(i):
        try:
            together[i] = summary(eng.transcribe(*requests[i][:1], 16000, requests[i][1]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    eng.shutdown()
    monkeypatch.undo()  # the replays below are not recorded
    assert not errors, errors
    assert together == alone
    assert all(alone)
    assert pooled and all(req.audio is not None for _, req in pooled)  # raw windows
    assert ganged

    # The same admissions through an eager pool, one window at a time.
    for width, req in pooled:
        eager = ContinuousBatcher(eng.cfg, eng.params, eng.ids, eng.suppress_mask,
                                  max_slots=max(2, eng.settings.max_batch_size), cache_len=256,
                                  kv_bits=eng.xa_bits, xa_ctx=width, self_dtype=eng.self_dtype,
                                  graph=False)
        try:
            want = eager.submit(req.audio, req.init_tokens, req.sot_index,
                                max_tokens=req.max_tokens).result(timeout=600)
        finally:
            eager.shutdown()
        got = req.future.result(timeout=1)
        for key in ("tokens", "token_logprobs"):
            np.testing.assert_array_equal(got[key], want[key], key)
        for key in ("sum_logprob", "avg_logprob", "no_speech_prob"):
            assert got[key] == want[key], key
        for key in got["xa_kv"]:
            assert torch.equal(got["xa_kv"][key], want["xa_kv"][key]), key

    # Each gang decode (one member: bucket 1) against an eager solo decode.
    for (xa_kv, tokens_row, key), fut in ganged:
        with torch.inference_mode():
            want = decode_window_beam(
                eng.cfg, eng.params, xa_kv,
                torch.from_numpy(np.asarray(tokens_row)[None]).to(eng.device),
                key.sample_begin, key.sot_index, eng.ids, eng.suppress_mask,
                beam_size=key.beam_size, max_len=key.max_len, prefill_len=key.prefill_len,
                self_dtype=eng.self_dtype, graph=False)
        got = fut.result(timeout=1)
        for field in got._fields:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
