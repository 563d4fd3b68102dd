"""Two threads through one engine give what the same requests give one
after the other: the engine admits both (``parallel_requests=2``) and runs
them on the device one at a time under its lock, so two requests never
replay one graph class's static buffers at once.

The ``cuda`` case runs ``tiny`` at its published widths (head dim 64, which
the kernels take), bf16, ``compute_type="int4"`` (int8 weights, the packed
int4 cross slab, an fp8 self cache), random weights from a seed, the greedy
and the beam-5 path in the two threads; it skips where
``torch.cuda.is_available()`` is false (decided in the test). This file
imports neither JAX nor the JAX package; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_engine.py

The ``cpu`` case runs the same on the ``test`` config in fp32 with a
32-token cap. Results must be equal field for field (the same kernels in
the same order decode the same inputs)."""

import threading

import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import config_for, init_params
from sentiric_stt_whisper_service_tpu_torch.runtime import RequestOptions, SttEngine
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

RELAXED = dict(enable_vad=False, parallel_requests=2, quality_gate="off",
               logprob_threshold=-1e9, no_speech_threshold=1.0, min_segment_avg_prob=0.0,
               beam_size=1, language="en")


def clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = np.sin(2 * np.pi * (140 + 40 * seed) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (0.2 * x + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def summary(results):
    return [(r.text, r.t0, r.t1, r.prob, r.speaker_id,
             [(k.text, k.p, k.t0, k.t1) for k in r.tokens]) for r in results]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_two_threads_equal_one_after_the_other(device):
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
        th.join()
    assert not errors, errors
    assert together == alone
    assert all(alone)
