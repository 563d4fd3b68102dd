"""The port's VAD gate (``runtime/vad.py``) against the JAX package's on
seeded tones, noise, silence and speech-like bursts: the per-frame
probabilities (``frame_speech_probs``) allclose at 1e-6 (the same numpy),
``is_speech_detected`` equal at several thresholds and minimum durations,
an installed model honoured by both, and ``load_silero`` installing a
Silero VAD from a ggml file (``tests/test_torch_silero_vad.py`` holds it
against the JAX package's)."""

import numpy as np
import pytest

from sentiric_stt_whisper_service_tpu.runtime import vad as ref_vad
from sentiric_stt_whisper_service_tpu_torch.models.silero_vad import SileroVad, write_silero_ggml
from sentiric_stt_whisper_service_tpu_torch.runtime import vad


def clips():
    rng = np.random.default_rng(3)
    t = np.arange(16000 * 2) / 16000
    tone = (0.2 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    bursts = (tone * (np.sin(2 * np.pi * 2 * t) > 0)).astype(np.float32)
    noise = (0.3 * rng.standard_normal(t.size)).astype(np.float32)
    quiet = (1e-4 * rng.standard_normal(t.size)).astype(np.float32)
    hum = (0.2 * np.sin(2 * np.pi * 50 * t)).astype(np.float32)
    return {"tone": tone, "bursts": bursts, "noise": noise, "quiet": quiet, "hum": hum,
            "silence": np.zeros(16000, np.float32), "short": tone[:50]}


@pytest.mark.parametrize("name", list(clips()))
def test_vad_matches(name):
    x = clips()[name]
    np.testing.assert_allclose(vad.frame_speech_probs(x), ref_vad.frame_speech_probs(x),
                               atol=1e-6)
    for threshold in (0.3, 0.75):
        for min_ms in (100, 250, 500):
            assert vad.is_speech_detected(x, 16000, threshold, min_ms) == \
                ref_vad.is_speech_detected(x, 16000, threshold, min_ms)


def test_installed_model_and_silero(tmp_path):
    x = clips()["bursts"]

    def model(audio):
        return (np.abs(audio[: audio.size // 320 * 320]).reshape(-1, 320).max(axis=1) > 0.1
                ).astype(np.float32)

    try:
        vad.set_vad_model(model, frame_ms=20.0)
        ref_vad.set_vad_model(model, frame_ms=20.0)
        np.testing.assert_array_equal(vad.frame_speech_probs(x), ref_vad.frame_speech_probs(x))
        assert vad.is_speech_detected(x, 16000, 0.5, 250) == \
            ref_vad.is_speech_detected(x, 16000, 0.5, 250)
    finally:
        vad.set_vad_model(None)
        ref_vad.set_vad_model(None)
    # A real load: a random-init Silero written by the port, installed on the CPU.
    path = tmp_path / "ggml-silero-v6.2.0.bin"
    silero = SileroVad.random_init("cpu", seed=5)
    write_silero_ggml(str(path), silero.params)
    try:
        assert vad.load_silero(str(path), device="cpu")
        np.testing.assert_array_equal(vad.frame_speech_probs(x), silero(x))
        assert vad._vad_frame_ms == 32.0
    finally:
        vad.set_vad_model(None)
