"""The port's prosody (``prosody/extractor.py``, the serving path) against
the JAX package's ``extract_prosody`` on seeded tones, noise, silence and
speech-like clips: every field of ``AffectiveTags`` (codes equal, numbers
within 1e-5; both run the same float64 numpy), under default and moved
options, and the short-clip neutral tags. The batched ``prosody_numeric``
over padded clips of several lengths and amplitudes, row by row against the
numpy twin and the JAX package's ``prosody_numeric``."""

import dataclasses

import numpy as np
import pytest

from sentiric_stt_whisper_service_tpu.prosody import extractor as ref
from sentiric_stt_whisper_service_tpu_torch.prosody import extractor


def clip(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    t = np.arange(int(1.5 * 16000)) / 16000
    if kind == "low_tone":
        return (0.3 * np.sin(2 * np.pi * 110 * t)).astype(np.float32)
    if kind == "high_tone":
        return (0.2 * np.sin(2 * np.pi * 240 * t) * (1 + 0.3 * np.sin(2 * np.pi * 5 * t))
                ).astype(np.float32)
    if kind == "noise":
        return (0.2 * rng.standard_normal(t.size)).astype(np.float32)
    if kind == "silence":
        return np.zeros(t.size, np.float32)
    if kind == "speechlike":
        carrier = np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 450 * t)
        env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t - np.pi / 2))
        return (0.2 * carrier * env + 0.005 * rng.standard_normal(t.size)).astype(np.float32)
    return (0.1 * rng.standard_normal(100)).astype(np.float32)  # "short": < 160 samples


@pytest.mark.parametrize("kind", ["low_tone", "high_tone", "noise", "silence", "speechlike",
                                  "short"])
@pytest.mark.parametrize("moved", [False, True], ids=["default", "moved_options"])
def test_affective_tags_match(kind, moved):
    opts = dict(lpf_alpha=0.1, gender_threshold=150.0, min_pitch=70.0, max_pitch=400.0) \
        if moved else {}
    x = clip(kind)
    got = extractor.extract_prosody(x, 16000, extractor.ProsodyOptions(**opts))
    want = ref.extract_prosody(x, 16000, ref.ProsodyOptions(**opts))
    fields = [f.name for f in dataclasses.fields(extractor.AffectiveTags)]
    assert fields == [f.name for f in dataclasses.fields(ref.AffectiveTags)]
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, str):
            assert a == b, name
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                       atol=1e-5, err_msg=name)
    assert extractor.GENDER_CODES == ref.GENDER_CODES
    assert extractor.EMOTION_CODES == ref.EMOTION_CODES


FIELDS = ("pitch_mean", "pitch_std", "energy_mean", "energy_std", "spectral_centroid",
          "zero_crossing_rate", "arousal", "valence")
# Clips of several lengths (a partial last frame, one shorter than a frame)
# and amplitudes, padded into one batch: (seconds, Hz, amplitude).
BATCH = ((0.5, 120.0, 0.1), (1.3, 220.0, 0.2), (2.0, 90.0, 0.05), (0.8, 300.0, 0.01),
         (1.7, 170.0, 0.15), (0.006, 200.0, 0.3), (1.05, 140.0, 0.4))


def batch_clips():
    rng = np.random.default_rng(11)
    out = []
    for dur, freq, amp in BATCH:
        t = np.arange(int(dur * 16000)) / 16000
        env = 0.6 + 0.4 * np.sin(2 * np.pi * 2.5 * t)
        out.append((amp * np.sin(2 * np.pi * freq * t) * env
                    + 0.01 * rng.standard_normal(len(t))).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def batched():
    import torch

    clips = batch_clips()
    n_pad = -(-max(len(c) for c in clips) // 160) * 160 + 320  # whole frames past every clip
    pad = np.zeros((len(clips), n_pad), np.float32)
    for i, c in enumerate(clips):
        pad[i, : len(c)] = c
    got = extractor.prosody_numeric(torch.from_numpy(pad), torch.tensor([len(c) for c in clips]))
    return clips, pad, got


@pytest.mark.parametrize("i", range(len(BATCH)))
def test_batched_prosody_matches_numpy_twin(batched, i):
    """Each row of the batched function against the serving path on the clip
    alone: float64 both, within 1e-9 (the twin's speaker vector is float32:
    1e-6). A clip under one frame gets the neutral (zero) numbers."""
    clips, _, got = batched
    x = clips[i]
    if len(x) < 160:
        for name in FIELDS + ("speech_rate",):
            assert float(getattr(got, name)[i]) == 0.0, name
        assert int(got.gender_code[i]) == int(got.emotion_code[i]) == 0
        assert not got.speaker_vec[i].any()
        return
    want = extractor._prosody_numeric_np(x, 16000, extractor.ProsodyOptions())
    for j, name in enumerate(FIELDS):
        np.testing.assert_allclose(float(getattr(got, name)[i]), want[j], rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    assert int(got.gender_code[i]) == want[8] and int(got.emotion_code[i]) == want[9]
    np.testing.assert_allclose(got.speaker_vec[i].numpy(), want[10], atol=1e-6)
    np.testing.assert_allclose(float(got.speech_rate[i]), want[11], rtol=1e-12)


@pytest.mark.parametrize("i", range(len(BATCH)))
def test_batched_prosody_matches_jax_prosody_numeric(batched, i):
    """Each row against the JAX package's ``prosody_numeric`` on the padded
    row and its length (float32 there): the JAX package's own oracle
    tolerance (rtol 2e-3, atol 2e-4), codes equal."""
    import jax.numpy as jnp

    _, pad, got = batched
    n = len(batch_clips()[i])
    want = ref.prosody_numeric(jnp.asarray(pad[i]), jnp.int32(n), 16000, ref.ProsodyOptions())
    for name in FIELDS + ("speech_rate",):
        np.testing.assert_allclose(float(getattr(got, name)[i]), float(getattr(want, name)),
                                   rtol=2e-3, atol=2e-4, err_msg=name)
    assert int(got.gender_code[i]) == int(want.gender_code)
    assert int(got.emotion_code[i]) == int(want.emotion_code)
    np.testing.assert_allclose(got.speaker_vec[i].numpy(), np.asarray(want.speaker_vec),
                               rtol=2e-3, atol=2e-4)
