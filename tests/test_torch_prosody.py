"""The port's prosody (``prosody/extractor.py``, the serving path) against
the JAX package's ``extract_prosody`` on seeded tones, noise, silence and
speech-like clips: every field of ``AffectiveTags`` (codes equal, numbers
within 1e-5; both run the same float64 numpy), under default and moved
options, and the short-clip neutral tags."""

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
