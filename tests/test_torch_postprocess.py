"""The port's per-segment post-processing against the JAX package's:
``is_hallucination`` and ``clean_utf8`` (``text/filters.py``) on the cases
of ``tests/test_filters_cluster.py`` and on generated strings and bytes,
and ``SpeakerClusterer`` (``diarize/cluster.py``) ids and centroids on
seeded vectors. Exact equality (the same host code); centroids to 1e-7."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sentiric_stt_whisper_service_tpu import diarize as ref_diarize
from sentiric_stt_whisper_service_tpu import text as ref_text
from sentiric_stt_whisper_service_tpu_torch import diarize, text

CASES = [
    "", "   ", "a", "ab", "...", " ?! ", "[MUSIC]", "(laughs)", "[partial text",
    "Altyazı M.K.", "Thanks for watching!", "www. ok", "visit www.example.org",
    "İzlediğiniz için teşekkürler", "ご視聴ありがとうございました", "Okay.", "Okay",
    "Okay, let's begin the meeting", "Hmm.", "ah", "Ahead of time",
    "The quick brown fox jumps over the lazy dog", "Bugün hava çok güzel",
    "Let me check the schedule for tomorrow", "TEŞEKKÜRLER", "hello dünya 日本",
]
BYTES = [b"ab\xff\xfecd", b"ok\xe6\x97", b"\x80\x80ab", "hello dünya 日本".encode()]


@pytest.mark.parametrize("case", CASES)
def test_filters_on_the_reference_cases(case):
    assert text.is_hallucination(case) == ref_text.is_hallucination(case)
    assert text.clean_utf8(case) == ref_text.clean_utf8(case)


@pytest.mark.parametrize("raw", BYTES)
def test_clean_utf8_on_bytes(raw):
    assert text.clean_utf8(raw) == ref_text.clean_utf8(raw)


@settings(max_examples=200, deadline=None)
@given(st.text(max_size=40), st.binary(max_size=40))
def test_filters_on_generated_input(s, raw):
    for phrase_sample in (s, s + " Thank you", "  " + s.upper() + "."):
        assert text.is_hallucination(phrase_sample) == ref_text.is_hallucination(phrase_sample)
        assert text.clean_utf8(phrase_sample) == ref_text.clean_utf8(phrase_sample)
    assert text.clean_utf8(raw) == ref_text.clean_utf8(raw)


@pytest.mark.parametrize("threshold", [0.5, 0.88, 0.97])
def test_speaker_clusterer_ids_and_centroids(threshold):
    rng = np.random.default_rng(5)
    centres = rng.uniform(0.0, 1.0, (4, 8))
    mine, theirs = diarize.SpeakerClusterer(threshold), ref_diarize.SpeakerClusterer(threshold)
    for i in range(60):
        vec = centres[rng.integers(4)] + rng.normal(0.0, 0.08, 8)
        if i % 17 == 0:
            vec = np.zeros(8)
        assert mine.assign_or_add(vec) == theirs.assign_or_add(vec)
    assert mine.n_clusters == theirs.n_clusters
    np.testing.assert_allclose(np.stack(mine._centroids), np.stack(theirs._centroids),
                               atol=1e-7)
    a, b = rng.standard_normal(8), rng.standard_normal(8)
    assert diarize.cosine_similarity(a, b) == ref_diarize.cosine_similarity(a, b)
    assert diarize.cosine_similarity(np.zeros(8), b) == 0.0
