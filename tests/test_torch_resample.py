"""The port's resampler (``audio/resample.py``, a strided ``conv1d``)
against the JAX package's (``lax.conv_general_dilated``) on the same seeded
audio: 8, 22.05, 44.1 and 48 kHz to 16 kHz, allclose at atol 1e-5 (fp32
sums of the same taps in another order), the output length exact, and a
batch [2, N] as two clips."""

import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.audio import resample as ref_resample
from sentiric_stt_whisper_service_tpu_torch.audio import resample


@pytest.mark.parametrize("src_rate", [8000, 22050, 44100, 48000])
def test_resample_matches(src_rate):
    rng = np.random.default_rng(src_rate)
    n = int(0.75 * src_rate) + 3  # not a whole number of output samples
    t = np.arange(n) / src_rate
    x = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(ref_resample(x, src_rate, 16000))
    got = resample(x, src_rate, 16000)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_resample_batch_and_identity():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8000)).astype(np.float32)
    got = resample(torch.from_numpy(x), 8000, 16000)
    for row in range(2):
        np.testing.assert_allclose(got[row].numpy(), np.asarray(ref_resample(x[row], 8000)),
                                   atol=1e-5)
    same = resample(x, 16000, 16000)
    np.testing.assert_array_equal(same.numpy(), x)
