"""Log-mel frontend (ops/mel, ops/fused_mel) against the JAX package's
plain version and its Pallas kernel in interpret mode, and K1's own
arithmetic (csrc/mel.cu: a 200-point Stockham FFT per frame, the real
split, a sparse mel projection) emulated in torch fp32 against the same.

Tolerance: atol 3e-4 on the scaled log-mel, as tests/test_pallas_mel.py
holds the Pallas kernel — fp32 products summed in another order, then
log10 (|d log10 x| = |dx| / (x ln 10)) and the /4 scaling. The emulated
FFT's power spectrum differs from a float64 direct sum by at most 3.4e-7 of
its frame's largest power on the test's clip (bounded at 2e-6 by
``test_k1_fft_matches_direct_dft``)."""

import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.ops import mel as ref_mel
from sentiric_stt_whisper_service_tpu.ops.pallas_mel import log_mel_spectrogram_fused
from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel, fused_mel
from sentiric_stt_whisper_service_tpu_torch.ops import mel
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 3e-4


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_reference_and_pallas(rng, n_mels):
    audio = (rng.standard_normal((2, 48000)) * 0.1).astype(np.float32)
    got = compute_log_mel(torch.from_numpy(audio), n_mels=n_mels).numpy()
    want = np.asarray(ref_mel.log_mel_spectrogram(audio, n_mels=n_mels))
    pallas = np.asarray(log_mel_spectrogram_fused(audio, n_mels=n_mels, interpret=True))
    assert got.shape == want.shape == (2, 300, n_mels)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_full_window_and_silence(rng):
    audio = (rng.standard_normal(mel.N_SAMPLES) * 0.05).astype(np.float32)
    got = mel.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    want = np.asarray(ref_mel.log_mel_spectrogram(audio))
    assert got.shape == (mel.N_FRAMES, 80)
    np.testing.assert_allclose(got, want, atol=ATOL)
    silent = mel.log_mel_spectrogram(torch.zeros(16000)).numpy()
    np.testing.assert_allclose(silent, -1.5, atol=1e-6)  # (log10(1e-10) + 4) / 4


def test_tables_and_framing_equal_reference(rng):
    for n_mels in (80, 128):
        np.testing.assert_array_equal(mel.mel_filterbank(n_mels), ref_mel.mel_filterbank(n_mels))
    for a, b in zip(mel._dft_basis(), ref_mel._dft_basis()):
        np.testing.assert_array_equal(a, b)
    audio = rng.standard_normal((3, 2000)).astype(np.float32)
    np.testing.assert_array_equal(
        mel.frame_audio(torch.from_numpy(audio)).numpy(), np.asarray(ref_mel.frame_audio(audio)))
    for n in (100, mel.N_SAMPLES + 7):
        x = rng.standard_normal((2, n)).astype(np.float32)
        np.testing.assert_array_equal(mel.pad_or_trim(x), ref_mel.pad_or_trim(x))


def _dft_matrix(n):
    r = np.arange(n)
    return torch.from_numpy(np.exp(-2j * np.pi * np.outer(r, r) / n).astype(np.complex64))


def k1_power(audio, n_mels):
    """K1's power spectrum (csrc/mel.cu) in torch fp32: frames gathered
    from the clip with the kernel's reflection, windowed, packed as z[n] =
    x[2n] + i x[2n+1], three Stockham stages of radix 5, 5 and 8 with the
    host-built fp32 twiddles (``fused_mel._tables``), then the real split
    X[k] = e + W^k o, e = (Z[k] + conj Z[200-k]) / 2, o = -i (Z[k] - conj
    Z[200-k]) / 2, for k <= 100, with |X[200-k]| = |e - W^k o| from the same
    pair."""
    tw, window = fused_mel._tables(n_mels, torch.device("cpu"))[:2]
    tw = torch.complex(tw[:, 0], tw[:, 1])
    n_samples = audio.shape[-1]
    j = (torch.arange(n_samples // 160)[:, None] * 160 + torch.arange(400)[None, :] - 200).abs()
    j = torch.where(j >= n_samples, 2 * (n_samples - 1) - j, j)
    x = audio[..., j] * window  # [..., F, 400]
    z = torch.complex(x[..., 0::2], x[..., 1::2])
    N, ns = 200, 1
    for R in (5, 5, 8):
        b = torch.arange(N // R)[:, None]  # butterflies
        r = torch.arange(R)[None, :]
        v = z[..., b + r * (N // R)] * tw[(b % ns) * r * (400 // (ns * R))]
        v = v @ _dft_matrix(R)
        out = torch.empty_like(z)
        out[..., (b // ns) * ns * R + b % ns + r * ns] = v
        z, ns = out, ns * R
    k = torch.arange(N // 2 + 1)
    a, c = z[..., k], z[..., (N - k) % N].conj()
    even, odd = (a + c) / 2, tw[k] * (-1j * (a - c) / 2)
    lo, hi = even + odd, even - odd
    power = torch.empty(*z.shape[:-1], N + 1)
    power[..., k] = lo.real ** 2 + lo.imag ** 2
    power[..., N - k] = hi.real ** 2 + hi.imag ** 2
    return power


def k1_log_mel(audio, n_mels):
    """K1's log-mel: ``k1_power``, then each band's run of bins times its
    run of weights (``fused_mel.mel_bands``), log10, the clip clamp."""
    bands, weights = fused_mel._tables(n_mels, torch.device("cpu"))[2:]
    p = k1_power(audio, n_mels)
    mels = [p[..., first:first + count] @ weights[off:off + count]
            for first, count, off in bands.tolist()]
    return mel.clamp_and_scale(torch.log10(torch.clamp(torch.stack(mels, -1), min=1e-10)))


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("clip", ["full_window", "just_over_200", "silence"])
def test_k1_arithmetic_matches_reference_and_pallas(rng, n_mels, clip):
    n = {"full_window": mel.N_SAMPLES, "just_over_200": 201, "silence": 16000}[clip]
    audio = (rng.standard_normal((1, n)) * 0.1).astype(np.float32)
    if clip == "silence":
        audio[:] = 0
    got = k1_log_mel(torch.from_numpy(audio), n_mels).numpy()
    want = np.asarray(ref_mel.log_mel_spectrogram(audio, n_mels=n_mels))
    pallas = np.asarray(log_mel_spectrogram_fused(audio, n_mels=n_mels, interpret=True))
    assert got.shape == want.shape == (1, n // 160, n_mels)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    if clip == "silence":
        np.testing.assert_allclose(got, -1.5, atol=1e-6)


def test_k1_fft_matches_direct_dft(rng):
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    got = k1_power(torch.from_numpy(audio), 80).numpy()
    frames = np.asarray(mel.frame_audio(torch.from_numpy(audio)), np.float64)[:, :-1]
    want = np.abs(np.fft.rfft(frames * mel.hann_window(400), axis=-1)) ** 2
    err = np.abs(got - want) / want.max(-1, keepdims=True)
    assert err.max() < 2e-6, err.max()


def test_mel_bands_hold_the_filterbank():
    for n_mels in (80, 128):
        bands, weights = fused_mel.mel_bands(n_mels)
        assert len(weights) <= 2 * 201  # csrc/mel.cu MAX_WEIGHTS
        dense = np.zeros((n_mels, 201), np.float32)
        for m, (first, count, off) in enumerate(bands):
            dense[m, first:first + count] = weights[off:off + count]
        np.testing.assert_array_equal(dense, mel.mel_filterbank(n_mels))
