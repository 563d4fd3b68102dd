"""Fused STFT→log-mel (K1): the wrapper of ``csrc/mel.cu``.

One kernel per tile of frames takes each frame's windowed 400-point real DFT
as a 200-point complex FFT, the power, a sparse mel projection and log10;
the [F, 201] power spectrum never leaves shared memory. The whole-clip
dynamic-range clamp needs the clip's max, so it stays outside the kernel
(``ops/mel.clamp_and_scale``), as in the JAX package's
``ops/pallas_mel.py``. A CPU tensor takes the plain version
``ops/mel.log_mel_power``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .mel import HOP_LENGTH, N_FFT, hann_window, log_mel_power, mel_filterbank

MAX_MELS = 128  # csrc/mel.cu MAX_MELS


def mel_bands(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as K1 reads it: each band's nonzeros are one run of
    bins, given as (first bin, bin count, offset of its weights) [n_mels, 3]
    int32, and the runs' weights one after another [nonzeros] fp32."""
    bands = np.zeros((n_mels, 3), np.int32)
    weights = []
    for m, row in enumerate(mel_filterbank(n_mels)):
        nz = np.flatnonzero(row)
        first, count = (nz[0], nz[-1] - nz[0] + 1) if nz.size else (0, 0)
        bands[m] = first, count, len(weights)
        weights.extend(row[first:first + count])
    return bands, np.asarray(weights, np.float32)


def fft_twiddles() -> np.ndarray:
    """exp(-2 pi i m / 400) for m < 400 as [400, 2] fp32 (re, im), computed
    in float64: the FFT stages' and the real split's twiddles."""
    w = np.exp(-2j * np.pi * np.arange(N_FFT) / N_FFT)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device):
    bands, weights = mel_bands(n_mels)
    arrays = (fft_twiddles(), hann_window(N_FFT).astype(np.float32), bands, weights)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def log_mel_power_fused(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [..., n_samples] f32 → ``log10(max(mel, 1e-10))`` [..., F, n_mels]
    (before the clip clamp). CUDA: K1; CPU: ``ops/mel.log_mel_power``."""
    if audio.device.type == "cpu":
        return log_mel_power(audio, n_mels)
    kernels.check_cuda("log_mel", audio, dtypes=(torch.float32,))
    n_samples = audio.shape[-1]
    if n_samples <= N_FFT // 2:
        raise ValueError(f"log_mel: need more than {N_FFT // 2} samples for reflect padding")
    if not 0 < n_mels <= MAX_MELS:
        raise ValueError(f"log_mel: n_mels = {n_mels} outside (0, {MAX_MELS}]")
    lead = audio.shape[:-1]
    flat = audio.reshape(-1, n_samples)
    n_frames = n_samples // HOP_LENGTH
    out = torch.empty((flat.shape[0], n_frames, n_mels), dtype=torch.float32, device=audio.device)
    twiddles, window, bands, weights = _tables(n_mels, audio.device)
    kernels.call(
        "sstw_log_mel", flat.data_ptr(), twiddles.data_ptr(), window.data_ptr(),
        bands.data_ptr(), weights.data_ptr(), out.data_ptr(), flat.shape[0], n_samples,
        n_frames, n_mels, weights.numel(), kernels.stream_handle(audio.device),
    )
    kernels.LAUNCHES["log_mel"] += 1
    return out.reshape(*lead, n_frames, n_mels)
