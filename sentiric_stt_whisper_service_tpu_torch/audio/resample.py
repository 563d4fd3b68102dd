"""Sample-rate conversion to 16 kHz as one strided convolution.

The JAX package's ``audio/resample.py`` resamples with a polyphase
windowed-sinc filter expressed as a dilated, strided convolution; here the
same filter runs as ``torch.nn.functional.conv1d`` on the device of the
tensor it is given (the engine's): the input is zero-stuffed by the
upsampling factor L (``lhs_dilation`` there), padded as there, and the
window strides by the downsampling factor M. The filter is designed on the
host in float64 (Kaiser-windowed sinc, beta 5.0, cutoff at
min(fs_in, fs_out)/2, 10 taps a phase on each side: scipy's
``resample_poly`` defaults) and applied in fp32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _design_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed low-pass for a rational up/down conversion."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate  # cutoff in half-cycles/sample at the high rate
    half_len = 10 * max_rate  # scipy resample_poly default
    n = 2 * half_len + 1
    t = np.arange(n) - half_len
    # sinc low-pass * kaiser window, gain up (compensates zero-stuffing).
    h = f_c * np.sinc(f_c * t) * np.kaiser(n, 5.0)
    return (h * up).astype(np.float64)


@functools.lru_cache(maxsize=16)
def _ratio(src_rate: int, dst_rate: int) -> tuple[int, int]:
    g = math.gcd(src_rate, dst_rate)
    return dst_rate // g, src_rate // g


def resample(audio, src_rate: int, dst_rate: int = 16000, device=None) -> torch.Tensor:
    """Resample [..., N] audio (numpy or a tensor) from ``src_rate`` to
    ``dst_rate``: fp32 on ``device`` (default: the tensor's own, the CPU
    for numpy), ceil(N * L / M) samples, as scipy's ``resample_poly``."""
    x = torch.as_tensor(np.asarray(audio) if not torch.is_tensor(audio) else audio)
    x = x.to(device or x.device, torch.float32)
    if src_rate == dst_rate:
        return x
    up, down = _ratio(src_rate, dst_rate)
    lead = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1])
    n_out = -(-x.shape[-1] * up // down)
    h = torch.from_numpy(_design_filter(up, down)).to(x.device, torch.float32)
    half = (h.shape[0] - 1) // 2
    if up > 1:  # zero-stuffing: (N - 1) * L + 1 samples
        stuffed = x.new_zeros(x.shape[0], 1, (x.shape[-1] - 1) * up + 1)
        stuffed[..., ::up] = x
        x = stuffed
    x = F.pad(x, (half, half + up * down))
    y = F.conv1d(x, h[None, None], stride=down)[:, 0, :n_out]
    return y.reshape(*lead, n_out)
