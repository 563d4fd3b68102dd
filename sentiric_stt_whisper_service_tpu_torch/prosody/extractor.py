"""Affective prosody extraction: the serving path of the JAX package's
``prosody/extractor.py``.

The JAX package keeps two forms of the reference service's DSP
(its prosody_extractor.cpp): a jitted ``prosody_numeric`` over one padded
clip that only its tests reach, and the numpy twin ``_prosody_numeric_np``
that ``extract_prosody`` serves with. The port has both: the numpy twin
(the serving path, on the host where the reference runs it), and
``prosody_numeric``, one batched torch function over padded clips and
their lengths (float64, on the clips' device), sharing the heuristics
``_heuristics`` (octave-error halving, gender rules, relative emotion, the
8-D speaker vector), the options, tags and code tables.

Semantics (prosody_extractor.cpp): 10 ms frames, trailing partial frame
dropped; per-frame RMS, onset peaks at 0.05, standard ZCR; a one-pole
low-pass ``y += alpha*(x-y)`` carried across frames; hysteresis cycle
counting with threshold ``max(0.002, rms*0.15)``, F0 accepted when
``rms>0.015`` and within [min_pitch, max_pitch]; a first-difference
spectral-centroid proxy; the lower-median pitch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProsodyOptions:
    """Tunables (reference prosody_extractor.h:21-27)."""

    lpf_alpha: float = 0.07
    gender_threshold: float = 170.0
    min_pitch: float = 60.0
    max_pitch: float = 500.0


GENDER_CODES = ("?", "M", "F")
EMOTION_CODES = ("neutral", "excited", "angry", "sad")


@dataclasses.dataclass
class AffectiveTags:
    gender_proxy: str = "?"
    emotion_proxy: str = "neutral"
    pitch_mean: float = 0.0
    pitch_std: float = 0.0
    energy_mean: float = 0.0
    energy_std: float = 0.0
    spectral_centroid: float = 0.0
    zero_crossing_rate: float = 0.0
    arousal: float = 0.0
    valence: float = 0.0
    speaker_vec: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(8, np.float32)
    )
    speech_rate: float = 0.0


class ProsodyNumeric(NamedTuple):
    """``prosody_numeric``'s result, one entry per clip (the strings as
    codes into ``GENDER_CODES`` / ``EMOTION_CODES``)."""

    pitch_mean: torch.Tensor  # [B] f64
    pitch_std: torch.Tensor
    energy_mean: torch.Tensor
    energy_std: torch.Tensor
    spectral_centroid: torch.Tensor
    zero_crossing_rate: torch.Tensor
    arousal: torch.Tensor
    valence: torch.Tensor
    gender_code: torch.Tensor  # [B] int64
    emotion_code: torch.Tensor  # [B] int64
    speaker_vec: torch.Tensor  # [B, 8] f64
    speech_rate: torch.Tensor


def _soft_norm(val, lo, hi, xp=np):
    return xp.clip((val - lo) / (hi - lo), 0.0, 1.0)


def _heuristics(xp, pitch_mean, pitch_std, energy_mean, sc_mean, zcr_mean,
                speech_rate, opts: ProsodyOptions):
    """THE single source of truth for the reference's affective
    heuristics (prosody_extractor.cpp:140-221): octave-error halving,
    gender rules, relative emotion, and the 8-D gender-polarized speaker
    vector — written branchless over a backend module ``xp`` (numpy
    here, as in the JAX package's serving twin).

    Returns (pitch_mean, gender_code, arousal, valence, emotion_code,
    speaker_vec[8])."""
    # Backend-array inputs: comparisons then yield xp bools with xp's
    # ~/&/| semantics (a Python-bool `~` is integer complement — wrong).
    pitch_mean, pitch_std, energy_mean, sc_mean, zcr_mean, speech_rate = (
        xp.asarray(v) for v in
        (pitch_mean, pitch_std, energy_mean, sc_mean, zcr_mean, speech_rate)
    )
    # --- octave-error heuristics (:140-148) ---
    halve1 = (pitch_mean > opts.gender_threshold) & (zcr_mean < 0.024)
    halve2 = (
        (~halve1)
        & (energy_mean > 0.12)
        & (pitch_mean < 240.0)
        & (sc_mean < 90.0)
    )
    pitch_mean = xp.where(halve1 | halve2, pitch_mean * 0.5, pitch_mean)

    # --- gender (:155-163): 0 '?', 1 'M', 2 'F' ---
    unknown = (pitch_mean == 0.0) | (energy_mean < 0.018)
    male_zcr = zcr_mean < 0.030
    female = pitch_mean > opts.gender_threshold
    gender = xp.where(
        unknown, 0, xp.where(male_zcr, 1, xp.where(female, 2, 1))
    )

    # --- relative emotion (:166-186) ---
    norm_pitch = xp.where(
        gender == 1,
        _soft_norm(pitch_mean, 60.0, 180.0, xp),
        _soft_norm(pitch_mean, 160.0, 350.0, xp),
    )
    norm_bright = _soft_norm(sc_mean, 40.0, 150.0, xp)
    valence = (norm_pitch * 0.4 + norm_bright * 0.6) * 2.0 - 1.0 + 0.35
    norm_energy = _soft_norm(energy_mean, 0.02, 0.20, xp)
    norm_rate = _soft_norm(speech_rate, 2.0, 9.0, xp)
    arousal = norm_energy * 0.7 + norm_rate * 0.3
    emotion = xp.where(
        arousal > 0.65,
        xp.where(valence > 0.1, 1, 2),  # excited / angry
        xp.where((arousal < 0.30) & (valence < -0.4), 3, 0),  # sad / neutral
    )

    # --- 8-D polarized speaker vector (:191-221) ---
    base_pitch = xp.where(
        gender == 1,
        _soft_norm(pitch_mean, 60.0, 200.0, xp) * 0.4,
        xp.where(
            gender == 2,
            0.6 + _soft_norm(pitch_mean, 160.0, 350.0, xp) * 0.4,
            0.5,
        ),
    )
    vec = xp.stack(
        [
            base_pitch,
            _soft_norm(sc_mean, 40.0, 250.0, xp),
            _soft_norm(pitch_std, 5.0, 100.0, xp) * 0.1,
            _soft_norm(energy_mean, 0.0, 0.3, xp) * 0.1,
            _soft_norm(zcr_mean, 0.0, 0.5, xp) * 0.8,
            _soft_norm(speech_rate, 1.0, 12.0, xp) * 0.1,
            arousal * 0.05,
            ((valence + 1.0) / 2.0) * 0.05,
        ]
    )
    return pitch_mean, gender, arousal, valence, emotion, vec


def _prosody_numeric_np(audio: np.ndarray, sample_rate: int,
                        opts: ProsodyOptions):
    """The numeric prosody of one clip (the serving path): a copy of the
    JAX package's ``_prosody_numeric_np``."""
    shift = sample_rate // 100
    n = audio.shape[0]
    n_frames = n // shift
    x = audio[: n_frames * shift].astype(np.float64)

    from scipy.signal import lfilter

    # y[t] = (1-alpha)·y[t-1] + alpha·x[t]  (reference :74-75)
    filt = lfilter([opts.lpf_alpha], [1.0, -(1.0 - opts.lpf_alpha)], x)
    frames = x.reshape(n_frames, shift)
    filt = filt.reshape(n_frames, shift)

    # --- RMS energy + onset peaks (:69-83) ---
    rms = np.sqrt(np.mean(frames * frames, axis=1))
    prev_rms = np.concatenate([[0.0], rms[:-1]])
    peak_count = int(np.sum((rms > 0.05) & (prev_rms <= 0.05)))

    # --- standard ZCR over the filtered frame (:93,111-112) ---
    nonneg = filt >= 0.0
    zcr = np.sum(nonneg[:, 1:] != nonneg[:, :-1], axis=1) / shift

    # --- hysteresis cycle counting (:85-110) ---
    c = np.maximum(0.002, rms * 0.15)[:, None]
    sign = np.where(filt > c, 1, np.where(filt < -c, -1, 0))
    pos_of_nz = np.where(sign != 0, np.arange(shift)[None, :], -1)
    last_nz = np.maximum.accumulate(pos_of_nz, axis=1)
    prev_nz = np.concatenate(
        [np.full((n_frames, 1), -1), last_nz[:, :-1]], axis=1
    )
    prev_sign = np.where(
        prev_nz >= 0,
        np.take_along_axis(sign, np.maximum(prev_nz, 0), axis=1),
        0,
    )
    cycles = np.sum((sign[:, 1:] == -1) & (prev_sign[:, 1:] == 1), axis=1)

    dur_frame = shift / sample_rate
    f0 = cycles / dur_frame
    f0_valid = (
        (rms > 0.015)
        & (cycles > 0)
        & (f0 >= opts.min_pitch)
        & (f0 <= opts.max_pitch)
    )

    # --- spectral centroid proxy (:121-127) ---
    k = np.arange(1, shift, dtype=np.float64)
    diff = np.abs(frames[:, 1:] - frames[:, :-1])
    power = np.sum(diff, axis=1)
    weighted = np.sum(diff * k, axis=1)
    sc = np.where(power > 0, weighted / np.maximum(power, 1e-20), 0.0)

    # --- aggregation (:130-135) ---
    f0v = np.sort(f0[f0_valid])
    pitch_mean = float(f0v[len(f0v) // 2]) if f0v.size else 0.0
    pitch_std = float(np.std(f0[f0_valid])) if f0v.size else 0.0
    energy_mean = float(np.mean(rms)) if n_frames else 0.01
    energy_std = float(np.std(rms)) if n_frames else 0.0
    sc_mean = float(np.mean(sc)) if n_frames else 50.0
    zcr_mean = float(np.mean(zcr)) if n_frames else 0.1

    duration = n / sample_rate
    speech_rate = peak_count / duration if duration > 0 else 0.0

    # Octave halving / gender / emotion / speaker vector.
    pitch_mean, gender, arousal, valence, emotion, vec = _heuristics(
        np, pitch_mean, pitch_std, energy_mean, sc_mean, zcr_mean,
        speech_rate, opts,
    )
    return (
        float(pitch_mean), pitch_std, energy_mean, energy_std, sc_mean,
        zcr_mean, float(arousal), float(valence), int(gender), int(emotion),
        np.asarray(vec, np.float32), speech_rate,
    )


def _one_pole_lpf(x: torch.Tensor, alpha: float, shift: int) -> torch.Tensor:
    """``y[t] = (1 - alpha) y[t-1] + alpha x[t]``, ``y[-1] = 0``, over each
    row of ``x`` [B, F*shift]: inside each frame a lower-triangular product
    from a zero start, then each frame's start carried from the previous
    frame's end by a doubling scan over the frames (the JAX package's
    ``associative_scan``). Returns [B, F, shift]."""
    B = x.shape[0]
    frames = x.reshape(B, -1, shift)
    r = 1.0 - alpha
    k = torch.arange(shift, dtype=x.dtype, device=x.device)
    lag = k[:, None] - k[None, :]
    within = torch.where(lag >= 0, alpha * r ** lag.clamp(min=0), 0.0)  # [k, j]
    z = frames @ within.T  # each frame from a zero start
    ends = z[:, :, -1]
    step, carry = 1, r**shift
    while step < ends.shape[1]:  # ends[f] = sum over g <= f of r^(shift (f-g)) z_end[g]
        ends = torch.cat([ends[:, :step], ends[:, step:] + carry * ends[:, :-step]], dim=1)
        step, carry = 2 * step, carry * carry
    start = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], dim=1)
    return z + r ** (k + 1) * start[:, :, None]


def _masked_lower_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per row, the element at sorted index count // 2 of the valid ones
    (``nth_element(n/2)``); 0 for a row with none."""
    count = valid.sum(dim=1)
    ordered = torch.where(valid, vals, torch.inf).sort(dim=1).values
    idx = (count // 2).clamp(max=vals.shape[1] - 1)
    got = ordered.gather(1, idx[:, None])[:, 0]
    return torch.where(count > 0, got, 0.0)


def _masked_mean_std(vals: torch.Tensor, valid: torch.Tensor):
    """Per row, the mean and population std of the valid entries (0, 0 for
    a row with none)."""
    n = valid.sum(dim=1)
    count = n.clamp(min=1).to(vals.dtype)
    mean = torch.where(valid, vals, 0.0).sum(dim=1) / count
    var = torch.where(valid, (vals - mean[:, None]) ** 2, 0.0).sum(dim=1) / count
    return torch.where(n > 0, mean, 0.0), torch.where(n > 0, var.sqrt(), 0.0)


def prosody_numeric(
    audio: torch.Tensor,  # [B, N] float, zero-padded clips
    n_samples: torch.Tensor,  # [B] int: each clip's valid length
    sample_rate: int = 16000,
    opts: ProsodyOptions = ProsodyOptions(),
) -> ProsodyNumeric:
    """The numeric prosody of a batch of padded clips, in float64 on their
    device: the JAX package's ``prosody_numeric`` over each row, where only
    the frames fully inside the first ``n_samples`` count, and a clip
    shorter than one frame gets the neutral tags."""
    shift = sample_rate // 100
    B = audio.shape[0]
    n_frames = audio.shape[1] // shift
    x = audio[:, : n_frames * shift].to(torch.float64)
    n = torch.as_tensor(n_samples, device=x.device).reshape(B).to(torch.int64)
    dev = x.device

    frame_valid = (torch.arange(1, n_frames + 1, device=dev)[None, :] * shift) <= n[:, None]
    frames = x.reshape(B, n_frames, shift)
    filt = _one_pole_lpf(x, opts.lpf_alpha, shift)

    # --- RMS energy + onset peaks ---
    rms = frames.square().mean(dim=2).sqrt()
    prev_rms = torch.cat([torch.zeros_like(rms[:, :1]), rms[:, :-1]], dim=1)
    peak_count = (frame_valid & (rms > 0.05) & (prev_rms <= 0.05)).sum(dim=1)

    # --- standard ZCR over the filtered frame ---
    nonneg = filt >= 0.0
    zcr = (nonneg[:, :, 1:] != nonneg[:, :, :-1]).sum(dim=2).to(x.dtype) / shift

    # --- hysteresis cycle counting on the filtered frame ---
    c = torch.clamp(rms * 0.15, min=0.002)[:, :, None]
    sign = torch.where(filt > c, 1, torch.where(filt < -c, -1, 0))
    k = torch.arange(shift, device=dev)
    last_nz = torch.where(sign != 0, k, -1).cummax(dim=2).values
    prev_nz = torch.cat([torch.full_like(last_nz[:, :, :1], -1), last_nz[:, :, :-1]], dim=2)
    prev_sign = torch.where(prev_nz >= 0, sign.gather(2, prev_nz.clamp(min=0)), 0)
    cycles = ((sign[:, :, 1:] == -1) & (prev_sign[:, :, 1:] == 1)).sum(dim=2)

    f0 = cycles.to(x.dtype) / (shift / sample_rate)
    f0_valid = (frame_valid & (rms > 0.015) & (cycles > 0) & (f0 >= opts.min_pitch)
                & (f0 <= opts.max_pitch))

    # --- spectral centroid proxy (first differences of the raw frame) ---
    diff = (frames[:, :, 1:] - frames[:, :, :-1]).abs()
    power = diff.sum(dim=2)
    weighted = (diff * k[1:].to(x.dtype)).sum(dim=2)
    sc = torch.where(power > 0, weighted / power.clamp(min=1e-20), 0.0)

    # --- aggregation ---
    pitch_mean = _masked_lower_median(f0, f0_valid)
    _, pitch_std = _masked_mean_std(f0, f0_valid)
    energy_mean, energy_std = _masked_mean_std(rms, frame_valid)
    any_frame = frame_valid.any(dim=1)
    energy_mean = torch.where(any_frame, energy_mean, 0.01)
    sc_mean = torch.where(any_frame, _masked_mean_std(sc, frame_valid)[0], 50.0)
    zcr_mean = torch.where(any_frame, _masked_mean_std(zcr, frame_valid)[0], 0.1)

    duration = n.to(x.dtype) / sample_rate
    speech_rate = torch.where(duration > 0, peak_count / duration.clamp(min=1e-9), 0.0)

    pitch_mean, gender, arousal, valence, emotion, vec = _heuristics(
        torch, pitch_mean, pitch_std, energy_mean, sc_mean, zcr_mean, speech_rate, opts)

    empty = n < shift  # shorter than one frame: the neutral tags

    def z(v):
        return torch.where(empty, torch.zeros_like(v), v)

    return ProsodyNumeric(
        pitch_mean=z(pitch_mean), pitch_std=z(pitch_std), energy_mean=z(energy_mean),
        energy_std=z(energy_std), spectral_centroid=z(sc_mean), zero_crossing_rate=z(zcr_mean),
        arousal=z(arousal), valence=z(valence), gender_code=z(gender),
        emotion_code=z(emotion), speaker_vec=torch.where(empty[:, None], 0.0, vec.T),
        speech_rate=z(speech_rate),
    )


def extract_prosody(
    audio: np.ndarray,
    sample_rate: int = 16000,
    opts: ProsodyOptions = ProsodyOptions(),
) -> AffectiveTags:
    """Host API matching the reference's ``extract_prosody`` contract."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    n = audio.shape[0]
    if n < 160:
        return AffectiveTags()
    (pitch_mean, pitch_std, energy_mean, energy_std, sc_mean, zcr_mean,
     arousal, valence, gender, emotion, vec, speech_rate) = (
        _prosody_numeric_np(audio, sample_rate, opts)
    )
    return AffectiveTags(
        gender_proxy=GENDER_CODES[gender],
        emotion_proxy=EMOTION_CODES[emotion],
        pitch_mean=pitch_mean,
        pitch_std=pitch_std,
        energy_mean=energy_mean,
        energy_std=energy_std,
        spectral_centroid=sc_mean,
        zero_crossing_rate=zcr_mean,
        arousal=arousal,
        valence=valence,
        speaker_vec=vec,
        speech_rate=speech_rate,
    )
