"""Robust audio ingest: WAV parsing, ffmpeg fallback, raw-PCM fallback.

Port of the reference service's host-side decode chain
(its src/utils.h:27-202): RIFF chunk walk (fmt/data, PCM16
only), stereo→mono average mix, N-channel→channel 0, no-WAV-header →
ffmpeg subprocess (any container → s16le 16 kHz mono), final fallback =
interpret bytes as raw PCM16 @ 16 kHz. Container decode is inherently
host/CPU work (SURVEY.md §2.2 item 6); vectorized with numpy here.
"""

from __future__ import annotations

import dataclasses
import logging
import subprocess

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass
class DecodedAudio:
    pcm_data: np.ndarray  # int16 mono
    sample_rate: int = 16000
    channels: int = 1  # source channel count
    is_valid: bool = False


def has_wav_header(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE"


def decode_with_ffmpeg(data: bytes, sample_rate: int = 16000) -> np.ndarray:
    """Any container → mono s16le PCM via an ffmpeg subprocess (pipes, no
    temp-file race unlike the reference's /tmp files)."""
    try:
        proc = subprocess.run(
            [
                "ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
                "-i", "pipe:0",
                "-f", "s16le", "-acodec", "pcm_s16le", "-ac", "1",
                "-ar", str(sample_rate), "pipe:1",
            ],
            input=data,
            capture_output=True,
            timeout=120,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        log.error("ffmpeg unavailable/failed: %s", e)
        return np.zeros(0, np.int16)
    if proc.returncode != 0:
        log.error("ffmpeg conversion failed rc=%d: %s", proc.returncode,
                  proc.stderr.decode(errors="replace")[:500])
        return np.zeros(0, np.int16)
    out = proc.stdout
    return np.frombuffer(out[: len(out) // 2 * 2], dtype="<i2")


def parse_wav_robust(data: bytes) -> DecodedAudio:
    """Decode bytes to mono int16 PCM with the reference's fallback chain.

    The common case (a valid PCM16 WAV) takes the native C++ parser
    (``native.parse_wav_native``, over ``native/sstw_native.cpp``) where its
    library builds; the Python parser below is the reference implementation
    and the fallback, as in the JAX package."""
    if has_wav_header(data):
        try:
            from ..native import parse_wav_native

            parsed = parse_wav_native(data)
        except Exception:
            parsed = None
        if parsed is not None:
            pcm, rate, channels = parsed
            return DecodedAudio(pcm, rate, channels, True)
    if not has_wav_header(data):
        log.info("No WAV header; attempting ffmpeg conversion")
        converted = decode_with_ffmpeg(data)
        if converted.size:
            return DecodedAudio(converted, 16000, 1, True)
        log.warning("ffmpeg empty; falling back to raw PCM16 assumption")
        raw = np.frombuffer(data[: len(data) // 2 * 2], dtype="<i2")
        return DecodedAudio(raw.copy(), 16000, 1, True)

    ptr = 12
    channels = 1
    sample_rate = 16000
    bits = 0
    fmt_found = False
    pcm = None
    n = len(data)
    while ptr + 8 < n:
        chunk_id = data[ptr : ptr + 4]
        chunk_size = int.from_bytes(data[ptr + 4 : ptr + 8], "little")
        ptr += 8
        if ptr + chunk_size > n:
            break
        if chunk_id == b"fmt ":
            if chunk_size < 16:
                raise ValueError("Invalid fmt chunk")
            fmt_tag = int.from_bytes(data[ptr : ptr + 2], "little")
            if fmt_tag not in (1, 0xFFFE):
                raise ValueError("Unsupported WAV format tag")
            channels = int.from_bytes(data[ptr + 2 : ptr + 4], "little")
            sample_rate = int.from_bytes(data[ptr + 4 : ptr + 8], "little")
            bits = int.from_bytes(data[ptr + 14 : ptr + 16], "little")
            fmt_found = True
            ptr += chunk_size
        elif chunk_id == b"data":
            if not fmt_found:
                raise ValueError("No fmt chunk before data")
            pcm_size = min(chunk_size, n - ptr)
            pcm = np.frombuffer(data, dtype="<i2", count=pcm_size // 2, offset=ptr)
            break
        else:
            ptr += chunk_size
        if chunk_size % 2 and ptr < n:
            ptr += 1  # RIFF word alignment
    if pcm is None or pcm.size == 0:
        raise ValueError("No data chunk")
    if bits != 16:
        raise ValueError("Unsupported bit depth (PCM16 only)")

    if channels == 1:
        mono = pcm.copy()
    elif channels == 2:
        frames = pcm.size // 2
        st = pcm[: frames * 2].reshape(frames, 2).astype(np.int32)
        # C++ integer division truncates toward zero (reference
        # utils.h:189-191) — not numpy's floor division.
        s = st[:, 0] + st[:, 1]
        mono = np.trunc(s / 2.0).astype(np.int16)
    else:
        frames = pcm.size // channels
        mono = pcm[: frames * channels].reshape(frames, channels)[:, 0].copy()
    return DecodedAudio(mono, sample_rate, channels, True)


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """int16 → float32 in [-1, 1) (reference stt_engine.cpp:117-125)."""
    return (np.asarray(pcm, np.int16).astype(np.float32)) / 32768.0


def write_wav(path_or_buf, pcm: np.ndarray, sample_rate: int = 16000):
    """Minimal PCM16 mono WAV writer (for tests/CLI fixtures)."""
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        pcm = (np.clip(pcm, -1.0, 1.0) * 32767.0).astype(np.int16)
    data = pcm.tobytes()
    hdr = b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE"
    hdr += b"fmt " + (16).to_bytes(4, "little")
    hdr += (1).to_bytes(2, "little") + (1).to_bytes(2, "little")
    hdr += sample_rate.to_bytes(4, "little")
    hdr += (sample_rate * 2).to_bytes(4, "little")
    hdr += (2).to_bytes(2, "little") + (16).to_bytes(2, "little")
    hdr += b"data" + len(data).to_bytes(4, "little")
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(hdr + data)
    else:
        with open(path_or_buf, "wb") as f:
            f.write(hdr + data)
