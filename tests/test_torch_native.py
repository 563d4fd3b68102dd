"""The port's native WAV parser (``native.parse_wav_native`` over
``native/sstw_native.cpp``, built by the port into its ``_build/``) against
its Python parser and the JAX package's ``native.parse_wav_native``, on WAVs
made here (the repository vendors no WAV files: ``tests/fixtures/parity``
holds transcripts only) and on WAVs that hypothesis makes (1–4 channels,
any rate, extra chunks before and between ``fmt `` and ``data``, odd chunk
sizes, the extensible format tag). ``audio/wav.parse_wav_robust`` takes the
native path first, and keeps the Python parser where nothing builds."""

import io

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sentiric_stt_whisper_service_tpu import native as ref_native
from sentiric_stt_whisper_service_tpu_torch import native
from sentiric_stt_whisper_service_tpu_torch.audio import wav



@pytest.fixture(scope="module")
def native_lib():
    """The built library; the tests that need it skip where no C++
    toolchain builds it (decided here, not while the module imports)."""
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain: the native library does not build")
    return lib


def chunk(cid: bytes, body: bytes) -> bytes:
    return cid + len(body).to_bytes(4, "little") + body + (b"\0" if len(body) % 2 else b"")


def make_wav(samples: np.ndarray, rate: int, channels: int, tag: int = 1,
             extra: tuple = (), between: tuple = ()) -> bytes:
    """A RIFF/WAVE of int16 ``samples`` (interleaved) with ``extra`` chunks
    before ``fmt `` and ``between`` chunks after it."""
    fmt = (tag.to_bytes(2, "little") + channels.to_bytes(2, "little")
           + rate.to_bytes(4, "little") + (rate * 2 * channels).to_bytes(4, "little")
           + (2 * channels).to_bytes(2, "little") + (16).to_bytes(2, "little"))
    if tag == 0xFFFE:
        fmt += (22).to_bytes(2, "little") + bytes(22)
    body = b"WAVE" + b"".join(chunk(c, b) for c, b in extra) + chunk(b"fmt ", fmt)
    body += b"".join(chunk(c, b) for c, b in between)
    body += chunk(b"data", np.asarray(samples, "<i2").tobytes())
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def python_parse(data: bytes, monkeypatch) -> wav.DecodedAudio:
    with monkeypatch.context() as m:
        m.setattr(native, "parse_wav_native", lambda _data: None)
        return wav.parse_wav_robust(data)


def assert_all_equal(data: bytes, monkeypatch, with_python: bool = True):
    got = native.parse_wav_native(data)
    want = ref_native.parse_wav_native(data)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    if with_python:
        py = python_parse(data, monkeypatch)
        np.testing.assert_array_equal(got[0], py.pcm_data)
        assert (got[1], got[2]) == (py.sample_rate, py.channels)
    return got


rng = np.random.default_rng(0)
CASES = {
    "mono_22050": make_wav(rng.integers(-32768, 32767, 500), 22050, 1),
    "stereo_odd_sums": make_wav(np.array([-3, 0, 5, -8, 32767, 32767, -32768, -32768, 1, -2]),
                                16000, 2),
    "three_channels": make_wav(rng.integers(-2000, 2000, 300), 8000, 3),
    "extensible": make_wav(rng.integers(-2000, 2000, 64), 44100, 1, tag=0xFFFE),
    "list_before_fmt": make_wav(rng.integers(-99, 99, 33), 16000, 1,
                                extra=((b"LIST", b"INFOabc"),)),
    "odd_chunk_between": make_wav(rng.integers(-99, 99, 40), 48000, 2,
                                  between=((b"junk", b"x" * 7), (b"fact", b"\1\0\0\0"))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_matches_python_and_reference(native_lib, name, monkeypatch):
    assert_all_equal(CASES[name], monkeypatch)


def test_native_rejects_and_truncates_as_reference(native_lib):
    for bad in (b"not a wav at all", make_wav(np.zeros(8), 16000, 1)[:40],
                make_wav(np.zeros(8), 16000, 1, tag=3)):
        assert native.parse_wav_native(bad) is None
        assert ref_native.parse_wav_native(bad) is None
    # A data chunk that claims more bytes than the file holds: the native
    # parsers read what is there (the Python parser finds no data chunk).
    cut = make_wav(np.arange(20), 16000, 1)[:-10]
    got, want = native.parse_wav_native(cut), ref_native.parse_wav_native(cut)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], np.arange(15))


@settings(max_examples=60, deadline=None)
@given(channels=st.integers(1, 4), rate=st.integers(1, 192000),
       frames=st.integers(1, 400), seed=st.integers(0, 2**32 - 1),
       extra=st.lists(st.tuples(st.sampled_from([b"LIST", b"junk", b"fact", b"bext"]),
                                st.binary(max_size=13)), max_size=2),
       between=st.lists(st.tuples(st.sampled_from([b"LIST", b"cue "]), st.binary(max_size=9)),
                        max_size=2),
       extensible=st.booleans())
def test_native_matches_on_made_wavs(native_lib, channels, rate, frames, seed, extra, between,
                                     extensible):
    samples = np.random.default_rng(seed).integers(-32768, 32768, frames * channels)
    data = make_wav(samples, rate, channels, tag=0xFFFE if extensible else 1,
                    extra=tuple(extra), between=tuple(between))
    with pytest.MonkeyPatch.context() as m:
        got = assert_all_equal(data, m)
    frames_in = samples.reshape(frames, channels).astype(np.int32)
    want = (np.trunc(frames_in.sum(1) / 2.0) if channels == 2 else frames_in[:, 0])
    np.testing.assert_array_equal(got[0], want.astype(np.int16))


def test_parse_wav_robust_takes_native_path(native_lib, monkeypatch):
    calls = []
    real = native.parse_wav_native
    monkeypatch.setattr(native, "parse_wav_native", lambda d: calls.append(1) or real(d))
    buf = io.BytesIO()
    wav.write_wav(buf, np.linspace(-0.5, 0.5, 1000, dtype=np.float32), 16000)
    got = wav.parse_wav_robust(buf.getvalue())
    assert calls and got.is_valid and got.sample_rate == 16000
    np.testing.assert_array_equal(got.pcm_data, python_parse(buf.getvalue(), monkeypatch).pcm_data)
    lib = native._lib_path()
    assert lib.parent == native.BUILD_DIR and lib.exists()


def test_without_toolchain_python_parser(tmp_path, monkeypatch):
    """No compiler: get_lib() is None, nothing is written outside the build
    directory, and parse_wav_robust still parses through Python."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.get_lib() is None and native.parse_wav_native(CASES["mono_22050"]) is None
    got = wav.parse_wav_robust(CASES["stereo_odd_sums"])
    np.testing.assert_array_equal(got.pcm_data, [-1, -1, 32767, -32768, 0])
    assert [p.name for p in (tmp_path / "_build").iterdir()] == []
