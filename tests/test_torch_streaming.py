"""The port's streaming session (``runtime/streaming.py``) and ``StreamBuffer``
(``native.py``) against the JAX package's, on the CPU.

Both engines run the fp32 ``test`` config over the same weights (the JAX
package's ``init_params`` at key 1, carried across with ``from_jax_numpy``:
at key 1 the random weights give a segment that two incremental ticks
agree on, so the incremental case commits), the gates relaxed as in
``tests/test_torch_engine.py``, ``parallel_requests=1``, a tick at every 500 ms
of new audio (fed in chunks of 0.5 s, 1 s or 15.5 s). Each
case feeds the same PCM16 bytes to a session of each package and the two
event sequences must agree event for event: ``is_final``, text, language,
``t0``/``t1``, token pieces and token times exactly, probabilities within
1e-4 (``assert_same_results`` of the engine tests). Covered: parity mode,
incremental mode with a commit, the 30 s cap flush of a 31 s stream, EOS on
an empty buffer, the auto-language pin (both packages' detectors counted),
beam-2 finals under greedy partials, and two sessions sharing one
``RequestOptions``. ``StreamBuffer`` is held against the JAX package's
pure-Python branch under hypothesis-drawn chunkings, with and without a
WAV header. After ``warmup()``, an incremental stream's ticks and EOS
finalize ask for no decode graph class that the warm-up did not (the
classes a card would capture; on the CPU the loops run eagerly, so the
test records the class keys instead of counting captures).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sentiric_stt_whisper_service_tpu import native as ref_native
from sentiric_stt_whisper_service_tpu.config import Settings as RefSettings
from sentiric_stt_whisper_service_tpu.models import whisper as ref_whisper
from sentiric_stt_whisper_service_tpu.runtime import engine as ref_engine
from sentiric_stt_whisper_service_tpu.runtime import streaming as ref_streaming
from sentiric_stt_whisper_service_tpu_torch.audio import write_wav
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import beam, sampling, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.native import StreamBuffer
from sentiric_stt_whisper_service_tpu_torch.runtime import engine, streaming
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_engine import RELAXED, assert_same_results, ref_options

CFG_R = ref_whisper.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
STREAM = dict(RELAXED, stream_buffer_samples=8000)


def speechlike(seconds: float, seed: int = 3) -> np.ndarray:
    """A modulated 170 Hz tone with a little noise (tests/test_streaming.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    carrier = np.sin(2 * np.pi * 170 * t)
    env = 0.7 + 0.3 * np.sin(2 * np.pi * 3 * t)
    return (0.15 * carrier * env + 0.004 * rng.standard_normal(len(t))).astype(np.float32)


def to_pcm16(audio) -> bytes:
    return (np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes()


@pytest.fixture(scope="module")
def model():
    params = ref_whisper.init_params(CFG_R, jax.random.key(1))
    return params, from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")


@pytest.fixture(scope="module")
def pair(model):
    """(port engine, JAX engine) over the same fp32 weights."""
    params, torch_model = model
    theirs = ref_engine.SttEngine(RefSettings(**STREAM), model_name="test", params=params)
    theirs.cfg = CFG_R  # the reference engine takes its dtype from its config
    mine = engine.SttEngine(Settings(device="cpu", **STREAM), model_name="test",
                            params=torch_model)
    return mine, theirs


def sessions(pair, incremental=False, options=None, ref_opts=None):
    mine, theirs = pair
    opts = options if options is not None else engine.RequestOptions(language="en")
    return (streaming.StreamingSession(mine, opts, incremental=incremental),
            ref_streaming.StreamingSession(theirs, ref_opts or ref_options(opts),
                                           incremental=incremental))


def feed(session, raw: bytes, chunk_bytes: int, eos: bool = True) -> list:
    events = []
    for i in range(0, len(raw), chunk_bytes):
        events.extend(session.feed(raw[i : i + chunk_bytes]))
    if eos:
        events.extend(session.feed(b""))
    return events


def assert_same_events(got, want):
    assert [e.is_final for e in got] == [e.is_final for e in want]
    assert_same_results([e.result for e in got], [e.result for e in want])


def run_both(pair, raw, chunk_bytes=16000, **kw):
    mine, theirs = sessions(pair, **kw)
    got, want = feed(mine, raw, chunk_bytes), feed(theirs, raw, chunk_bytes)
    assert_same_events(got, want)
    assert mine.buffer.size == 0
    return got


def test_parity_mode(pair):
    """Partials end in " " and are never final; the finals come on EOS."""
    events = run_both(pair, to_pcm16(speechlike(2.0)))
    partials = [e for e in events if not e.is_final]
    assert partials and all(e.result.text.endswith(" ") for e in partials)
    assert events[-1].is_final
    assert all(e.is_final for e in events[events.index(partials[-1]) + 1 :])


def test_incremental_commits(pair):
    """A segment that two ticks agree on, ending a second before the head,
    is committed mid-stream and the buffer trimmed; finals' times are
    absolute and in order."""
    events = run_both(pair, to_pcm16(speechlike(6.0)), 32000, incremental=True)
    finals = [e for e in events if e.is_final]
    first_partial = next(i for i, e in enumerate(events) if not e.is_final)
    assert any(e.is_final for e in events[first_partial:-1]), "no commit mid-stream"
    assert [e.result.t0 for e in finals] == sorted(e.result.t0 for e in finals)


def test_cap_flush_31s(pair):
    """31 s in two chunks: the tick that passes the 30 s cap flushes finals
    through a full-quality re-decode (parity mode with alignment on)."""
    mine, theirs = sessions(pair)
    raw = to_pcm16(speechlike(31.0, seed=5))
    got = feed(mine, raw, len(raw) // 2, eos=False)
    want = feed(theirs, raw, len(raw) // 2, eos=False)
    assert_same_events(got, want)
    assert any(e.is_final for e in got) and mine.buffer.size == 0
    assert_same_events(mine.feed(b""), theirs.feed(b""))


def test_eos_on_empty_buffer(pair):
    mine, theirs = sessions(pair)
    assert mine.feed(b"") == [] == theirs.feed(b"")


def test_auto_language_pin(pair, monkeypatch):
    """Auto-language streams detect on every tick until the buffer holds
    LANG_PIN_MIN_S (or detection is confident), then pin; EOS unpins. Both
    packages' detectors run the same number of times."""
    calls = {"mine": 0, "theirs": 0}

    def spy(module, key):
        orig = module.detect_language

        def counted(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(module, "detect_language", counted)

    spy(engine, "mine")
    spy(ref_engine, "theirs")
    mine, theirs = sessions(pair, incremental=True, options=engine.RequestOptions(language=""))
    first = to_pcm16(speechlike(4.0))  # ticks of 1 s: pinned at the third
    got, want = feed(mine, first, 32000, eos=False), feed(theirs, first, 32000, eos=False)
    n_live = calls["mine"]
    assert 1 <= n_live <= int(streaming.LANG_PIN_MIN_S / 0.5) + 1
    assert mine._detected_lang == theirs._detected_lang != ""
    more = to_pcm16(speechlike(2.0, seed=9))
    got += feed(mine, more, 32000)
    want += feed(theirs, more, 32000)
    assert calls["mine"] == n_live  # pinned: no detection until EOS
    after = to_pcm16(speechlike(1.0, seed=5))
    got += feed(mine, after, 32000, eos=False)
    want += feed(theirs, after, 32000, eos=False)
    assert calls["mine"] > n_live  # EOS unpinned: the next utterance detects
    assert calls["mine"] == calls["theirs"]
    assert_same_events(got, want)


def test_beam2_finals_greedy_partials(pair):
    """beam_size=2 requested: partial ticks decode greedy
    (stream_greedy_partials), the EOS finals with beam 2."""
    run_both(pair, to_pcm16(speechlike(1.5, seed=4)),
             options=engine.RequestOptions(language="en", beam_size=2))


def test_two_sessions_share_options(pair):
    """Two auto-language sessions over one RequestOptions, fed in turns:
    each pins its own language on a copy, the shared options stay as they
    were, and each stream equals the JAX package's stream fed the same way."""
    mine, theirs = pair
    opts = engine.RequestOptions(language="")
    ref_opts = ref_options(opts)
    a = (streaming.StreamingSession(mine, opts), ref_streaming.StreamingSession(theirs, ref_opts))
    b = (streaming.StreamingSession(mine, opts), ref_streaming.StreamingSession(theirs, ref_opts))
    raws = (to_pcm16(speechlike(2.0, seed=11)), to_pcm16(speechlike(2.0, seed=12)))
    events = {id(s): [] for pair_ in (a, b) for s in pair_}
    for i in range(0, len(raws[0]), 32000):
        for pair_, raw in zip((a, b), raws):
            for s in pair_:
                events[id(s)].extend(s.feed(raw[i : i + 32000]))
    for pair_ in (a, b):
        for s in pair_:
            events[id(s)].extend(s.feed(b""))
        assert_same_events(events[id(pair_[0])], events[id(pair_[1])])
    assert opts.language == "" and ref_opts.language == ""


def _wav_bytes(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, samples.astype(np.float32) / 32768.0)
    return buf.getvalue()


@settings(max_examples=60, deadline=None)
@given(data=st.data(), n=st.integers(0, 400), header=st.booleans(),
       clear_at=st.one_of(st.none(), st.integers(0, 8)))
def test_stream_buffer_matches_reference(monkeypatch_module, data, n, header, clear_at):
    """The same bytes in the same chunks (odd splits, a split inside the
    44-byte header, empty chunks), with an optional clear() between chunks:
    size after every append, read() at the end, equal to the JAX package's
    pure-Python branch."""
    pcm = np.arange(n, dtype=np.int16) * 37 - 5000
    raw = _wav_bytes(pcm) if header else pcm.tobytes()
    cuts = sorted(data.draw(st.lists(st.integers(0, len(raw)), max_size=8)))
    chunks = [raw[i:j] for i, j in zip([0] + cuts, cuts + [len(raw)])]
    mine, theirs = StreamBuffer(), ref_native.StreamBuffer()
    assert theirs._lib is None
    for k, chunk in enumerate(chunks):
        if k == clear_at:
            mine.clear()
            theirs.clear()
        assert mine.append(chunk) == theirs.append(chunk)
        assert mine.size == theirs.size
    got, want = mine.read(), theirs.read()
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    if header and clear_at is None and len(chunks[0]) > 44:  # the header is stripped
        np.testing.assert_array_equal(got, np.frombuffer(raw[44:len(raw) // 2 * 2], "<i2"))


@pytest.fixture(scope="module")
def monkeypatch_module():
    """The JAX package's StreamBuffer without its native library (its
    pure-Python branch), for the whole module's hypothesis examples."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_native, "get_lib", lambda: None)
    yield mp
    mp.undo()


def test_incremental_ticks_no_new_graph_class(model, monkeypatch):
    """After warmup(), an incremental stream's ticks and its EOS finalize
    decode only in graph classes that the warm-up asked for (so on the card
    they capture nothing): every class key that reaches
    ``models/graphs.window_loop`` from the greedy and beam loops is
    recorded, during warmup() and during the stream."""
    _, torch_model = model
    eng = engine.SttEngine(Settings(device="cpu", **dict(STREAM, stream_incremental=True)),
                           model_name="test", params=torch_model)
    seen = []
    for module in (sampling, beam):
        orig = module.window_loop

        def recording(dev, graph, graphs, key, *a, _orig=orig, **kw):
            seen.append(key)
            return _orig(dev, graph, graphs, key, *a, **kw)

        monkeypatch.setattr(module, "window_loop", recording)
    eng.warmup()
    warmed = set(seen)
    seen.clear()
    session = streaming.StreamingSession(eng, engine.RequestOptions(language="en"),
                                         incremental=True)
    events = feed(session, to_pcm16(speechlike(4.0)), 16000)
    assert events and seen
    assert set(seen) <= warmed, set(seen) - warmed
