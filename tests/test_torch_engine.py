"""The port's transcription engine (``runtime/engine.py``) against the JAX
package's ``SttEngine`` on the CPU: the fp32 ``test`` config, the same
weights carried across with ``from_jax_numpy``, the gates relaxed
(``quality_gate="off"``, a logprob threshold of -1e9, ``no_speech_threshold``
1.0, ``min_segment_avg_prob`` 0) so that random weights keep their
segments, ``parallel_requests=1``.

Each request must give equal segments: text, language, t0/t1, speaker ids
and turns, token count, token pieces and token times (centiseconds, exact:
the same DTW path), language probability within 1e-5, segment and token
probabilities within 1e-4 (fp32 log-probabilities that agree to ~1e-6),
prosody within 1e-5. Covered: greedy (with a prompt and diarization),
beam 5 and beam 9, both long-form paths, ``audio_ctx`` 0, -1 and fixed, the
resample, min-duration, VAD and abort gates, ``EngineBusyException``, and
the int8 and int4 compute types against the reference's own quantized
engine. The fallback ladder is held with both engines' ``_decode_one``
scripted to the same results: the rungs tried, the result chosen and the
prompt reset above t = 0.5. The port refuses at construction what it
cannot serve: no card for ``device="auto"``, a mesh of more devices than
processes (the engine over a mesh: ``tests/test_torch_engine_mesh.py``), a
draft together with a mesh (not ported), beam sizes above 32 and a
``draft_model`` of another encoder width."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.config import Settings as RefSettings
from sentiric_stt_whisper_service_tpu.models import sampling as ref_sampling
from sentiric_stt_whisper_service_tpu.models import whisper as ref_whisper
from sentiric_stt_whisper_service_tpu.runtime import engine as ref_engine
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import sampling, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.runtime import engine
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref_whisper.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
RELAXED = dict(enable_vad=False, parallel_requests=1, beam_size=1, quality_gate="off",
               logprob_threshold=-1e9, no_speech_threshold=1.0, min_segment_avg_prob=0.0,
               compute_type="float32")


def speechlike(seconds: float, sr: int = 16000, seed: int = 7) -> np.ndarray:
    """Modulated tone bursts with a little noise (tests/test_engine.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    carrier = np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 450 * t)
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3 * t - np.pi / 2))
    return (0.2 * carrier * envelope + 0.005 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return ref_whisper.init_params(CFG_R, jax.random.key(0))


def make_pair(params, **overrides):
    """(port engine, reference engine) over the same fp32 weights."""
    settings = {**RELAXED, **overrides}
    theirs = ref_engine.SttEngine(RefSettings(**settings), model_name="test", params=params)
    theirs.cfg = CFG_R  # the reference engine takes its dtype from its config
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    mine = engine.SttEngine(Settings(device="cpu", **settings), model_name="test", params=model)
    return mine, theirs


@pytest.fixture(scope="module")
def fp32(params):
    return make_pair(params)


def ref_options(opts: engine.RequestOptions) -> ref_engine.RequestOptions:
    fields = {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}
    fields.pop("prosody_opts")
    return ref_engine.RequestOptions(**fields)


def run_both(pair, audio, sr=16000, shared_xa=False, **options):
    """One request through both engines. ``shared_xa``: the reference's
    engine decodes from the port's cross K/V (its ``_encode_window`` hands
    the port's output over), so that the comparison starts after the
    encode, which ``test_encode_window_matches`` holds on its own."""
    mine, theirs = pair
    opts = engine.RequestOptions(**options)
    metrics = engine.PerformanceMetrics()
    got = mine.transcribe(audio, sr, opts, metrics)
    if shared_xa:
        theirs._encode_window = lambda windows, n_ctx=None: {
            k: jnp.asarray(v.numpy()) for k, v in mine._encode_window(windows, n_ctx).items()}
    try:
        want = theirs.transcribe(audio, sr, ref_options(opts))
    finally:
        theirs.__dict__.pop("_encode_window", None)
    assert_same_results(got, want)
    return got, metrics


def assert_same_results(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("text", "language", "t0", "t1", "speaker_id", "speaker_turn_next",
                     "token_count", "gender_proxy", "emotion_proxy"):
            assert getattr(g, name) == getattr(w, name), (i, name)
        assert g.language_probability == pytest.approx(w.language_probability, abs=1e-5)
        assert g.prob == pytest.approx(w.prob, abs=1e-4)
        assert [(t.text, t.t0, t.t1) for t in g.tokens] == [(t.text, t.t0, t.t1) for t in w.tokens]
        np.testing.assert_allclose([t.p for t in g.tokens], [t.p for t in w.tokens], atol=1e-4)
        for f in dataclasses.fields(w.affective):
            a, b = getattr(g.affective, f.name), getattr(w.affective, f.name)
            if isinstance(b, str):
                assert a == b, (i, f.name)
            else:
                np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                           atol=1e-5, err_msg=f"{i} {f.name}")
        for name in ("arousal", "valence"):
            assert getattr(g, name) == pytest.approx(getattr(w, name), abs=1e-5)


CLIP = speechlike(2.0)
LONG = np.concatenate([speechlike(2.0, seed=s) for s in range(20)])  # 40 s: 2+ windows

# Beam search over random weights meets near-ties: the reference's own beam-5
# search on this clip changes its hypothesis at step 129 of 224 when its
# cross K/V moves by 3e-6, the two encoders' disagreement. The beam cases
# therefore decode from one cross K/V (shared_xa). Beam 9 takes a 64-token
# cap (time: 9 beams decode eagerly on the CPU).
CASES = {
    "greedy_diarized": (CLIP, dict(enable_diarization=True)),
    "greedy_prompt": (CLIP, dict(prompt="hello there")),
    "beam5": (CLIP, dict(beam_size=5, shared_xa=True)),
    "beam9": (CLIP, dict(beam_size=9, max_decode_tokens=64, shared_xa=True)),
    "longform_sequential": (LONG, dict()),
    "longform_batched": (LONG, dict(condition_on_previous_text=False)),
    "audio_ctx_auto": (CLIP, dict(audio_ctx=-1)),
    "audio_ctx_fixed": (CLIP, dict(audio_ctx=320)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_segments_equal(fp32, case):
    audio, options = CASES[case]
    got, metrics = run_both(fp32, audio, **options)
    assert got, "random weights under relaxed gates keep segments"
    # (t1 < t0 happens, as in the reference: an unterminated trailing segment
    # that opened on a timestamp past the audio closes at the audio's end)
    assert all(r.t0 >= 0 and r.t1 >= 0 for r in got)
    assert all(b.t0 >= a.t0 for a, b in zip(got, got[1:]))
    assert {"encode", "decode", "prosody"} <= set(metrics.stages_ms)


@pytest.mark.parametrize("n_ctx", [None, 384])
def test_encode_window_matches(fp32, n_ctx):
    """The window encode (log-mel, encoder, cross K/V) at 1e-4: fp32 sums
    over 2 layers in another order (measured 3e-6)."""
    mine, theirs = fp32
    window = np.zeros((1, 16000 * 30), np.float32)
    window[0, : CLIP.size] = CLIP
    got, want = mine._encode_window(window, n_ctx), theirs._encode_window(window, n_ctx)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)


def test_resampled_input(fp32):
    audio8k = speechlike(2.0, sr=8000)
    got, _ = run_both(fp32, audio8k, sr=8000, language="en")
    assert got


def test_min_duration_and_abort_gates(fp32):
    short = np.zeros(1000, np.float32)
    assert run_both(fp32, short)[0] == []
    assert run_both(fp32, CLIP, should_abort=lambda: True)[0] == []
    polls = iter([False])  # the pre-check passes, the window loop's first poll aborts
    mine, theirs = fp32
    opts = engine.RequestOptions(language="en", should_abort=lambda: next(polls, True))
    assert mine.transcribe(CLIP, 16000, opts) == []
    polls = iter([False])
    assert theirs.transcribe(CLIP, 16000, ref_options(opts)) == []


def test_vad_gate(params):
    pair = make_pair(params, enable_vad=True)
    silent = np.zeros(16000, np.float32) + 1e-5
    got, _ = run_both(pair, silent, language="en")
    assert len(got) == 1 and got[0].language == "unknown" and got[0].speaker_id == "unknown"
    assert got[0].t1 == 1000  # the reference's quirk: t1 in ms


def test_engine_busy(params):
    mine, theirs = make_pair(params, request_queue_timeout_ms=50)
    for eng, exc, opts in ((mine, engine.EngineBusyException, engine.RequestOptions()),
                           (theirs, ref_engine.EngineBusyException, ref_engine.RequestOptions())):
        assert eng._slots.acquire()
        try:
            with pytest.raises(exc):
                eng.transcribe(CLIP, 16000, opts)
        finally:
            eng._slots.release()


@pytest.mark.parametrize("compute_type", ["int8", "int4"])
def test_quantized_engines_equal(params, compute_type):
    pair = make_pair(params, compute_type=compute_type)
    mine, theirs = pair
    assert mine.xa_bits == theirs.xa_bits and mine.quantized
    assert mine.self_dtype == torch.float8_e4m3fn
    got, _ = run_both(pair, CLIP, enable_diarization=True)
    assert got
    if compute_type == "int4":  # an odd fixed context cannot be packed: both refuse it
        with pytest.raises(ValueError, match="even"):
            mine.transcribe(CLIP, 16000, engine.RequestOptions(language="en", audio_ctx=101))
        with pytest.raises(TypeError):
            theirs.transcribe(CLIP, 16000, ref_engine.RequestOptions(language="en", audio_ctx=101))


def scripted_result(ids, init_tokens, avg_lp: float, n_ctx: int, text_tokens):
    """A DecodeResult of one window: <|0.00|> text <|1.00|> EOT."""
    sb = len(init_tokens)
    seq = [ids.timestamp_begin] + list(text_tokens) + [ids.timestamp_begin + 50, ids.eot]
    tokens = np.full((1, n_ctx), ids.eot, np.int32)
    tokens[0, :sb] = init_tokens
    tokens[0, sb : sb + len(seq)] = seq
    lps = np.zeros((1, n_ctx), np.float32)
    lps[0, sb : sb + len(seq)] = -0.25
    return dict(tokens=tokens, lengths=np.asarray([sb + len(seq)], np.int32),
                sum_logprobs=np.asarray([avg_lp * len(seq)], np.float32),
                avg_logprobs=np.asarray([avg_lp], np.float32),
                no_speech_probs=np.asarray([0.01], np.float32), token_logprobs=lps)


@pytest.mark.parametrize("passing_rung", [2, 3], ids=["accept_at_0.4", "accept_at_0.6"])
def test_fallback_ladder_scripted(params, passing_rung):
    """Rungs t = 0, 0.2, ... fail the logprob gate until ``passing_rung``;
    above t = 0.5 the next window's prompt resets."""
    pair = make_pair(params, beam_size=5, logprob_threshold=-0.7)
    calls = {"mine": [], "theirs": []}

    def script(name, result_type):
        def decode_one(xa_kv, init_tokens, sample_begin, sot_index, temperature, beam_size,
                       best_of, **kw):
            rung = int(round(temperature / 0.2))
            calls[name].append((rung, beam_size, best_of, tuple(init_tokens), sot_index))
            avg = -0.3 if rung >= passing_rung else -1.5
            text = [72 + rung, 105, 33]  # "H?!"-like byte tokens, distinct per rung
            return result_type(**scripted_result(pair[0].ids, init_tokens, avg,
                                                 CFG.n_text_ctx, text))
        return decode_one

    mine, theirs = pair
    mine._decode_one = script("mine", sampling.DecodeResult)
    theirs._decode_one = script("theirs", ref_sampling.DecodeResult)
    two_windows = np.concatenate([CLIP] * 16)  # 32 s: the second window starts at 1 s
    got, _ = run_both(pair, two_windows, language="en")
    assert calls["mine"] == calls["theirs"]
    rungs = [c[0] for c in calls["mine"]]
    per_window = list(range(passing_rung + 1))
    assert rungs[: len(per_window)] == per_window
    assert calls["mine"][0][1:3] == (5, 5)  # beam at t = 0 ...
    assert all(c[1:3] == (5, 5) for c in calls["mine"])  # ... and best-of 5 above
    window2 = [c for c in calls["mine"] if c[4] > 0]  # a carried prompt moves sot_index
    assert bool(window2) == (passing_rung * 0.2 <= 0.5)
    assert got


def test_refused_settings(params):
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.SttEngine(Settings(), model_name="test", params=model)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.SttEngine(Settings(device="cuda"), model_name="test", params=model)
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        engine.SttEngine(Settings(device="cpu", mesh_shape="2x4"), model_name="test",
                         params=model)
    # A draft under a mesh without its processes: refused as the target is.
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        engine.SttEngine(Settings(device="cpu", mesh_shape="2x4", draft_model="test"),
                         model_name="test", params=model)
    # A draft loads (its own seed under random_init), quantized and fused as
    # the target; one of another encoder width is refused.
    eng = engine.SttEngine(Settings(device="cpu", draft_model="test", compute_type="int8"),
                           model_name="test", params=model, random_init=True)
    assert eng.draft_cfg == whisper.config_for("test")
    assert eng.draft_params.decoder.blocks[0].attn.qkv.w_q is not None
    with pytest.raises(ValueError, match="encoder width 384 != target 64"):
        engine.SttEngine(Settings(device="cpu", draft_model="tiny"), model_name="test",
                         params=model)
    with pytest.raises(ValueError, match="beam_size 33"):
        engine.SttEngine(Settings(device="cpu", beam_size=33), model_name="test", params=model)
    eng = engine.SttEngine(Settings(device="cpu", **RELAXED), model_name="test", params=model)
    with pytest.raises(ValueError, match="beam_size 40"):
        eng.transcribe(CLIP, 16000, engine.RequestOptions(language="en", beam_size=40))
    assert eng._slots.acquire(blocking=False)  # the refused request gave its slot back
    eng._slots.release()


def test_warmup_then_request(params):
    """warmup() on the CPU (no graphs to capture there) runs every rung's
    decode cut short, then every streaming tick class (each serving ctx
    bucket's reachable caps, the JAX package's ``_warmup_tick_classes``),
    the detect pass, the alignment pass and prosody; a request afterwards
    still equals the reference's."""
    pair = make_pair(params, audio_ctx=-1, no_timestamps=False)
    polls = []
    decode_one = pair[0]._decode_one

    def counting(*args, **kw):
        polls.append((args[4], args[5], kw["should_abort"] is not None, kw.get("n_ctx"),
                      kw.get("sample_len", engine.SAMPLE_LEN)))
        return decode_one(*args, **kw)

    pair[0]._decode_one = counting
    assert pair[0].warmup() > 0.0
    del pair[0]._decode_one
    full = engine.SAMPLE_LEN
    # rung 0 and the sampled rung at full context, then greedy at 384, 768, 1152
    ladder = [(0.0, 1, True, None, full), (0.2, 1, True, None, full)] + [
        (0.0, 1, True, b, full) for b in (384, 768, 1152)]
    # the tick classes: each ctx bucket's caps, as the JAX package's warm-up asks for them
    ticks = []
    pair[1]._decode_one = lambda *a, **kw: ticks.append(
        (0.0, 1, True, kw["n_ctx"], kw["sample_len"]))
    try:
        pair[1]._warmup_tick_classes()
    finally:
        del pair[1]._decode_one
    assert [t[3:] for t in ticks] == [(384, 32), (384, 64), (384, 128), (768, 128), (768, 224),
                                      (1152, 224), (None, 224)]
    assert polls == ladder + ticks
    got, _ = run_both(pair, CLIP, language="en")
    assert got


def test_helpers_match():
    assert engine.TOKEN_CAP_BUCKETS == ref_engine.TOKEN_CAP_BUCKETS
    assert engine.SttEngine.AUDIO_CTX_BUCKETS == ref_engine.SttEngine.AUDIO_CTX_BUCKETS
    for n in (-1, 0, 1, 16, 17, 100, 224, 500):
        assert engine.token_cap_bucket(n) == ref_engine.token_cap_bucket(n)
    rng = np.random.default_rng(0)
    for _ in range(50):
        toks = rng.integers(0, 6, rng.integers(0, 80)).tolist()
        text = "".join(chr(97 + t) for t in toks) * 3
        assert engine._token_entropy(toks) == ref_engine._token_entropy(toks)
        assert engine._compression_ratio(text) == ref_engine._compression_ratio(text)
        for mode in ("entropy", "compression_ratio", "off"):
            assert engine.quality_gate_fails(mode, text, toks) == \
                ref_engine.quality_gate_fails(mode, text, toks)
    ids = sampling.TokenIds.from_tokenizer(fallback_tokenizer())
    for _ in range(30):
        n = int(rng.integers(0, 40))
        seq = np.where(rng.random(n) < 0.3, ids.timestamp_begin + rng.integers(0, 1500, n),
                       rng.integers(0, 300, n))
        if rng.random() < 0.5 and n:
            seq[-1] = ids.eot
        lps = rng.standard_normal(n).astype(np.float32)
        assert engine._parse_segments(seq, lps, ids, 1234) == \
            ref_engine._parse_segments(seq, lps, ids, 1234)


def test_window_ctx_matches(fp32):
    mine, theirs = fp32
    for remain in (1, 16000, 3 * 16000, 10 * 16000, 20 * 16000, 30 * 16000):
        for override in (None, 0, -1, 30, 320, 5000):
            assert mine._window_ctx(remain, override) == theirs._window_ctx(remain, override)
