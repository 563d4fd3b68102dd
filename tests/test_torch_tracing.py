"""The port's tracer (``tracing.py``) and its join with the device trace
(``serving/device_trace.py``), on the CPU: off, a span site makes no
object and reads no clock; on, spans nest, request ids cross into the
batcher's and the gang's workers, the buffer drops past its cap and the
stage spans last what ``stages_ms`` adds; the join's idle attribution
(its unseen and "no program work" remainders) on synthetic kernels and
spans; the clock's points from marker kernels and the check that decides
whether the join is trusted; the batcher's live slots and the gang's
members; the host spans and counters in a Chrome trace leave the
benchmark's parse as it was; and the readers of the benchmark's per-layer
metrics. Two card
tests (``cuda``) hold a host span around a synchronised kernel to that
kernel's record, and the program's keyed kernel calls to the benchmark's
``KernelTap``."""

import json
import sys
import threading
import types
from decimal import Decimal
from pathlib import Path

import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu_torch import kernels, tracing
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import TokenIds, build_suppress_mask, whisper
from sentiric_stt_whisper_service_tpu_torch.models.graphs import DeviceLock
from sentiric_stt_whisper_service_tpu_torch.ops import N_SAMPLES
from sentiric_stt_whisper_service_tpu_torch.runtime import (
    PerformanceMetrics,
    RequestOptions,
    SttEngine,
)
from sentiric_stt_whisper_service_tpu_torch.runtime.batcher import ContinuousBatcher
from sentiric_stt_whisper_service_tpu_torch.runtime.gang import BeamGang, GangKey
from sentiric_stt_whisper_service_tpu_torch.serving import device_trace
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CFG = whisper.config_for("test", dtype=torch.float32)
RELAXED = dict(enable_vad=False, beam_size=1, quality_gate="off", logprob_threshold=-1e9,
               no_speech_threshold=1.0, min_segment_avg_prob=0.0, compute_type="float32",
               language="en", request_queue_timeout_ms=600_000)
TIMEOUT = 300


@pytest.fixture(autouse=True)
def tracer_off():
    """Every case starts and ends with the tracer off."""
    if tracing.on:
        tracing.stop()
    yield
    if tracing.on:
        tracing.stop()


@pytest.fixture(scope="module")
def model():
    g = torch.Generator()
    g.manual_seed(0)
    return whisper.init_params(CFG, g)


@pytest.fixture(scope="module")
def engine(model):
    eng = SttEngine(Settings(device="cpu", parallel_requests=3, fused_idle_fastpath=False,
                             **RELAXED), model_name="test", params=model)
    yield eng
    eng.shutdown()


def speech(seed: int, seconds: float = 2.0, rate: int = 16000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * rate)) * 3000).astype(np.int16)


def serve_three(engine) -> list:
    """A greedy request at 8 kHz, a greedy one at 16 kHz and a beam-3 one,
    in three threads at once (the batcher and the gang); their metrics."""
    metrics = [PerformanceMetrics() for _ in range(3)]
    jobs = [(speech(1, rate=8000), 8000, RequestOptions(max_decode_tokens=16)),
            (speech(2), 16000, RequestOptions(max_decode_tokens=16)),
            (speech(3), 16000, RequestOptions(max_decode_tokens=16, beam_size=3))]
    errors = []

    def run(i):
        try:
            engine.transcribe_pcm16(*jobs[i], metrics[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), name=f"request-{i}") for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIMEOUT)
    assert not errors, errors
    return metrics


# ----------------------------------------------------------------------
# Off
# ----------------------------------------------------------------------

def test_off_span_sites_make_no_object_and_read_no_clock(engine, monkeypatch):
    """With the tracer off, three requests through the batcher, the gang and
    the engine's own stages, a named ``DeviceLock``, an ``eager`` gate and a
    kernel call read the tracer's clock never and make no span, session or
    key."""
    reads = []
    monkeypatch.setattr(tracing, "perf_counter_ns", lambda: reads.append(1) or 0)

    def refused(*args, **kwargs):
        raise AssertionError("made while the tracer is off")

    monkeypatch.setattr(tracing, "Span", refused)
    monkeypatch.setattr(tracing, "Session", refused)
    monkeypatch.setattr(kernels, "work_key", refused)
    serve_three(engine)
    lock = DeviceLock("device")
    with lock.shared():
        pass
    with lock.exclusive():
        pass
    with tracing.Gate(threading.Lock(), "eager"):
        pass
    monkeypatch.setattr(kernels, "lib",
                        lambda: types.SimpleNamespace(sstw_flash_attention=lambda *a: 0))
    kernels.call("sstw_flash_attention", 0, 0, 0, 0, 1, 2, 3, 0)
    assert reads == [] and not tracing.on


def test_kernel_calls_keyed_on_collected_in_a_capture(monkeypatch):
    """``kernels.call`` keys a call by (function, its int arguments) into the
    session while the tracer is on; inside ``kernels.collecting`` (a graph
    capture) the call goes to the capture's list instead, on or off."""
    monkeypatch.setattr(kernels, "lib", lambda: types.SimpleNamespace(
        sstw_flash_attention=lambda *a: 0, sstw_decode_attention_bf16=lambda *a: 0))
    kernels.call("sstw_flash_attention", 0, 0, 0, 0, 40, 1500, 1500, 0)  # off: nowhere
    with kernels.collecting() as keyed:
        kernels.call("sstw_flash_attention", 0, 0, 0, 0, 20, 1500, 1500, 0)
    sess = tracing.start()
    kernels.call("sstw_flash_attention", 0, 0, 0, 0, 40, 1500, 1500, 0)
    kernels.call("sstw_decode_attention_bf16", 0, 0, 0, None, 0, 8, 20, 1500, 0.125, 0)
    with kernels.collecting() as keyed_on:
        kernels.call("sstw_flash_attention", 0, 0, 0, 0, 40, 1500, 1500, 0)
    tracing.add_calls({("sstw_flash_attention", (20, 1500, 1500)): 3})  # a replay of `keyed`
    tracing.stop()
    assert keyed == [("sstw_flash_attention", (20, 1500, 1500))]
    assert keyed_on == [("sstw_flash_attention", (40, 1500, 1500))]
    assert sess.calls == {("sstw_flash_attention", (40, 1500, 1500)): 1,
                          ("sstw_decode_attention_bf16", (8, 20, 1500, False)): 1,
                          ("sstw_flash_attention", (20, 1500, 1500)): 3}


def test_work_key_is_the_benchmarks():
    """The program's key of a kernel call is the benchmark's
    (``benchmark/probe.kernel_work_key``) for every library function."""
    from benchmark import probe

    for name, sig in kernels._SIGNATURES.items():
        args = tuple(7 + i if t is kernels._I else (None if i == 3 else 0)
                     for i, t in enumerate(sig))
        assert kernels.work_key(name, args) == probe.kernel_work_key(
            name, args, kernels._SIGNATURES), name


# ----------------------------------------------------------------------
# On
# ----------------------------------------------------------------------

def test_threads_lose_no_span_or_call():
    """Sixteen threads at once, the interpreter switching every
    microsecond, each opening and closing spans and adding keyed calls into
    one session: every span of theirs is kept, with its parent, and no call
    is lost (other threads of the process may add spans of their own)."""
    n_threads, n = 16, 800
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sess = tracing.start()
        start = threading.Barrier(n_threads)

        def work():
            start.wait(timeout=60)
            for _ in range(n):
                sp = tracing.begin("segments")
                tracing.end(tracing.begin("eager", tracing.WAIT))
                tracing.end(sp)
                tracing.add_call(("sstw_flash_attention", (20, 1500, 1500)))
                tracing.add_calls({("sstw_log_mel", (1,)): 2})

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
        tracing.stop()
    finally:
        sys.setswitchinterval(old)
    mine = {th.ident for th in threads}
    own = [sp for sp in sess.spans if sp.thread in mine]
    assert len(own) == 2 * n * n_threads and sess.dropped == 0
    outer = {sp.id: sp.thread for sp in own if sp.name == "segments"}
    assert all(outer[sp.parent] == sp.thread for sp in own if sp.name == "eager")
    assert sess.calls == {("sstw_flash_attention", (20, 1500, 1500)): n * n_threads,
                          ("sstw_log_mel", (1,)): 2 * n * n_threads}


def test_spans_nest_and_the_buffer_drops_past_its_cap(monkeypatch):
    sess = tracing.start()
    outer = tracing.begin_request()
    inner = tracing.begin("encode")
    wait = tracing.begin("eager", tracing.WAIT)
    tracing.end(wait)
    tracing.end(inner)
    tracing.count("batcher.chunk", steps=4, live=2, requests=(outer.id,))
    tracing.end(outer)
    monkeypatch.setattr(tracing, "CAP", 5)
    for _ in range(4):
        tracing.end(tracing.begin("segments"))
    still_open = tracing.begin("align")
    tracing.stop()
    tracing.end(still_open)
    by_name = {sp.name: sp for sp in sess.spans}
    assert [sp.name for sp in sess.spans] == ["eager", "encode", "request", "segments", "align"]
    assert by_name["request"].parent == 0 and by_name["request"].request == outer.id
    assert by_name["encode"].parent == outer.id and by_name["eager"].parent == inner.id
    assert {sp.request for sp in sess.spans[:3]} == {outer.id}
    assert by_name["eager"].kind == tracing.WAIT and by_name["encode"].kind == tracing.WORK
    assert sess.dropped == 3 and len(sess.spans) == 5 and len(sess.counters) == 1
    assert by_name["align"].open and by_name["align"].end == sess.stop_ns < still_open.end
    assert tracing.request_id() == 0


def test_request_ids_cross_into_the_workers_and_stages_match_spans(engine):
    """Three requests: every worker span and counter names requests that
    are request spans of the session, the greedy ones reach the batcher's
    worker and the beam one the gang's, each thread's spans nest, and each
    request's ``stages_ms`` equal the durations of its stage spans."""
    sess = tracing.start()
    metrics = serve_three(engine)
    tracing.stop()
    requests = {sp.id: sp for sp in sess.spans if sp.name == "request"}
    assert len(requests) == 3 and all(sp.role == tracing.REQUEST for sp in requests.values())
    by_id = {sp.id: sp for sp in sess.spans}
    for sp in sess.spans:
        if sp.parent:
            parent = by_id[sp.parent]
            assert parent.thread == sp.thread and parent.start <= sp.start <= sp.end <= parent.end
    workers = [sp for sp in sess.spans if sp.role == tracing.WORKER]
    assert {sp.name for sp in workers} >= {"batcher.tick", "batcher.admit", "batcher.chunk",
                                           "batcher.readback", "gang.decode"}
    served = {r for sp in workers for r in sp.attrs.get("requests", ())}
    served |= {r for c in sess.counters for r in c[5].get("requests", ())}
    assert served and served <= set(requests)
    gang = [sp for sp in workers if sp.name == "gang.decode"]
    beam_req = {sp.request for sp in sess.spans if sp.name == "decode" and sp.attrs["beam"] > 1}
    assert [r for sp in gang for r in sp.attrs["requests"]] == list(beam_req)
    chunked = {r for c in sess.counters if c[0] == "batcher.chunk" for r in c[5]["requests"]}
    greedy = {sp.request for sp in sess.spans if sp.name == "decode"
              and sp.attrs["route"] == "batcher"}
    assert len(greedy) == 2 and chunked == greedy
    for sp in sess.spans:
        if sp.name == "decode":
            a = sp.attrs
            assert a["path"] == "one" and a["windows"] == 1 and 0 < a["served"] <= a["max_len"]
            assert a["route"] != "batcher" or a["max_len"] - a["prompt"] == 16
    stage_sums = []
    for rid in requests:
        sums = {}
        for sp in sess.spans:
            if sp.request == rid and sp.role == tracing.REQUEST and sp.name in (
                    "detect", "encode", "decode", "align", "prosody"):
                sums[sp.name] = sums.get(sp.name, 0.0) + (sp.end - sp.start) * 1e-6
        stage_sums.append(sums)
    for m in metrics:
        match = [s for s in stage_sums if s.keys() == m.stages_ms.keys()
                 and all(s[k] == pytest.approx(v, rel=1e-12, abs=1e-9)
                         for k, v in m.stages_ms.items())]
        assert len(match) == 1, (m.stages_ms, stage_sums)


# ----------------------------------------------------------------------
# The join
# ----------------------------------------------------------------------

def _span(thread, start, end, name="x", kind=tracing.WORK, role=tracing.REQUEST):
    return types.SimpleNamespace(thread=thread, start=start, end=end, name=name, kind=kind,
                                 role=role)


def test_join_splits_idle_evenly_among_threads_in_work():
    """Kernels busy [0,10) and [40,50), [20,30) and [90,100): idle [10,20),
    [30,40), [50,90). A worker in ``tick`` over [0,60) with an inner wait
    [15,35); a request in ``align`` over [12,55) and ``prosody`` [70,80);
    a wait span on a third thread changes nothing."""
    starts = np.array([0, 40, 20, 90], np.int64)
    ends = np.array([10, 50, 30, 100], np.int64)
    spans = [_span(1, 0, 60, "batcher.tick", role=tracing.WORKER),
             _span(1, 15, 35, "to_host", tracing.WAIT, tracing.WORKER),
             _span(2, 12, 55, "align"), _span(2, 70, 80, "prosody"),
             _span(3, 0, 100, "queue", tracing.WAIT)]
    got = tracing.attribute_idle(starts, ends, spans)
    ns = 1e-9
    # worker alone [10,12) + [35,40)... idle pieces: [10,12) w only (2); [12,15) w+r (3, split);
    # [15,20) r only (5); [30,35) r only (5); [35,40) w+r (5, split); [50,55) w+r (5, split);
    # [55,60) w only (5); [60,70) none (10); [70,80) r (10); [80,90) none (10).
    worker = 2 + 1.5 + 2.5 + 2.5 + 5
    request = 1.5 + 5 + 5 + 2.5 + 2.5 + 10
    assert got["window_s"] == pytest.approx(100 * ns)
    assert got["idle_s"] == pytest.approx(60 * ns)
    assert got["by_role"][tracing.WORKER] == pytest.approx(worker * ns)
    assert got["by_role"][tracing.REQUEST] == pytest.approx(request * ns)
    assert got["by_span"] == pytest.approx({"worker/batcher.tick": worker * ns,
                                            "request/align": (request - 10) * ns,
                                            "request/prosody": 10 * ns})
    assert got["no_program_work_s"] == pytest.approx(20 * ns) and got["unseen_s"] == 0


def test_join_puts_idle_before_a_threads_first_span_down_as_unseen():
    """Kernels busy [0,10) and [90,100): idle [10,90). A worker in
    ``tick`` over [20,40); a request thread whose first span (``align``)
    begins at 60, as if it were inside a span begun before the tracer: its
    time before 60 is unseen where no thread works ([10,20), [40,60)), and
    [80,90), after its ``align``, is no program work."""
    starts, ends = np.array([0, 90], np.int64), np.array([10, 100], np.int64)
    spans = [_span(1, 20, 40, "gang.decode", role=tracing.WORKER), _span(2, 60, 80, "align")]
    got = tracing.attribute_idle(starts, ends, spans)
    ns = 1e-9
    assert got["by_role"] == pytest.approx({tracing.WORKER: 20 * ns, tracing.REQUEST: 20 * ns})
    assert got["unseen_s"] == pytest.approx(30 * ns)
    assert got["no_program_work_s"] == pytest.approx(10 * ns)


def test_join_with_nothing_idle_or_no_spans():
    starts, ends = np.array([0, 5], np.int64), np.array([6, 9], np.int64)
    got = tracing.attribute_idle(starts, ends, [_span(1, 0, 9)])
    assert got["idle_s"] == 0 and got["by_role"] == {} and got["no_program_work_s"] == 0
    got = tracing.attribute_idle(np.array([0, 20]), np.array([10, 30]), [])
    assert got["idle_s"] == pytest.approx(10e-9) == got["no_program_work_s"]
    assert tracing.attribute_idle(np.zeros(0), np.zeros(0), [])["window_s"] == 0


def _stats(sess, points, starts, ends, groups=2):
    return device_trace.TraceStats(session=sess, clock=points, groups=groups,
                                   starts=np.array(starts, np.int64),
                                   ends=np.array(ends, np.int64))


def test_summary_moves_spans_onto_the_records_clock():
    """``TraceStats.summary`` moves host spans along the clock's points: a
    work span at host [100, 200) with offset 1000 at host 0 and 1010 at
    host 1000 lies at [1101, 1202) of the records' clock."""
    sess = tracing.Session()
    sp = tracing.Span(1, 0, "prosody", tracing.WORK, 7, tracing.REQUEST, 1, 100, sess)
    sp.end = 200
    sess.spans.append(sp)
    stats = _stats(sess, ((0, 1000, 4, 0), (1000, 1010, 6, 1)), [1000, 1300], [1050, 1400])
    assert (stats.offset_ns, stats.drift_ns, stats.bracket_ns) == (1000, 10, 6)
    assert stats.device_ns(100) == 1101 and stats.device_ns(200) == 1202
    assert stats.device_ns(np.array([-50, 2000])).tolist() == [950, 3010]
    s = stats.summary()
    assert s["clock"]["ok"] and s["clock"]["step_ns"] == 10
    assert s["idle"]["idle_s"] == pytest.approx(250e-9)
    assert s["idle"]["by_role"] == {tracing.REQUEST: pytest.approx(101e-9)}
    assert device_trace.TraceStats().summary() == {}
    assert "no host spans" in device_trace.describe(device_trace.TraceStats())
    assert "requests" in device_trace.describe(stats) and "clock trusted" in (
        device_trace.describe(stats))


def test_clock_points_take_each_groups_tightest_marker():
    """A marker's record lies between the host's reads around its launch:
    offsets in [end - after, start - before]. Per group the narrowest; a
    record longer than its bracket (no offset fits) is skipped."""
    rows = [(0, 100, 160, 1130, 1140),   # offsets [980, 1030]
            (0, 200, 230, 1215, 1222),   # [992, 1015]: the tightest
            (1, 5000, 5040, 6100, 6120),  # [1080, 1100]
            (1, 6000, 6010, 7000, 7050)]  # longer than its bracket
    assert device_trace.clock_points(rows) == ((215, 1003, 12, 0), (5020, 1090, 10, 1))


@pytest.mark.parametrize("fault", ["no points", "a wide point", "no stop point",
                                   "a late record"])
def test_an_untrusted_clock_joins_nothing(fault):
    """The join reads nothing (``idle`` None, ``describe`` says so) without
    the start's and the stop's points, with a point wider than
    ``BRACKET_MAX_NS``, or where a record that began before a stage's
    synchronise ends after the stage's span; the counters still read."""
    sess = tracing.Session()
    sp = tracing.Span(1, 0, "align", tracing.WORK, 7, tracing.REQUEST, 1, 10_000, sess)
    sp.end, sp.attrs = 20_000, {"sync": 19_000}
    sess.spans.append(sp)
    sess.slice_ns = (0, 50_000)
    points = ((0, 0, 10, 0), (30_000, 0, 10, 2))
    ends = [15_000, 20_000, 40_000]
    if fault == "no points":
        points = ()
    elif fault == "a wide point":
        points = ((0, 0, device_trace.BRACKET_MAX_NS + 1, 0), points[1])
    elif fault == "no stop point":
        points = points[:1] + ((15_000, 0, 10, 1),)
    else:
        ends[1] = 20_500  # began at 18,000, before the synchronise at 19,000
    stats = _stats(sess, points, [5_000, 18_000, 25_000], ends, groups=3)
    s = stats.summary()
    assert not s["clock"]["ok"] and s["idle"] is None and s["counters"]["request_threads"] == 1
    assert "NOT trusted" in device_trace.describe(stats)
    assert s["clock"]["sync_late"] == (fault == "a late record")
    assert _stats(sess, ((0, 0, 10, 0), (30_000, 0, 10, 2)), [5_000, 18_000, 25_000],
                  [15_000, 20_000, 40_000], groups=3).summary()["clock"]["ok"]


# ----------------------------------------------------------------------
# The batcher's live slots and the gang's members
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def parts(model):
    tok = fallback_tokenizer()
    ids = TokenIds.from_tokenizer(tok)
    sup = torch.from_numpy(build_suppress_mask(CFG.n_vocab, ids, ()))
    return model, ids, sup, list(tok.sot_sequence("en"))


def test_batcher_live_slots_and_admissions(parts):
    """A stopped CPU batcher (3 slots, ``graph=False``) driven tick by tick:
    two requests submitted inside one request span, then a third, counted
    per chunk as the slots that hold a request."""
    model, ids, sup, sot = parts
    pool = ContinuousBatcher(CFG, model, ids, sup, max_slots=3, graph=False)
    pool._stop.set()
    pool._wake.set()
    pool._thread.join(timeout=10)
    rng = np.random.default_rng(4)
    window = lambda: (rng.standard_normal(N_SAMPLES) * 0.05).astype(np.float32)  # noqa: E731
    sess = tracing.start()
    req = tracing.begin_request()
    futs = [pool.submit(window(), sot, 0, max_tokens=12) for _ in range(2)]
    tracing.end(req)
    expected, steps = [], pool.steps_per_sync
    for tick in range(40):
        if tick == 1:
            futs.append(pool.submit(window(), sot, 0, max_tokens=12))
        live = sum(r is not None for r in pool._slot_req) + (
            min(pool._queue.qsize(), sum(r is None for r in pool._slot_req)))
        before = len(sess.counters)
        pool._worker_tick()
        if any(c[0] == "batcher.chunk" for c in sess.counters[before:]):
            expected.append(live)
        if all(f.done() for f in futs):
            break
    tracing.stop()
    pool.shutdown()
    assert all(f.result(timeout=1) is not None for f in futs)
    chunks = [c for c in sess.counters if c[0] == "batcher.chunk"]
    assert [c[5]["live"] for c in chunks] == expected and expected[0] == 2
    admits = [c[5] for c in sess.counters if c[0] == "batcher.admit"]
    assert [a["admitted"] for a in admits] == [2, 1]
    assert admits[0]["requests"] == (req.id, req.id) and admits[1]["requests"] == (0,)
    got = tracing.counters_of(sess)
    assert got["live_slots"] == pytest.approx(sum(expected) / len(expected))
    assert got["batcher_steps"] == steps * len(expected) and got["batcher_admitted"] == 3


def test_gang_members_counted_per_decode(parts):
    """Gangs formed with the members queued before the worker collects
    (the CPU gang tests' way): three, then one, real windows; the bucket of
    the first is four."""
    model, ids, sup, sot = parts
    gang = BeamGang(CFG, model, ids, sup, window_ms=0, max_gang=4)
    gang._stop.set()
    gang._q.put(None)
    gang._worker.join(timeout=10)
    mel = np.random.default_rng(5).standard_normal((1, 96, CFG.n_mels)).astype(np.float32)
    with torch.inference_mode():
        xa = whisper.precompute_xa_kv(CFG, model,
                                      whisper.encoder_apply(CFG, model, torch.from_numpy(mel)))
    row = np.full((CFG.n_text_ctx,), ids.eot, np.int64)
    row[: len(sot)] = sot
    key = GangKey(sample_begin=len(sot), sot_index=0, beam_size=2, max_len=len(sot) + 6,
                  prefill_len=8, xa_f=xa["k"].shape[-1], use_timestamps=True)
    sess = tracing.start()
    for n in (3, 1):
        futs = [gang.submit(xa, row, key) for _ in range(n)]
        gang._q.put(None)
        gang._stop.clear()
        gang._run()
        assert all(f.result(timeout=1) is not None for f in futs)
    tracing.stop()
    decodes = [sp.attrs for sp in sess.spans if sp.name == "gang.decode"]
    assert [(a["members"], a["bucket"], a["max_len"]) for a in decodes] == [
        (3, 4, key.max_len), (1, 1, key.max_len)]
    counted = [c[5] for c in sess.counters if c[0] == "gang.decode"]
    assert counted == [dict(members=3, bucket=4), dict(members=1, bucket=1)]
    got = tracing.counters_of(sess)
    assert got["gang_members"] == 2.0 and got["gang_decodes"] == 2
    assert {sp.role for sp in sess.spans if sp.name.startswith("gang.")} == {tracing.WORKER}
    gang.shutdown()


# ----------------------------------------------------------------------
# The device trace's file and the benchmark's readers
# ----------------------------------------------------------------------

KERNEL_LINE = ('{{"ph": "X", "cat": "kernel", "name": "{name}", "pid": 0, "tid": 7, '
               '"ts": {ts}, "dur": {dur}, "args": {{"correlation": 1, "grid": [1, 1, 1], '
               '"block": [32, 1, 1]}}}}')


def _kernel_trace(path: Path) -> None:
    """A Chrome trace written as the recorder writes its kernel records."""
    lines = [KERNEL_LINE.format(name=n, ts=ts, dur=d) for n, ts, d in (
        ("void flash_attention_kernel<64>(Params)", "1000.000", "5.500"),
        ("decode_attention_kernel", "1010.250", "2.000"),
        ("decode_attention_kernel", "1020.000", "1.125"))]
    path.write_text('{"displayTimeUnit": "ms", "traceEvents": [\n' + ",\n".join(lines)
                    + "\n]}\n")


def test_host_spans_leave_the_benchmarks_parse_unchanged(tmp_path):
    from benchmark import devtrace

    plain, spanned = tmp_path / "plain.json", tmp_path / "spanned.json"
    _kernel_trace(plain)
    _kernel_trace(spanned)
    sess = tracing.Session()
    for i, (name, kind) in enumerate((("request", tracing.WORK), ("eager", tracing.WAIT))):
        sp = tracing.Span(i + 1, i, name, kind, 11 + i, tracing.REQUEST, 1, 999_000 + i, sess)
        sp.end, sp.attrs = 1_021_000, {"requests": (1, 2)}
        sess.spans.append(sp)
    sess.threads = {11: "request-0", 12: "request-1"}
    sess.counters = [("batcher.admit", 1_000_500, 13, tracing.WORKER, 0,
                      dict(admitted=2, requests=(1, 2)))]
    stats = device_trace.TraceStats(session=sess, clock=((0, 0, 1, 0), (1, 0, 1, 1)))
    assert device_trace._write_host_spans(str(spanned), stats, 3) == 2
    events = json.loads(spanned.read_text())["traceEvents"]
    host = [e for e in events if e["pid"] == device_trace.HOST_PID]
    assert len(events) == 3 + len(host) and len(host) == 2 + 1 + 4  # process, 3 threads
    spans = [e for e in host if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["request", "eager"] and spans[0]["ts"] == 999.0
    counter = [e for e in host if e["ph"] == "i"]
    assert counter == [{"ph": "i", "s": "t", "cat": "counter", "ts": 1000.5,
                        "pid": device_trace.HOST_PID, "tid": 3, "name": "batcher.admit",
                        "args": {"request": 0, "admitted": 2, "requests": [1, 2]}}]
    a = devtrace.parse(str(plain), 0.0, 1.0, {}, 0)
    b = devtrace.parse(str(spanned), 0.0, 1.0, {}, 0)
    assert a == b and a.records == 3


def test_device_trace_turns_the_tracer_on_around_the_recorder(monkeypatch, tmp_path):
    """``record`` with a stubbed recorder: the tracer is on through a
    lead-in before the start's call, at every group of markers between
    (called with graph launches held back) and at the stop's, off after;
    the start and the stop are called through the loaded library's
    attributes (as the benchmark wraps them); the markers' points, the
    records' times and the recording's host interval come back in the
    stats, and ``last()`` returns them."""
    import ctypes
    import time

    from sentiric_stt_whisper_service_tpu_torch.models.graphs import GRAPH_LAUNCHES

    calls = []

    class Recorder:
        def sstw_trace_device(self, ordinal):
            calls.append(("device", ordinal))

        def sstw_trace_start(self):
            calls.append(("start", tracing.on, time.perf_counter() - began))
            return 0

        def sstw_trace_mark(self):
            calls.append(("mark", tracing.on, GRAPH_LAUNCHES._writer == threading.get_ident()))
            return 0

        def sstw_trace_stop(self):
            calls.append(("stop", tracing.on))
            return 0

        def sstw_trace_write(self, path):
            Path(path.decode()).write_text('{"traceEvents": []}')
            return 0

        def sstw_trace_counts(self, out):
            out[0], out[1], out[2], out[3] = 2, 0, 0, 1

        def sstw_trace_marks(self, out, cap):
            stop = sum(c[0] == "mark" for c in calls) + 1
            rows = [(0, 10, 30, 510, 515), (0, 12, 40, 530, 531),
                    (stop, 2_000_000_000, 2_000_000_020, 2_000_000_530, 2_000_000_535)]
            for r, row in enumerate(rows):
                for k, v in enumerate(row):
                    out[5 * r + k] = v
            return len(rows)

        def sstw_trace_copy(self, starts, ends, cap):
            s = (ctypes.c_uint64 * 2).from_address(starts)
            e = (ctypes.c_uint64 * 2).from_address(ends)
            s[0], e[0], s[1], e[1] = 100, 200, 300, 400
            return 2

    loaded = Recorder()
    start, stop = loaded.sstw_trace_start, loaded.sstw_trace_stop
    wrapped = []
    loaded.sstw_trace_start = lambda: wrapped.append("start") or start()
    loaded.sstw_trace_stop = lambda: wrapped.append("stop") or stop()
    monkeypatch.setattr(device_trace, "lib", lambda: loaded)
    monkeypatch.setattr(device_trace, "LEAD_IN_S", 0.05)
    monkeypatch.setattr(device_trace, "MARK_EVERY_S", 0.02)
    began = time.perf_counter()
    stats = device_trace.record(0.1, str(tmp_path / "trace.json"))
    assert calls[0] == ("device", 0) and calls[1][:2] == ("start", True) and calls[1][2] >= 0.05
    marks = calls[2:-1]
    assert len(marks) >= 2 and set(marks) == {("mark", True, True)}
    assert calls[-1] == ("stop", True) and wrapped == ["start", "stop"]
    assert not tracing.on and device_trace.last() is stats and stats.groups == len(marks) + 2
    # offsets [485, 500] and [491, 518] at the start (the first the tighter),
    # [515, 530] at the stop: 492 ± 8, then 522 ± 8
    assert (stats.offset_ns, stats.drift_ns, stats.bracket_ns) == (492, 30, 8)
    assert stats.starts.tolist() == [100, 300] and stats.ends.tolist() == [200, 400]
    lo, hi = stats.session.slice_ns
    assert stats.session.start_ns < lo < hi <= stats.session.stop_ns
    assert hi - lo >= 0.1e9
    s = stats.summary()
    assert s["clock"]["ok"] and s["idle"]["idle_s"] == pytest.approx(100e-9)


METRICS = ("idle_pct.workers", "idle_pct.requests", "idle_pct.requests.recordings",
           "live_slots", "gang_members", "eager_wait_ms")


@pytest.mark.parametrize("name", METRICS)
def test_readers_without_a_session(name, monkeypatch):
    from benchmark import harness

    read = harness.reader(name).read
    view = types.SimpleNamespace(trace=None)
    assert read(view) is None
    view = types.SimpleNamespace(trace=types.SimpleNamespace(window_s=2.0, busy_s=1.0))
    monkeypatch.setattr(device_trace, "_last", None)
    assert read(view) is None
    monkeypatch.setattr(device_trace, "_last", device_trace.TraceStats(session=tracing.Session()))
    assert read(view) is None  # a session without spans
    monkeypatch.delattr(device_trace, "last")  # a port without the tracer
    assert read(view) is None


@pytest.mark.parametrize("name,want", [
    ("idle_pct.workers", 49.0 * 0.3), ("idle_pct.requests", 49.0 * 0.5),
    ("idle_pct.requests.recordings", 49.0 * 0.5), ("live_slots", 5.5),
    ("gang_members", 2.5), ("eager_wait_ms", 375.0)])
def test_readers_read_a_session(name, want, monkeypatch):
    """A synthetic session: a worker span and a request span over idle
    stretches, two batcher chunks (4 steps at 5 live, 4 at 6), two gang
    decodes (2 and 3 members), two ``eager`` waits (200 and 400 ms) and one
    still waiting at the stop (900 ms so far), each on a request thread of
    its own: with the ``prosody`` thread, 1,500 ms over four request threads.
    The kernels leave 1 s of 2 idle; the trace file's parse reads
    ``idle_pct`` 49 % (its rounded times), and the roles' shares are the
    join's parts of it: 0.3 and 0.5 of 49 (the request thread's 0.1 s
    before its first span is unseen)."""
    from benchmark import harness

    sess = tracing.Session()

    def add(name, start, end, kind=tracing.WORK, role=tracing.REQUEST, open_=False, **attrs):
        sp = tracing.Span(len(sess.spans) + 1, 0, name, kind, len(sess.spans) + 1, role, 0,
                          start, sess)
        sp.end, sp.open, sp.attrs = end, open_, attrs
        sess.spans.append(sp)

    # kernels busy [0, 0.5 s) and [1.5 s, 2 s): idle [0.5 s, 1.5 s)
    add("batcher.tick", 500_000_000, 800_000_000, role=tracing.WORKER)
    add("prosody", 900_000_000, 1_400_000_000)
    add("eager", 0, 200_000_000, tracing.WAIT)
    add("eager", 0, 400_000_000, tracing.WAIT)
    add("eager", 0, 900_000_000, tracing.WAIT, open_=True)
    sess.slice_ns = (0, 2_000_000_000)
    sess.counters = [("batcher.chunk", 0, 1, tracing.WORKER, 0, dict(steps=4, live=5)),
                     ("batcher.chunk", 0, 1, tracing.WORKER, 0, dict(steps=4, live=6)),
                     ("gang.decode", 0, 2, tracing.WORKER, 0, dict(members=2, bucket=2)),
                     ("gang.decode", 0, 2, tracing.WORKER, 0, dict(members=3, bucket=4))]
    stats = _stats(sess, ((0, 0, 1, 0), (1, 0, 1, 1)), [0, 1_500_000_000],
                   [500_000_000, 2_000_000_000])
    monkeypatch.setattr(device_trace, "_last", stats)
    view = types.SimpleNamespace(trace=types.SimpleNamespace(window_s=2.0, busy_s=1.02))
    assert harness.reader(name).read(view) == pytest.approx(want)
    idle = 100 * (1 - view.trace.busy_s / view.trace.window_s)
    workers = harness.reader("idle_pct.workers").read(view)
    assert workers + harness.reader("idle_pct.requests").read(view) <= idle


@pytest.mark.parametrize("name", METRICS[:3])
def test_idle_readers_read_nothing_on_an_untrusted_clock(name, monkeypatch):
    """The idle shares read None where the clock is not trusted (no
    points), a session with spans notwithstanding."""
    from benchmark import harness

    sess = tracing.Session()
    sp = tracing.Span(1, 0, "align", tracing.WORK, 7, tracing.REQUEST, 1, 0, sess)
    sp.end = 1_000
    sess.spans.append(sp)
    monkeypatch.setattr(device_trace, "_last", _stats(sess, (), [0, 900], [100, 1_000]))
    view = types.SimpleNamespace(trace=types.SimpleNamespace(window_s=1e-6, busy_s=2e-7))
    assert harness.reader(name).read(view) is None


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_host_span_encloses_its_synchronised_kernel(tmp_path):
    """While the recorder records, between two of its groups of marker
    kernels, a host span around one spin kernel and a synchronise: on the
    records' clock (the markers' points) the span encloses the kernel's
    record, within the points' half bracket; the clock is trusted; the
    markers leave no record among the kernels; and the Chrome trace holds
    the span in its host process."""
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    device_trace.lib()
    path = tmp_path / "trace.json"
    out = []
    tracer = threading.Thread(target=lambda: out.append(device_trace.record(3.5, str(path))))
    tracer.start()
    time.sleep(device_trace.LEAD_IN_S + 1.5)  # after the first group between start and stop
    sp = tracing.begin("probe")
    torch.cuda._sleep(2_000_000)
    torch.cuda.synchronize()
    tracing.end(sp)
    tracer.join(timeout=60)
    stats = out[0]
    events = json.loads(path.read_text(), parse_float=Decimal)["traceEvents"]
    spin = [e for e in events if e.get("cat") == "kernel"]
    probe = [e for e in events if e.get("cat") == "host" and e["name"] == "probe"]
    assert len(spin) == 1 and "spin_kernel" in spin[0]["name"] and len(probe) == 1, events
    k0, k1 = int(stats.starts[0]), int(stats.ends[0])  # the records' own nanoseconds
    assert k0 == int(spin[0]["ts"] * 1000) and k1 - k0 == int(spin[0]["dur"] * 1000)
    s0, s1 = stats.device_ns(sp.start), stats.device_ns(sp.end)
    b = stats.bracket_ns
    clock = stats.summary()["clock"]
    assert clock["ok"] and clock["points"] == stats.groups >= 4 and 0 <= b < 100_000, clock
    assert s0 - b <= k0 and k1 <= s1 + b, (s0, k0, k1, s1, b, stats.clock)
    assert int(probe[0]["ts"] * 1000) == s0 and int(probe[0]["dur"] * 1000) == s1 - s0


@pytest.mark.cuda
def test_keyed_calls_equal_the_benchmarks_kernel_tap(monkeypatch):
    """Over the same greedy requests on the card (a random ``tiny`` at int4,
    two at once through the batcher's graphed pool, one alone on the
    engine's own graph class), the program's keyed kernel calls equal the
    benchmark's ``KernelTap`` (installed before the engine, so that it sees
    every capture)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import probe
    from sentiric_stt_whisper_service_tpu_torch.models import graphs
    from sentiric_stt_whisper_service_tpu_torch.runtime import batcher as batcher_mod

    tap = probe.KernelTap()
    try:
        monkeypatch.setattr(batcher_mod, "_capture", graphs._capture)  # the tapped capture
        settings = Settings(device="cuda", compute_type="int4", parallel_requests=2,
                            max_batch_size=2, **{k: v for k, v in RELAXED.items()
                                                 if k != "compute_type"})
        eng = SttEngine(settings, model_name="tiny", random_init=True)
        try:
            tap.active = True
            sess = tracing.start()
            threads = [threading.Thread(target=eng.transcribe_pcm16, args=(
                speech(i, seconds=4.0), 16000, RequestOptions(max_decode_tokens=16)))
                for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=TIMEOUT)
            eng.transcribe_pcm16(speech(7, seconds=4.0), 16000,
                                 RequestOptions(max_decode_tokens=16))
            tracing.stop()
            tap.active = False
        finally:
            eng.shutdown()
        counted = dict(tap.take())
        assert counted and sess.calls == counted
    finally:
        tap.remove()
