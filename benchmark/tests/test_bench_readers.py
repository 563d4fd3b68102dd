"""The traced slice counts exactly the calls its trace holds, and the
readers of the window read every request sent in it."""

from __future__ import annotations

import json
import types
from collections import Counter

from benchmark import devtrace, harness


class _Counter:
    """A ``probe.KernelTap`` stand-in: counts a call only while active."""

    def __init__(self):
        self.active = False
        self.calls = Counter()

    def call(self, key):
        if self.active:
            self.calls[key] += 1

    def take(self):
        out, self.calls = self.calls, Counter()
        return out


K2 = ("sstw_flash_attention", (20, 1500, 1500))


def _fake_recorder(monkeypatch, counter):
    """The port's recorder with CUPTI left out: ``record`` starts, runs
    three K2 calls that the trace holds, stops, and writes their records;
    a call comes before the start, and two while it writes."""
    from sentiric_stt_whisper_service_tpu_torch.serving import device_trace

    lib = types.SimpleNamespace(sstw_trace_start=lambda: 0, sstw_trace_stop=lambda: 0)

    def record(seconds, path):
        counter.call(K2)
        assert lib.sstw_trace_start() == 0
        for _ in range(3):
            counter.call(K2)
        assert lib.sstw_trace_stop() == 0
        events = [{"name": "flash_attention_kernel", "pid": 0, "tid": 7,
                   "ts": 1000.0 + 10 * i, "dur": 5.0} for i in range(3)]
        counter.call(K2)
        with open(path, "w") as f:
            f.write("{\"traceEvents\": [\n")
            f.write(",\n".join(", ".join(f"\"{k}\": {json.dumps(v)}" for k, v in e.items())
                               .join("{}") for e in events))
            f.write("\n]}\n")
        counter.call(K2)
        return types.SimpleNamespace(dropped=0)

    monkeypatch.setattr(device_trace, "lib", lambda: lib)
    monkeypatch.setattr(device_trace, "record", record)
    return lib


def test_a_slice_counts_only_the_calls_its_trace_holds(monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    counter = _Counter()
    lib = _fake_recorder(monkeypatch, counter)
    start, stop = lib.sstw_trace_start, lib.sstw_trace_stop
    s = devtrace.Slice(0.0, 1.0, counter)
    s.join(timeout=10.0)
    assert s.error is None
    assert s.result.calls == {K2: 3}
    assert devtrace.call_record_counts(s.result) == {"K2": (3, 3)}
    assert s.result.records == 3 and abs(s.result.busy_s - 15e-6) < 1e-9
    assert (lib.sstw_trace_start, lib.sstw_trace_stop) == (start, stop)
    assert not counter.active and not list(tmp_path.iterdir())


def _record(sent, done, error=None):
    clip = types.SimpleNamespace(pcm=types.SimpleNamespace(size=16000 * 8), rate=16000)
    return harness.Record(clip, sent=sent, done=done, error=error)


def test_the_tail_counts_the_requests_under_way_at_the_close():
    """Ten requests sent in a 10 s window: eight back inside it in 1 s,
    one back 9 s after its send (past the close), one refused. The 90th
    percentile reads the late one, not only those back inside."""
    recs = [_record(float(i), i + 1.0) for i in range(8)]
    recs += [_record(8.0, 17.0), _record(9.0, 9.5, error="EngineBusyException: full")]
    done = [r for r in recs if r.error is None and r.done <= 10.0]
    view = harness.View({}, {}, 10.0, 1.0, recs, done, None, 0.0)
    p90 = harness.reader("request_p90_ms").read(view)
    assert p90 == harness.percentile([1000.0] * 8 + [9000.0], 90) and p90 > 1000.0
