"""Streaming transcription sessions, held against the JAX package's
``runtime/streaming.py``.

The reference service's streaming protocol re-decodes the whole
accumulated buffer every 500 ms and finalizes only on EOS (an empty chunk)
or at the 30 s cap. :class:`StreamingSession` keeps that wire protocol
(partials, finals, EOS on an empty chunk, the 30 s force-final) and, as
the JAX package, an opt-in **incremental mode**: segments that decode
identically in two consecutive partial passes and end safely before the
buffer head are committed as finals at once, the buffer is trimmed to the
commit point, and the committed text is carried as the decoder prompt, so
a tick's work stays bounded by the uncommitted tail.

A session has no thread of its own: ``feed`` runs its tick in the
caller's thread, on the engine's device, through ``transcribe_pcm16``.
Several sessions may share one engine (at ``parallel_requests`` > 1 their
greedy ticks ride the engine's continuous batcher) and one
``RequestOptions``: a session pins its detected language on a copy.
``SttEngine.warmup()`` captures every graph class a tick can reach under
the engine's settings (``_warmup_tick_classes``), so no tick and no EOS
finalize captures one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..config import Settings
from ..native import StreamBuffer
from .engine import RequestOptions, SttEngine, TranscriptionResult

MAX_BUFFER_SAMPLES = 16000 * 30  # the reference's hard cap
COMMIT_GUARD_CS = 100  # no commit of a segment ending within 1 s of the head
# Partial-tick decode budget: sampled tokens per second of buffered audio
# (about 3x real speech density, so genuine content never truncates) plus a
# timestamp/segment margin; the engine rounds it up to TOKEN_CAP_BUCKETS.
TICK_TOKENS_PER_SECOND = 14
TICK_CAP_MIN = 32
TICK_CAP_MAX = 128
# Parity-mode (non-incremental) partial ticks re-decode the whole buffer,
# so their cap saturates only at the full window budget.
PARITY_CAP_MAX = 224  # == engine.SAMPLE_LEN
# Auto-language pin: re-detect every tick until the buffer is
# LANG_PIN_MIN_S long or detection is confident, then pin the language for
# the rest of the utterance (the first second is the least reliable
# detection window).
LANG_PIN_MIN_S = 3.0
LANG_PIN_PROB = 0.8


@dataclasses.dataclass
class StreamEvent:
    result: TranscriptionResult
    is_final: bool


class StreamingSession:
    def __init__(
        self,
        engine: SttEngine,
        options: Optional[RequestOptions] = None,
        incremental: bool = False,
    ):
        self.engine = engine
        self.settings: Settings = engine.get_settings()
        self.options = options or RequestOptions()
        self.incremental = incremental
        self.buffer = StreamBuffer()
        self.last_processed = 0
        # incremental state
        self.trimmed_samples = 0  # samples dropped from the buffer front
        self.carried_text = ""
        self._prev_partial: list[tuple[str, int, int]] = []
        self._detected_lang = ""  # the pinned language of an auto stream

    # ------------------------------------------------------------------
    def feed(self, chunk: bytes) -> list[StreamEvent]:
        """Feed one wire chunk; an empty chunk is EOS (the reference's
        protocol)."""
        if len(chunk) == 0:
            return self.finalize()
        self.buffer.append(chunk)
        if self.buffer.size - self.last_processed < self.settings.stream_buffer_samples:
            return []
        return self._tick()

    def finalize(self) -> list[StreamEvent]:
        """EOS: decode what is left, emit it as finals, and reset."""
        events: list[StreamEvent] = []
        pcm = self.buffer.read()
        if pcm.size:
            for res in self._transcribe(pcm):
                if res.text:
                    events.append(StreamEvent(self._offset(res), True))
        self.buffer.clear()
        self.last_processed = 0
        self._prev_partial = []
        if self.incremental:
            self.trimmed_samples = 0
            self.carried_text = ""
        self._detected_lang = ""  # the next utterance detects anew
        return events

    # ------------------------------------------------------------------
    def _transcribe(
        self, pcm: np.ndarray, partial: bool = False
    ) -> list[TranscriptionResult]:
        # A copy: sessions sharing one RequestOptions keep their pins apart.
        opts = dataclasses.replace(
            self.options,
            prompt=self.carried_text if self.incremental else self.options.prompt,
        )
        if (self.options.language or "").strip().lower() in ("", "auto"):
            if self._detected_lang:
                opts.language = self._detected_lang
        if partial:
            dur = pcm.size / 16000.0
            # Partial ticks decode greedy even under a beam default
            # (Settings.stream_greedy_partials); finals (EOS, the 30 s cap
            # flush) keep the configured beam.
            if self.settings.stream_greedy_partials:
                eff_beam = (
                    opts.beam_size
                    if opts.beam_size > 0
                    else self.settings.beam_size
                )
                if eff_beam > 1:
                    opts.beam_size = 1
                    opts.best_of = 1
            # Bound the decode by the buffer's plausible token count:
            # incremental ticks cap at TICK_CAP_MAX (their buffer is the
            # uncommitted tail), parity ticks at the full window budget.
            opts.max_decode_tokens = min(
                TICK_CAP_MAX if self.incremental else PARITY_CAP_MAX,
                max(TICK_CAP_MIN, int(dur * TICK_TOKENS_PER_SECOND) + 8),
            )
        if partial and self.incremental:
            # Skip the DTW alignment pass unless a segment could commit
            # this tick: the previous tick's first stable segment ends at
            # least COMMIT_GUARD_CS before the head.
            buffer_cs = int(round(pcm.size / 16000.0 * 100))
            commit_candidate = bool(self._prev_partial) and (
                self._prev_partial[0][2] < buffer_cs - COMMIT_GUARD_CS
            )
            if not commit_candidate:
                opts.no_timestamps = True
        elif partial:
            # Parity-mode partials carry no word times; the 30 s cap flush
            # re-decodes at full quality for its finals.
            opts.no_timestamps = True
        return self.engine.transcribe_pcm16(pcm, 16000, opts)

    def _offset(self, res: TranscriptionResult) -> TranscriptionResult:
        if not self.incremental or self.trimmed_samples == 0:
            return res
        off = int(round(self.trimmed_samples / 16000 * 100))
        res = dataclasses.replace(res)
        res.t0 += off
        res.t1 += off
        for t in res.tokens:
            t.t0 += off
            t.t1 += off
        return res

    def _tick(self) -> list[StreamEvent]:
        events: list[StreamEvent] = []
        pcm = self.buffer.read()
        results = [r for r in self._transcribe(pcm, partial=True) if r.text]
        self.last_processed = self.buffer.size
        if not self._detected_lang:
            # Pin once detection is trustworthy: enough buffered audio or a
            # confident softmax; until then every tick detects anew.
            dur = pcm.size / 16000.0
            for r in results:
                if r.language and r.language not in ("unknown", "auto"):
                    if (
                        dur >= LANG_PIN_MIN_S
                        or r.language_probability >= LANG_PIN_PROB
                    ):
                        self._detected_lang = r.language
                    break

        if self.incremental and results:
            buffer_cs = int(round(pcm.size / 16000 * 100))
            cur = [(r.text, r.t0, r.t1) for r in results]
            commit_n = 0
            for i, sig in enumerate(cur):
                if (
                    i < len(self._prev_partial)
                    and self._prev_partial[i] == sig
                    and sig[2] < buffer_cs - COMMIT_GUARD_CS
                ):
                    commit_n = i + 1
                else:
                    break
            if commit_n:
                commit_end_cs = cur[commit_n - 1][2]
                for r in results[:commit_n]:
                    events.append(StreamEvent(self._offset(r), True))
                    self.carried_text = (
                        self.carried_text + " " + r.text
                    ).strip()[-400:]
                # Trim the buffer to the commit point.
                cut = min(int(commit_end_cs / 100 * 16000), pcm.size)
                remainder = pcm[cut:]
                self.buffer.clear()
                if remainder.size:
                    self.buffer.append(remainder.tobytes())
                self.trimmed_samples += cut
                self.last_processed = self.buffer.size
                results = results[commit_n:]
                # The remaining partials' times are relative to the
                # untrimmed buffer: shift them.
                shift = int(round(cut / 16000 * 100))
                rebased = []
                for r in results:
                    r = dataclasses.replace(r)
                    r.t0 = max(0, r.t0 - shift)
                    r.t1 = max(0, r.t1 - shift)
                    rebased.append(r)
                results = rebased
                cur = [(r.text, r.t0, r.t1) for r in results]
            self._prev_partial = cur

        # Combined partial (the reference's semantics: one message, the
        # joined text, the last segment's affective block).
        if results:
            combined = dataclasses.replace(results[-1])
            combined.text = " ".join(r.text for r in results) + " "
            events.append(StreamEvent(self._offset(combined), False))

        # 30 s cap: force-final everything.
        if self.buffer.size > MAX_BUFFER_SAMPLES:
            flushed = results
            if self._partials_downgraded():
                # The ticks decoded greedy, capped or unaligned: the finals
                # keep the configured quality, one full decode of the buffer.
                buf = self.buffer.read()
                flushed = [r for r in self._transcribe(buf) if r.text]
            for r in flushed:
                events.append(StreamEvent(self._offset(r), True))
            if self.incremental:
                self.trimmed_samples += self.buffer.size
            self.buffer.clear()
            self.last_processed = 0
            self._prev_partial = []
        return events

    def _partials_downgraded(self) -> bool:
        """True when partial ticks decode below the configured quality (a
        greedy downgrade or a skipped alignment), so the cap flush's finals
        need a full-quality pass of their own."""
        if self.settings.stream_greedy_partials:
            eff_beam = (
                self.options.beam_size
                if self.options.beam_size > 0
                else self.settings.beam_size
            )
            if eff_beam > 1:
                return True
        return not self.incremental and not self.settings.no_timestamps
