"""SttEngine: the transcription orchestrator, held against the JAX package's
``runtime/engine.py``.

Pipeline per request, as in the JAX package (the reference service's
stt_engine.cpp semantics):

  abort pre-check → resample to 16 kHz → min-duration gate → VAD gate →
  admission (bounded wait, EngineBusyException on timeout) → long-form
  windowed decode with prompt carry-over and the temperature-fallback
  ladder → per-segment post-processing (hallucination filter, 0.40
  avg-token-prob gate, centisecond timestamps, DTW token times, prosody on
  the segment slice, per-request speaker clustering).

Quality-gate semantics (whisper.cpp parity):
  * retry at next temperature when the quality gate fails — default is
    whisper.cpp's entropy form behind the reference's ``entropy_thold=2.40``:
    >32 sampled tokens whose last-32 count entropy is below 2.40
    (``Settings.quality_gate="compression_ratio"`` selects openai-whisper's
    zlib-ratio>2.4 form instead) — or when avg logprob < logprob_threshold;
  * window treated as silence when no_speech_prob > no_speech_threshold
    AND avg logprob < logprob_threshold;
  * ladder: start temperature, then +0.2 steps up to 1.0; beam search only
    at t=0, best_of sampling above.

What differs from the JAX package:

  * **Device.** ``Settings.device`` names it: "auto" / "cuda" is the CUDA
    card (construction raises without one), "cpu" the plain PyTorch
    versions. The audio, the encoder and the decode run there; the gates,
    DTW, prosody and clustering are numpy on the host, as there.
  * **Concurrent requests on the device.** Up to ``parallel_requests``
    requests are admitted through the semaphore, as in the JAX package, and
    run side by side. At ``parallel_requests`` > 1 a greedy t = 0 window
    rides the continuous batcher (``runtime/batcher.py``, one pool per
    audio_ctx bucket; a raw window is submitted as audio, so that the
    batcher's tick encodes its admissions together and hands the cross K/V
    back for the alignment pass and the ladder), and a beam t = 0 window
    the beam gang (``runtime/gang.py``); a lone greedy request (the batcher
    idle, no other request in flight) decodes on the engine's own graph
    class, the counterpart of the JAX package's fused idle fast path.
    Sampled rungs, the batched long-form path and ``parallel_requests`` = 1
    decode on the engine's own classes. ``_device_lock`` guards what has one
    owner: the engine's ``DecodeGraphs`` (whose static buffers serve one
    request at a time) and its generator. Every thread holds the engine's
    ``DeviceLock`` shared around its device work, and a graph capture holds
    it exclusively (``models/graphs.py``); everything runs on the default
    stream, so work from several threads is ordered on the card. Request
    threads run their eager stages (encode, detect, alignment) one at a
    time, and read the card through ``to_host``, which leaves the other
    threads' launches free while it waits.
  * **Encode, then decode.** The JAX package fuses mel → encoder → cross
    K/V → greedy decode into one executable for a lone greedy request;
    here the window is encoded (K1, K2, the quantized cross K/V) and then
    decoded. ``TICK_PREFILL`` pinning and ``sample_cap`` are kept: they
    give the same output and bound the number of graph classes.
  * **Random draws.** Sampled rungs draw from a ``torch.Generator`` on the
    engine's device, seeded from the clock as the JAX package seeds its key;
    the draws differ from ``jax.random``'s.
  * **Speculative decoding.** With ``draft_model`` set, the draft loads
    as the target does (its own seed under ``random_init``,
    ``ggml-{draft}.bin`` otherwise), quantized and fused the same way, and
    must share the target's encoder width: one encode of the target feeds
    both models' cross K/V. A greedy t = 0 window then decodes through
    ``models/speculative.decode_window_spec`` (the abort polled before it),
    on every request at ``parallel_requests`` = 1 and above it whenever the
    batcher of its width is idle; ``PerformanceMetrics.spec`` counts the
    request's rounds, emitted tokens and accepted drafts.
  * **A device mesh is one process per device.** The JAX engine is one
    controller: ``MESH_SHAPE`` builds the mesh over every device, shards
    the weights and GSPMD drives them all. Here each process drives one
    device (``parallel/``): every process builds the engine, which makes
    the mesh (``parallel.make_mesh``; the device is the mesh's, so two
    ranks may share a card), quantizes, then shards the weights
    (``parallel.shard_params``; decoder q/k/v stay unfused, as the JAX
    engine keeps them under a mesh). Rank 0 serves: its request threads,
    batcher and gang workers, gates, long-form loop, fallback ladder,
    prosody and clustering run as on one device, and each device stage (an
    encode, language detection, a decode, an alignment pass, a batcher
    tick, a gang decode) is one op of the replay channel
    (``parallel/replay.py``), which every other rank receives in order and
    runs on its shard in :meth:`follow` until rank 0's :meth:`close`. Rank
    0 alone decides (aborts, a window's stop, admissions) and sends its
    decisions; its clock seed for sampled rungs goes to every rank. dp
    replicates the engine's arrays, as in the JAX engine: every rank holds
    every row. Under a tp group the decode steps run eagerly (gloo's
    all-reduces run on the host, where a CUDA graph cannot capture them);
    with dp or sp alone they stay graphed. A draft is sharded like the
    target (unfused), and a speculative window is one op: its rounds run
    on every rank's shard, and rank 0 decides its abort and, at each read
    of the device, whether it goes on. Lock order on rank 0: the
    channel's order lock first, then the engine's locks inside the op
    (``_device_lock``, ``_eager``, ``DeviceLock.shared()``, a capture's
    exclusive hold), so that a capture inside an op never waits on a
    thread that waits for the channel.
  * **Refused, not hidden**: ``beam_size`` above ``config.MAX_BEAM_SIZE``
    and a draft of another encoder width raise at construction (as do, on
    a mesh, a target or a draft whose heads the tp degree does not
    divide); a request's ``beam_size`` above the limit raises.
    ``FLASH_ATTN=0`` has no effect here: the encoder's attention runs K2
    on the card (the engine says so in its log when it is built).
  * ``warmup()`` captures the decode graph classes of the configured ladder
    and of a streaming session's greedy partial ticks, and, at
    ``parallel_requests`` > 1, builds the batcher's pools (their step graphs)
    or the gang's batch buckets (the JAX package compiles its shape classes
    there).

``PerformanceMetrics.stages_ms`` splits a request's time into language
detection, encode, decode, alignment pass and prosody with clustering
(device work synchronised at each stage's end; kept per request thread; a
stage's time includes its wait for the other requests' eager stages). On
the batcher's path a window's encode runs in the batcher's admission tick
and counts in ``decode``.

While a device trace records (``serving/device_trace``), the engine's
request threads leave spans (``tracing``): one ``request`` span a
:meth:`SttEngine.transcribe`, whose id the batcher's and the gang's workers
carry for the work they do for it; the work spans ``resample``, ``vad``,
each stage of ``stages_ms`` (the stage's own clock readings: its span lasts
what it adds) and ``segments``; the wait spans ``queue`` (admission),
``eager`` (each acquisition of ``_eager``), ``device.shared`` and
``device.exclusive`` (the engine's ``DeviceLock``), ``batcher`` and
``gang`` (the wait for their result) and ``to_host``. A ``decode`` span
carries the window's route, path, prompt length, token budget
(``max_len``), beam and served tokens.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from .. import tracing
from ..audio import resample
from ..config import Settings, check_beam_size
from ..diarize import SpeakerClusterer
from ..models import (
    DecodeGraphs,
    DecodeResult,
    TokenIds,
    WhisperConfig,
    build_suppress_mask,
    config_for,
    decode_window,
    decode_window_beam,
    decode_window_best_of,
    detect_language,
    encoder_apply,
    init_params,
    precompute_xa_kv,
)
from ..models.graphs import DeviceLock, to_device, to_host
from ..models.speculative import SpecStats, decode_window_spec
from ..models.sampling import PROMPT_BUCKETS, prompt_bucket
from ..models.timestamps import (
    align_bucket,
    alignment_scores,
    times_of_scores,
    token_boundaries,
    window_scores,
)
from ..ops import N_SAMPLES, SAMPLE_RATE, compute_log_mel
from ..ops.quant import fuse_decoder_qkv, is_quantized, quantize_params
from ..parallel import Replay, make_mesh, shard_params
from ..prosody.extractor import AffectiveTags, ProsodyOptions, extract_prosody
from ..text import clean_utf8, is_hallucination
from ..tokenizer import LANGUAGES, WhisperTokenizer, fallback_tokenizer
from .batcher import ContinuousBatcher
from .gang import BeamGang, GangKey
from .vad import is_speech_detected

log = logging.getLogger(__name__)

ENTROPY_THRESHOLD = 2.4  # whisper.cpp's gate (the reference's entropy_thold)
COMPRESSION_RATIO_THRESHOLD = 2.4  # openai-whisper semantics
SAMPLE_LEN = 224  # max sampled tokens per window (whisper: n_text_ctx // 2)
# Per-request token caps (RequestOptions.max_decode_tokens) round up to one
# of these: each is its own decode graph class.
TOKEN_CAP_BUCKETS = (16, 32, 64, 128, SAMPLE_LEN)
# Fixed prefill for capped greedy decodes, so that a carried prompt of any
# length decodes in one graph class per cap (output-identical: positions in
# [sample_begin, prefill_len) are never-attended EOT padding).
TICK_PREFILL = 128

def token_cap_bucket(n: int) -> int:
    """Smallest TOKEN_CAP_BUCKETS entry ≥ n (SAMPLE_LEN for n ≤ 0)."""
    if n <= 0:
        return SAMPLE_LEN
    for b in TOKEN_CAP_BUCKETS:
        if n <= b:
            return b
    return SAMPLE_LEN


class EngineBusyException(RuntimeError):
    """All decode slots busy past the queue timeout."""


@dataclasses.dataclass
class TokenData:
    text: str
    p: float
    t0: int  # centiseconds
    t1: int


@dataclasses.dataclass
class RequestOptions:
    """Per-request overrides; -1 = use server default."""

    language: str = ""
    prompt: str = ""
    translate: bool = False
    enable_diarization: bool = False
    temperature: float = -1.0
    beam_size: int = -1
    best_of: int = -1
    prosody_opts: ProsodyOptions = dataclasses.field(default_factory=ProsodyOptions)
    should_abort: Optional[Callable[[], bool]] = None
    # Encoder audio context override (whisper.cpp's audio_ctx): None =
    # server setting; 0 = full; -1 = auto-bucket; N = fixed positions.
    audio_ctx: Optional[int] = None
    # True (default) = sequential windows with prompt carry-over (whisper
    # semantics). False = the 30 s windows decoded together in groups of
    # max_batch_size (fixed stride, no conditioning).
    condition_on_previous_text: bool = True
    # Per-window sampled-token budget; -1 = SAMPLE_LEN (224), else rounded
    # up to TOKEN_CAP_BUCKETS.
    max_decode_tokens: int = -1
    # None = Settings.no_timestamps; True skips the DTW alignment pass
    # (token times fall back to segment bounds).
    no_timestamps: Optional[bool] = None


@dataclasses.dataclass
class TranscriptionResult:
    """One segment."""

    text: str = ""
    language: str = ""
    # Detect-language max softmax prob (1.0 when pinned).
    language_probability: float = 0.0
    prob: float = 0.0
    t0: int = 0  # centiseconds
    t1: int = 0
    speaker_turn_next: bool = False
    tokens: list[TokenData] = dataclasses.field(default_factory=list)
    token_count: int = 0
    gender_proxy: str = "?"
    emotion_proxy: str = "neutral"
    arousal: float = 0.0
    valence: float = 0.0
    affective: AffectiveTags = dataclasses.field(default_factory=AffectiveTags)
    speaker_id: str = ""


@dataclasses.dataclass
class PerformanceMetrics:
    queue_time_ms: float = 0.0
    processing_time_ms: float = 0.0
    token_count: int = 0
    # Milliseconds per stage of the request on the device: "detect",
    # "encode", "decode", "align" and "prosody" (with clustering).
    stages_ms: dict = dataclasses.field(default_factory=dict)
    # Speculative decoding's counts over the request's windows: "rounds",
    # "emitted" (tokens) and "accepted" (draft tokens the target kept).
    spec: dict = dataclasses.field(default_factory=dict)


def resolve_device(name: str) -> torch.device:
    """``Settings.device`` → the engine's device: "auto" / "cuda" the CUDA
    card (raises when there is none), "cpu" the CPU."""
    key = (name or "auto").strip().lower()
    if key == "cpu":
        return torch.device("cpu")
    if key in ("auto", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name!r}: no CUDA device (torch.cuda.is_available() is false); "
                "set device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    raise ValueError(f"device={name!r}: expected 'auto', 'cuda' or 'cpu'")


def _host(res: DecodeResult) -> DecodeResult:
    """A DecodeResult's fields as numpy arrays on the host."""
    return DecodeResult(*(to_host(x).numpy() for x in res))


def _waited(fut, name: str, timeout: float):
    """``fut.result(timeout)``, a wait span ``name`` while the tracer is on."""
    with tracing.begin(name, tracing.WAIT) if tracing.on else tracing.OFF:
        return fut.result(timeout=timeout)


def _decode_attrs(span, route: str, path: str, prompt: int, max_len: int, beam: int,
                  res: DecodeResult) -> None:
    """A decode span's attributes: the window's route and path, its prompt
    length, token budget and beam, and the tokens served up to each row's
    end, the last one included (every row's, on the batched path), from the
    result on the host."""
    served = int(np.sum(np.asarray(res.lengths) - prompt))
    span.attrs.update(route=route, path=path, prompt=prompt, max_len=max_len, beam=beam,
                    windows=len(res.lengths), served=served)


def _cut_after_first_poll():
    """An abort callback that lets a decode capture its graphs and prefill,
    then stops it at its first chunk (the first poll is the one before)."""
    polls = iter((False,))
    return lambda: next(polls, True)


class SttEngine:
    """Whisper inference engine over one ``Whisper`` module on one device,
    or over a rank's shard of it on a mesh (``settings.mesh_shape``).

    Concurrency: admission is a bounded semaphore of ``parallel_requests``
    slots with a ``request_queue_timeout_ms`` wait; admitted requests share
    the device through the continuous batcher and the beam gang (see the
    module docstring)."""

    # Encoder-context classes for audio_ctx=-1 (auto): smallest bucket
    # covering the real audio; 384 ≈ 7.7 s, 768 ≈ 15.4 s, 1152 ≈ 23 s.
    AUDIO_CTX_BUCKETS = (384, 768, 1152, 1500)

    def __init__(
        self,
        settings: Settings,
        model_name: Optional[str] = None,
        params=None,
        tokenizer: Optional[WhisperTokenizer] = None,
        random_init: bool = False,
        draft_params=None,
    ):
        self.settings = settings
        name = model_name or settings.model_filename.replace("ggml-", "").replace(".bin", "")
        self.model_name = name
        check_beam_size(settings.beam_size)
        self.device = resolve_device(settings.device)
        self.mesh = None
        if settings.mesh_shape not in ("1", "", None):
            mesh = make_mesh(settings.mesh_shape, device=self.device.type)
            if mesh.device_mesh is not None:
                self.mesh, self.device = mesh, mesh.device
        # The ordered channel of device operations over the mesh's processes
        # (in place, sending nothing, on one device).
        self._replay = Replay(self.mesh)
        if params is None:
            if random_init:
                g = torch.Generator(device=self.device)
                g.manual_seed(0)
                params = init_params(config_for(name), g)
            else:
                from ..checkpoint import load_checkpoint

                params, tokenizer = load_checkpoint(settings, config_for(name), self.device)
        params = params.to(self.device)
        self.cfg: WhisperConfig = params.cfg
        # compute_type=int8: weight-only int8 weights and an int8 cross slab;
        # int4: int8 weights and the packed int4 cross slab.
        ct = settings.compute_type.strip().lower()
        self.quantized = ct.startswith(("int8", "int4"))
        self.xa_bits = 4 if ct.startswith("int4") else (8 if self.quantized else 0)
        # Self-KV-cache storage: float8 with the quantized compute types,
        # the compute dtype otherwise; SELF_CACHE=f8|bf16 overrides.
        sc = getattr(settings, "self_cache", "auto").strip().lower()
        if sc in ("f8", "fp8", "float8", "float8_e4m3fn", "e4m3"):
            self.self_dtype = torch.float8_e4m3fn
        elif sc in ("bf16", "bfloat16", "off", "none"):
            self.self_dtype = None
        else:  # auto
            self.self_dtype = torch.float8_e4m3fn if self.quantized else None
        with torch.inference_mode():
            if self.quantized and not is_quantized(params):
                quantize_params(params)
            if self.mesh is None:
                fuse_decoder_qkv(params)  # one q/k/v product on the decode path
        if self.mesh is not None:  # this rank's shard (q/k/v unfused)
            params = shard_params(self.mesh, params)
        self.params = params
        self.draft_cfg: Optional[WhisperConfig] = None
        self.draft_params = None
        dm = (settings.draft_model or "").strip()
        if dm:
            self._load_draft(dm, draft_params, random_init)
        if not settings.flash_attn:
            log.warning("FLASH_ATTN=0 has no effect in the PyTorch port: the encoder's "
                        "attention runs its CUDA kernel (K2) on the card")
        self.tokenizer = tokenizer or fallback_tokenizer(self.cfg.n_vocab)
        self.ids = TokenIds.from_tokenizer(self.tokenizer)
        self.suppress_mask = torch.from_numpy(
            build_suppress_mask(
                self.cfg.n_vocab, self.ids, self.tokenizer.non_speech_tokens,
                suppress_nst=settings.suppress_nst,
            )
        ).to(self.device)
        self._slots = threading.Semaphore(max(1, settings.parallel_requests))
        # Shared around device work, exclusive for a graph capture.
        self._device = DeviceLock("device")
        # The engine's own graph classes and generator: one owner at a time.
        self._device_lock = threading.Lock()
        # On the card, request threads dispatch their eager stages (encode,
        # language detection, alignment: thousands of launches each) one at a
        # time: from several threads at once they run about 3x slower than
        # one after another (host contention; chip_threads.py). On the
        # CPU they run side by side.
        self._eager = (tracing.Gate(threading.Lock(), "eager") if self.device.type == "cuda"
                       else contextlib.nullcontext())
        self._ready = True
        self._generator = torch.Generator(device=self.device)
        # Rank 0's clock seed on every rank: sampled rungs draw alike.
        self._generator.manual_seed(self._replay.share(int(time.time()) & 0x7FFFFFFF))
        # The decode graph classes of this engine (models/graphs.py): one
        # StepLoop per shape class, captured at its first request.
        self.graphs = DecodeGraphs(lock=self._device)
        self._request = threading.local()  # .stages: the request thread's stage ms
        self._batchers: dict[int, ContinuousBatcher] = {}  # one pool per audio_ctx width
        self._beam_gang: Optional[BeamGang] = None
        self._batcher_lock = threading.Lock()
        # Requests inside _transcribe_longform (the lone-request signal) and
        # inside the beam path (the gang's hint).
        self._inflight = 0
        self._beam_inflight = 0
        self._count_lock = threading.Lock()
        for name, op in (("encode", self._encode_op), ("detect", self._detect_op),
                         ("decode", self._decode_window_op), ("decode_spec", self._decode_spec_op),
                         ("align", self._align_op),
                         ("align_batch", self._align_batch_op),
                         ("new_batcher", self._new_batcher_op), ("new_gang", self._new_gang_op),
                         ("release", self._release_op)):
            self._replay.register(name, op)
        self._replay.open()

    @property
    def is_leader(self) -> bool:
        """True on rank 0 of a mesh (and on one device): the rank that serves."""
        return self._replay.leader

    def follow(self) -> None:
        """A rank above 0 of a mesh: run rank 0's device operations on this
        rank's shard, in order, until rank 0 calls :meth:`close`. Raises when
        the channel fails (rank 0 gone, a timeout)."""
        self._replay.follow()

    def close(self) -> None:
        """Rank 0 of a mesh: release the followers (they leave
        :meth:`follow`); after it the engine serves no request. No-op on
        one device."""
        self._replay.close()

    def _load_draft(self, dm: str, draft_params, random_init: bool) -> None:
        """The speculative draft (``draft_params``, a ``Whisper``, when the
        caller gives one): loaded, quantized and fused as the target, or on
        a mesh sharded as the target (q/k/v unfused; every rank builds the
        same draft before it takes its shard). Its cross K/V comes from the
        target's encoder output, so its encoder width must match."""
        settings = self.settings
        draft_cfg = config_for(dm) if draft_params is None else draft_params.cfg
        if draft_cfg.n_audio_state != self.cfg.n_audio_state:
            raise ValueError(
                f"draft_model {dm!r} encoder width {draft_cfg.n_audio_state} != target "
                f"{self.cfg.n_audio_state} — cannot share encoder output")
        if draft_params is None:
            if random_init:
                g = torch.Generator(device=self.device)
                g.manual_seed(1)
                draft_params = init_params(draft_cfg, g)
            else:
                from ..checkpoint import load_checkpoint

                draft_params, _ = load_checkpoint(
                    dataclasses.replace(settings, model_filename=f"ggml-{dm}.bin"), draft_cfg,
                    self.device)
        draft_params = draft_params.to(self.device)
        with torch.inference_mode():
            if self.quantized and not is_quantized(draft_params):
                quantize_params(draft_params)
            if self.mesh is None:
                fuse_decoder_qkv(draft_params)
        if self.mesh is not None:
            draft_params = shard_params(self.mesh, draft_params)
        self.draft_cfg, self.draft_params = draft_params.cfg, draft_params
        if settings.parallel_requests > 1:
            from ..serving.suts_logging import suts_warn

            suts_warn(
                "spec_decode_opportunistic", None, None, None,
                "DRAFT_MODEL=%s with PARALLEL_REQUESTS=%d: speculative decoding engages only "
                "when no other request is in flight; concurrent bursts use the continuous "
                "batcher. Set PARALLEL_REQUESTS=1 to force it on every request.",
                dm, settings.parallel_requests)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _stage(self, name: str):
        """Adds the time of the block (the device synchronised at its end)
        to this thread's request's ``stages_ms[name]``. While the tracer is
        on the block is also a span ``name`` between the same two clock
        readings, yielded for its attributes (None when off), and its
        ``sync`` attribute the instant the synchronise began."""
        t = time.perf_counter_ns()
        span = tracing.begin(name, at=t) if tracing.on else None
        t1 = None
        try:
            yield span
        finally:
            stages = getattr(self._request, "stages", None)
            if stages is not None:
                if self.device.type == "cuda":
                    with self._device.shared():
                        if span is not None:  # the join's check of the clock reads it
                            span.attrs["sync"] = time.perf_counter_ns()
                        torch.cuda.synchronize(self.device)
                t1 = time.perf_counter_ns()
                stages[name] = stages.get(name, 0.0) + (t1 - t) * 1e-6
            if span is not None:
                tracing.end(span, at=t1)

    def _get_batcher(self, xa_ctx: Optional[int] = None) -> ContinuousBatcher:
        """The continuous batcher for greedy windows of cross width
        ``xa_ctx``: one pool per audio_ctx bucket, built (and its step
        graphs captured) at first use."""
        xa_ctx = xa_ctx or self.cfg.n_audio_ctx
        with self._batcher_lock:
            if xa_ctx not in self._batchers:
                self._replay.call("new_batcher", xa_ctx)
            return self._batchers[xa_ctx]

    def _new_batcher_op(self, xa_ctx: int, own=None) -> None:
        self._batchers[xa_ctx] = ContinuousBatcher(
            self.cfg, self.params, self.ids, self.suppress_mask,
            max_slots=max(2, self.settings.max_batch_size), cache_len=256,
            kv_bits=self.xa_bits, xa_ctx=xa_ctx, self_dtype=self.self_dtype,
            mesh=self.mesh, device_lock=self._device, replay=self._replay)

    def _get_beam_gang(self) -> Optional[BeamGang]:
        """The beam gang, when the engine serves concurrent requests and
        gang_window_ms > 0; else None."""
        if self.settings.parallel_requests <= 1 or self.settings.gang_window_ms <= 0:
            return None
        with self._batcher_lock:
            if self._beam_gang is None:
                self._replay.call("new_gang")
            return self._beam_gang

    def _new_gang_op(self, own=None) -> None:
        self._beam_gang = BeamGang(
            self.cfg, self.params, self.ids, self.suppress_mask,
            window_ms=self.settings.gang_window_ms,
            max_gang=max(2, self.settings.max_batch_size), self_dtype=self.self_dtype,
            others_hint=lambda: self._beam_inflight, mesh=self.mesh,
            device_lock=self._device, replay=self._replay)

    def warmup(self) -> float:
        """Capture the decode graph classes a request's first window meets
        under the current settings, with a short synthetic clip: the ladder's
        first rung (greedy or beam at full context, and greedy at every
        audio_ctx bucket under audio_ctx=-1) and, when the ladder can climb,
        its sampled rung (best-of or greedy sampling). Each decode is cut at
        its first chunk once its graphs are captured. With a draft model
        the greedy first rung's classes are the speculative ones, one per
        encoder width (a 16-token decode each), and the engine's own greedy
        and tick classes are left out. At
        ``parallel_requests`` > 1 it also builds the batcher's pool of every
        audio_ctx width a greedy first rung can meet (its step graphs), or
        captures the beam gang's class at every batch bucket. Language
        detection, the alignment pass and prosody run once. Then the
        classes of a streaming session's partial ticks
        (``_warmup_tick_classes``). Returns the seconds spent."""
        t0 = time.perf_counter()
        s = self.settings
        sot = list(self.tokenizer.sot_sequence("en" if self.cfg.is_multilingual else None))
        t = np.arange(SAMPLE_RATE, dtype=np.float32) / SAMPLE_RATE
        clip = np.zeros(N_SAMPLES, np.float32)
        clip[:SAMPLE_RATE] = 0.1 * np.sin(2 * np.pi * 150 * t)
        xa = self._encode_window(clip[None])
        if self.cfg.is_multilingual:
            self._replay.call("detect", xa)
        rungs = [(s.temperature, s.beam_size, s.best_of)]
        if s.temperature + 0.2 <= 1.0 + 1e-6:
            rungs.append((max(s.temperature, 0.0) + 0.2, s.beam_size, s.best_of))
        greedy = s.temperature <= 0.0 and s.beam_size <= 1
        # With a draft, a greedy t = 0 window decodes speculatively (or, under
        # load, in the batcher): the engine's own greedy classes go unused.
        spec = self.draft_params is not None and greedy
        for temp, beam, best_of in rungs:
            # A greedy first rung as a lone raw window: the engine's own class.
            raw = greedy and temp <= 0.0
            if raw and spec:
                continue
            self._decode_one(None if raw else xa, sot, len(sot), 0, temp, beam, best_of,
                             should_abort=_cut_after_first_poll(),
                             window_audio=clip if raw else None)
        if spec:  # the speculative class of every width a greedy window can meet
            widths = ([b for b in self.AUDIO_CTX_BUCKETS if b < self.cfg.n_audio_ctx]
                      if s.audio_ctx == -1 else []) + [self._window_ctx(N_SAMPLES)]
            for n_ctx in widths:
                xa_t, xa_d = self._encode_window_with_draft(clip[None], n_ctx)
                self._decode_spec(xa_t, xa_d, sot, len(sot), 0, None, TOKEN_CAP_BUCKETS[0])
        elif s.audio_ctx == -1 and greedy:
            for b in self.AUDIO_CTX_BUCKETS:
                if b < self.cfg.n_audio_ctx:
                    self._decode_one(None, sot, len(sot), 0, 0.0, 1, 1,
                                     should_abort=_cut_after_first_poll(), window_audio=clip,
                                     n_ctx=b)
        if s.parallel_requests > 1 and greedy:
            full = self.cfg.n_audio_ctx
            if s.audio_ctx == -1:
                widths = [b for b in self.AUDIO_CTX_BUCKETS if b < full] + [full]
            else:
                widths = [self._window_ctx(0) or full]
            for w in widths:
                self._get_batcher(w)
        gang = self._get_beam_gang()
        if gang is not None and s.temperature <= 0.0 and s.beam_size > 1:
            prefill = prompt_bucket(len(sot))
            row = np.full(self.cfg.n_text_ctx, self.ids.eot, np.int64)
            row[: len(sot)] = sot
            gang.warmup(xa, row, GangKey(
                sample_begin=len(sot), sot_index=0, beam_size=s.beam_size,
                max_len=min(self.cfg.n_text_ctx, prefill + SAMPLE_LEN), prefill_len=prefill,
                xa_f=self.cfg.n_audio_ctx, use_timestamps=True))
        if not spec:  # with a draft a tick's window decodes speculatively
            self._warmup_tick_classes(clip, sot)
        if not s.no_timestamps:
            self._token_times(xa, sot + [100 + i for i in range(8)], len(sot), 50)
        extract_prosody(clip[:SAMPLE_RATE], SAMPLE_RATE)  # its first call imports scipy
        if self.device.type == "cuda":
            with self._device.shared():
                torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _serving_ctx_buckets(self) -> list:
        """(n_ctx, lo_s, hi_s) of every encoder width a serving window can
        decode at (None: the full context), with the range of real-audio
        seconds that routes to it: one entry for a fixed audio_ctx, the
        bucket walk under audio_ctx = -1."""
        full = self.cfg.n_audio_ctx
        if self.settings.audio_ctx != -1:
            return [(self._window_ctx(N_SAMPLES), 0.0, 30.0)]
        out, lo = [], 0.0
        for b in self.AUDIO_CTX_BUCKETS:
            if b > full:
                continue
            hi = min(b * 320 / SAMPLE_RATE, 30.0)
            out.append((b if b < full else None, lo, hi))
            lo = hi
        if not out or out[-1][0] is not None:
            out.append((None, lo, 30.0))
        return out

    def _warmup_tick_classes(self, clip: np.ndarray, sot: list) -> None:
        """Capture the capped greedy classes that a streaming session's
        partial tick can reach under the current settings: every
        TOKEN_CAP_BUCKETS cap that the tick caps of ``runtime/streaming.py``
        round to, at every serving ctx bucket, on the engine's own class
        (the tick path at ``parallel_requests`` == 1, and the lone-stream
        fast path above it); at ``parallel_requests`` > 1 the pool of each
        width serves every cap from its own step graphs."""
        s = self.settings
        if s.temperature > 0.0 or not (
                s.beam_size <= 1 or s.stream_incremental or s.stream_greedy_partials):
            return
        from .streaming import PARITY_CAP_MAX, TICK_CAP_MAX, TICK_CAP_MIN, TICK_TOKENS_PER_SECOND

        cap_max = TICK_CAP_MAX if s.stream_incremental else PARITY_CAP_MAX

        def cap_of(seconds: float) -> int:
            return token_cap_bucket(
                min(cap_max, max(TICK_CAP_MIN, int(seconds * TICK_TOKENS_PER_SECOND) + 8)))

        for n_ctx, lo, hi in self._serving_ctx_buckets():
            caps = [c for c in TOKEN_CAP_BUCKETS if cap_of(lo + 1e-3) <= c <= cap_of(hi)]
            for cap in caps:
                self._decode_one(None, sot, len(sot), 0, 0.0, 1, 1,
                                 should_abort=_cut_after_first_poll(), sample_len=cap,
                                 window_audio=clip, n_ctx=n_ctx)
            if s.parallel_requests > 1 and caps:
                self._get_batcher(n_ctx)

    def shutdown(self):
        """Stop the batcher's and the gang's workers (rejecting what they
        still hold) and release the decode graph classes, on every rank of
        a mesh; a later request builds and captures anew."""
        with self._batcher_lock:
            for b in self._batchers.values():
                b.shutdown()
            if self._beam_gang is not None:
                self._beam_gang.shutdown()
            self._replay.call("release")

    def _release_op(self, own=None) -> None:
        for b in self._batchers.values():
            b.shutdown()  # a follower's: no worker, nothing held
        self._batchers.clear()
        if self._beam_gang is not None:
            self._beam_gang.shutdown()
            self._beam_gang = None
        with self._device_lock:
            self.graphs = DecodeGraphs(lock=self._device)

    def is_ready(self) -> bool:
        return self._ready

    def get_settings(self) -> Settings:
        return self.settings

    def _window_ctx(self, remain_samples: int, override: Optional[int] = None) -> Optional[int]:
        """Encoder context for a window with ``remain_samples`` of real
        audio, or None for the full 1500 (settings.audio_ctx; a request's
        RequestOptions.audio_ctx overrides)."""
        ac = self.settings.audio_ctx if override is None else override
        if ac == 0:
            return None
        full = self.cfg.n_audio_ctx
        if ac > 0:
            return min(max(64, ac), full)
        need = -(-remain_samples // 320)  # samples → encoder positions
        for b in self.AUDIO_CTX_BUCKETS:
            if need <= b and b <= full:
                return b if b < full else None
        return None

    def _encode_window(self, windows: np.ndarray, n_ctx: Optional[int] = None,
                       with_draft: bool = False):
        """audio windows [B, N] → cross-attention K/V on the engine's device:
        log-mel (K1 on the card), encoder (K2), then the K/V of every
        decoder layer, quantized to int8 or the packed int4 carrier by
        compute_type. ``n_ctx`` crops (or zero-pads) the window to its first
        ``n_ctx`` encoder positions (audio_ctx). An odd ``n_ctx`` under
        int4 raises (the carrier packs position pairs), as in the JAX
        package. ``with_draft`` also returns the draft's cross K/V from the
        same encoder output: (target's, draft's)."""
        windows = np.asarray(windows, np.float32)
        if n_ctx is not None:
            target = n_ctx * 320
            if target < windows.shape[-1]:
                windows = windows[..., :target]
            elif target > windows.shape[-1]:
                pad = [(0, 0)] * (windows.ndim - 1) + [(0, target - windows.shape[-1])]
                windows = np.pad(windows, pad)
        with self._stage("encode"):
            return self._replay.call("encode", np.ascontiguousarray(windows), with_draft)

    def _encode_op(self, windows: np.ndarray, with_draft: bool, own=None):
        cfg, keep = self.cfg, self._replay.keep
        with self._eager, self._device.shared(), torch.inference_mode():
            audio = to_device(windows, self.device)
            mel = compute_log_mel(audio, n_mels=cfg.n_mels, dtype=cfg.dtype)
            xa = encoder_apply(cfg, self.params, mel)
            xa_kv = keep(precompute_xa_kv(cfg, self.params, xa, self.xa_bits))
            if not with_draft:
                return xa_kv
            return xa_kv, keep(precompute_xa_kv(self.draft_cfg, self.draft_params,
                                                xa.to(self.draft_cfg.dtype), self.xa_bits))

    def _encode_window_with_draft(self, windows: np.ndarray, n_ctx: Optional[int] = None):
        """(the target's cross K/V, the draft's) from one encode of the
        target: the speculative path's front end."""
        return self._encode_window(windows, n_ctx, with_draft=True)

    # ------------------------------------------------------------------
    def transcribe_pcm16(
        self,
        pcm16: np.ndarray,
        input_sample_rate: int,
        options: RequestOptions,
        metrics: Optional[PerformanceMetrics] = None,
    ) -> list[TranscriptionResult]:
        pcm = np.asarray(pcm16, np.int16).astype(np.float32) / 32768.0
        return self.transcribe(pcm, input_sample_rate, options, metrics)

    def transcribe(
        self,
        pcmf32: np.ndarray,
        input_sample_rate: int,
        options: RequestOptions,
        metrics: Optional[PerformanceMetrics] = None,
    ) -> list[TranscriptionResult]:
        with tracing.begin_request() if tracing.on else tracing.OFF:
            return self._transcribe(pcmf32, input_sample_rate, options, metrics)

    def _transcribe(self, pcmf32: np.ndarray, input_sample_rate: int, options: RequestOptions,
                    metrics: Optional[PerformanceMetrics]) -> list[TranscriptionResult]:
        t_start = time.perf_counter()
        metrics = metrics if metrics is not None else PerformanceMetrics()
        s = self.settings

        if options.should_abort and options.should_abort():
            return []

        audio = np.asarray(pcmf32, np.float32).reshape(-1)
        if input_sample_rate != SAMPLE_RATE:
            with tracing.begin("resample") if tracing.on else tracing.OFF, self._device.shared():
                audio = to_host(resample(to_device(audio, self.device), input_sample_rate,
                                         SAMPLE_RATE)).numpy()

        # Min-duration gate.
        min_samples = int(s.vad_ms_min_duration * SAMPLE_RATE / 1000)
        if audio.shape[0] < min_samples:
            return []

        # VAD gate: silence → single empty-text result with a neutral
        # affective payload, language "unknown", speaker "unknown", t1 in
        # ms (the reference's quirks; min speech 250 ms inside the VAD).
        # An installed Silero VAD runs on its device: the gate holds the DeviceLock shared.
        with tracing.begin("vad") if tracing.on else tracing.OFF, self._device.shared():
            speech = not s.enable_vad or is_speech_detected(audio, SAMPLE_RATE,
                                                            s.vad_threshold, 250)
        if not speech:
            tags = AffectiveTags()
            res = TranscriptionResult(
                text="", language="unknown", prob=0.0,
                t0=0, t1=int(audio.shape[0] / 16.0),
                affective=tags, gender_proxy=tags.gender_proxy,
                emotion_proxy=tags.emotion_proxy, speaker_id="unknown",
            )
            metrics.processing_time_ms = (time.perf_counter() - t_start) * 1e3
            return [res]

        # Admission.
        t_q = time.perf_counter()
        with tracing.begin("queue", tracing.WAIT) if tracing.on else tracing.OFF:
            admitted = self._slots.acquire(timeout=s.request_queue_timeout_ms / 1000.0)
        if not admitted:
            raise EngineBusyException("Engine busy: no free decode slot within timeout")
        metrics.queue_time_ms = (time.perf_counter() - t_q) * 1e3
        try:
            temperature0, beam_size, _ = self._decode_options(options)  # a refused beam raises
            beam_flight = beam_size > 1 and temperature0 <= 0.0
            with self._count_lock:
                self._inflight += 1
                self._beam_inflight += beam_flight
            self._request.stages, self._request.spec = metrics.stages_ms, metrics.spec
            try:
                results = self._transcribe_longform(audio, options, metrics)
            finally:
                self._request.stages = self._request.spec = None
                with self._count_lock:
                    self._inflight -= 1
                    self._beam_inflight -= beam_flight
        finally:
            self._slots.release()
            self._replay.flush()  # the request's cross K/V, freed on the followers
        metrics.processing_time_ms = (time.perf_counter() - t_start) * 1e3
        metrics.token_count = sum(r.token_count for r in results)
        return results

    # ------------------------------------------------------------------
    def _decode_options(self, options: RequestOptions):
        s = self.settings
        temperature = options.temperature if options.temperature >= 0.0 else s.temperature
        beam_size = options.beam_size if options.beam_size > 0 else s.beam_size
        best_of = options.best_of if options.best_of > 0 else s.best_of
        check_beam_size(beam_size)
        return temperature, beam_size, best_of

    def _resolve_language(
        self, audio: np.ndarray, options: RequestOptions
    ) -> tuple[str, float, Optional[dict], Optional[int]]:
        """(language, probability, window0_xa_kv, window0_ctx). Probability
        is the detect-language max softmax prob when auto-detected, 1.0
        when the caller pinned the language. When a detect pass ran, its
        encoder output is returned so that the long-form loop reuses it for
        window 0."""
        lang = (options.language or self.settings.language or "auto").lower()
        if lang and lang != "auto":
            return lang, 1.0, None, None
        if not self.cfg.is_multilingual:
            return "en", 1.0, None, None
        window = np.zeros(N_SAMPLES, np.float32)
        n = min(audio.shape[0], N_SAMPLES)
        window[:n] = audio[:n]
        n_ctx = self._window_ctx(n, options.audio_ctx)
        xa_kv = self._encode_window(window[None], n_ctx)
        with self._stage("detect"):
            probs = self._replay.call("detect", xa_kv)
        best = int(np.argmax(probs))
        return LANGUAGES[best], float(probs[best]), xa_kv, n_ctx

    def _detect_op(self, xa_kv: dict, own=None) -> np.ndarray:
        """Language probabilities of the first window of ``xa_kv``."""
        sp = self.tokenizer.special
        with self._eager, self._device.shared():
            probs = detect_language(self.cfg, self.params, xa_kv, sp.sot, sp.language_begin,
                                    sp.num_languages)[0]
            return to_host(probs).numpy()

    def _decode_one(
        self,
        xa_kv: Optional[dict],
        init_tokens: list[int],
        sample_begin: int,
        sot_index: int,
        temperature: float,
        beam_size: int,
        best_of: int,
        should_abort=None,
        sample_len: int = SAMPLE_LEN,
        window_audio: Optional[np.ndarray] = None,
        n_ctx: Optional[int] = None,
        xa_out: Optional[list] = None,
        xa_kv_draft: Optional[dict] = None,
    ) -> Optional[DecodeResult]:
        """One decode attempt at one temperature for a single window: beam
        search at t = 0 with beam_size > 1, best-of sampling above t = 0
        with best_of > 1, else greedy (or sampled) decoding. Returns the
        DecodeResult on the host, or None if aborted.

        Routing, as the JAX package's: at ``parallel_requests`` > 1 a greedy
        t = 0 window goes to the continuous batcher of its width unless it
        is a raw window decoding alone (``fused_idle_fastpath``, no other
        request in flight, the pool idle: the JAX package's fused path, here
        the engine's own class, which polls ``should_abort`` as well), and a
        beam t = 0 window to the beam gang; everything else replays the
        engine's own graph class from ``self.graphs``. ``window_audio`` (with ``xa_kv`` None) is the raw
        window, encoded here or, on the batcher's path, in the batcher's
        admission tick; its cross K/V is appended to ``xa_out``.
        ``xa_kv_draft``, the draft's cross K/V, routes a greedy t = 0 window
        through speculative decoding (``_decode_spec``)."""
        cfg = self.cfg
        ctx = cfg.n_text_ctx
        s = self.settings
        greedy = temperature <= 0.0 and beam_size <= 1
        if xa_kv_draft is not None and greedy:
            return self._decode_spec(xa_kv, xa_kv_draft, init_tokens, sample_begin, sot_index,
                                     should_abort, sample_len)
        if xa_kv is not None:
            xa_f = xa_kv["k_scale" if "k_scale" in xa_kv else "k"].shape[-1]
        else:
            xa_f = n_ctx or cfg.n_audio_ctx
        if greedy and s.parallel_requests > 1:
            pool = self._batchers.get(xa_f)
            alone = (xa_kv is None and s.fused_idle_fastpath and self._inflight <= 1
                     and (pool is None or pool.is_idle()))
            if not alone:
                return self._decode_batched(xa_kv, init_tokens, sot_index, should_abort,
                                            sample_len, window_audio, xa_f, xa_out)
        if xa_kv is None:
            xa_kv = self._encode_window(window_audio[None], n_ctx)
            if xa_out is not None:
                xa_out.append(xa_kv)
        tinit = np.full((1, ctx), self.ids.eot, np.int64)
        tinit[0, : len(init_tokens)] = init_tokens
        prefill_len = prompt_bucket(sample_begin)
        # Greedy decodes pin the prefill to one bucket per cap class (the
        # JAX package's TICK_PREFILL pinning; output-identical).
        if greedy:
            pinned = TICK_PREFILL if sample_len < SAMPLE_LEN else PROMPT_BUCKETS[-1]
            prefill_len = max(prefill_len, pinned)
        max_len = min(ctx, prefill_len + sample_len)
        if temperature <= 0.0 and beam_size > 1:
            gang = self._get_beam_gang()
            if gang is not None:
                fut = gang.submit(xa_kv, tinit[0], GangKey(
                    sample_begin=sample_begin, sot_index=sot_index, beam_size=beam_size,
                    max_len=max_len, prefill_len=prefill_len, xa_f=xa_f, use_timestamps=True),
                    should_abort=should_abort)
                with self._stage("decode") as span:
                    res = _waited(fut, "gang", self._wait_s())
                if res is None:
                    return None
                with self._device.shared():
                    out = _host(res)
                if span is not None:
                    _decode_attrs(span, "gang", "one", sample_begin, max_len, beam_size, out)
                return out
        with self._stage("decode") as span:
            out = self._replay.call(
                "decode", xa_kv, tinit, sample_begin, sot_index, temperature, beam_size,
                best_of, max_len, prefill_len, sample_len if greedy else None,
                should_abort is not None, own=should_abort)
        if span is not None:
            _decode_attrs(span, "engine", "one", sample_begin, max_len, beam_size, out)
        return out

    def _decode_window_op(self, xa_kv, tinit, sample_begin, sot_index, temperature,
                          beam_size, best_of, max_len, prefill_len, sample_cap, abortable,
                          own=None) -> Optional[DecodeResult]:
        """One decode on the engine's own graph classes, the rows of
        ``tinit`` over ``xa_kv``: beam search at t = 0 with beam_size > 1,
        best-of sampling above t = 0 with best_of > 1, else greedy (or
        sampled) decoding. Rank 0's abort poll (``own``) decides for every
        rank. The result on the host, or None if aborted."""
        cfg = self.cfg
        should_abort = self._replay.decider(own) if abortable else None
        common = dict(max_len=max_len, prefill_len=prefill_len, self_dtype=self.self_dtype,
                      should_abort=should_abort, graphs=self.graphs)
        with self._device_lock, self._device.shared():
            args = (cfg, self.params, xa_kv, to_device(tinit, self.device),
                    sample_begin, sot_index, self.ids, self.suppress_mask)
            if temperature <= 0.0 and beam_size > 1:
                res = decode_window_beam(*args, beam_size=beam_size, **common)
            elif temperature > 0.0 and best_of > 1:
                res = decode_window_best_of(*args, temperature, self._generator,
                                            best_of=best_of,
                                            cvalid_rows=self.settings.cvalid_rows, **common)
            else:
                res = decode_window(
                    *args, max(temperature, 0.0), self._generator if temperature > 0.0 else None,
                    cvalid_rows=self.settings.cvalid_rows, sample_cap=sample_cap, **common)
            return None if res is None else _host(res)

    def _decode_spec(self, xa_kv, xa_kv_draft, init_tokens, sample_begin, sot_index,
                     should_abort, sample_len) -> Optional[DecodeResult]:
        """A greedy t = 0 window through ``decode_window_spec`` on the
        engine's own graph class, as the JAX package routes it: the abort
        polled once before the launch, the prefill at the prompt's own
        bucket (no pinning) and ``max_len`` = prefill + ``sample_len``; every
        window of one encoder width shares one graph class. One op of the
        replay channel on a mesh. Its counts go to the request's
        ``PerformanceMetrics.spec``."""
        ctx = self.cfg.n_text_ctx
        tinit = np.full((1, ctx), self.ids.eot, np.int64)
        tinit[0, : len(init_tokens)] = init_tokens
        prefill_len = prompt_bucket(sample_begin)
        max_len = min(ctx, prefill_len + sample_len)
        with self._stage("decode") as span:
            out = self._replay.call(
                "decode_spec", xa_kv, xa_kv_draft, tinit, sample_begin, sot_index, prefill_len,
                max_len, should_abort is not None, own=should_abort)
        if out is None:
            return None
        res, stats = out
        if span is not None:
            _decode_attrs(span, "spec", "one", sample_begin, max_len, 1, res)
        counts = getattr(self._request, "spec", None)
        if counts is not None:
            for name, n in vars(stats).items():
                counts[name] = counts.get(name, 0) + n
        return res

    def _decode_spec_op(self, xa_kv, xa_kv_draft, tinit, sample_begin, sot_index, prefill_len,
                        max_len, abortable, own=None):
        """The window of ``_decode_spec`` on this rank's shard: rank 0's
        abort poll (``own``) decides for every rank, as its stop does inside
        ``run_rounds``. Returns (the result on the host, its ``SpecStats``),
        or None if aborted."""
        if abortable and self._replay.decider(own)():
            return None
        stats = SpecStats()
        with self._device_lock, self._device.shared():
            res = _host(decode_window_spec(
                self.cfg, self.params, xa_kv, self.draft_cfg, self.draft_params, xa_kv_draft,
                to_device(tinit, self.device), sample_begin, sot_index, self.ids,
                self.suppress_mask, max_len=max_len, gamma=max(1, self.settings.spec_gamma),
                prefill_len=prefill_len, self_dtype=self.self_dtype, graphs=self.graphs,
                stats=stats))
        return res, stats

    def _wait_s(self) -> float:
        """How long a request waits on the batcher or the gang (the JAX
        package's bound)."""
        return max(60.0, self.settings.request_queue_timeout_ms / 1000.0 * 120)

    def _decode_batched(self, xa_kv, init_tokens, sot_index, should_abort, sample_len,
                        window_audio, xa_f, xa_out) -> Optional[DecodeResult]:
        """A greedy t = 0 window through the continuous batcher: the raw
        window when it is not encoded yet, else its cross K/V. The result
        comes back on the host as a DecodeResult."""
        ctx = self.cfg.n_text_ctx
        batcher = self._get_batcher(xa_f)
        if xa_kv is None:
            fut = batcher.submit(window_audio, init_tokens, sot_index, max_tokens=sample_len,
                                 should_abort=should_abort)
        else:
            fut = batcher.submit_encoded(xa_kv, init_tokens, sot_index, max_tokens=sample_len,
                                         should_abort=should_abort)
        with self._stage("decode") as span:
            out = _waited(fut, "batcher", self._wait_s())
        if out is None:  # aborted mid-decode
            return None
        if xa_kv is None and xa_out is not None:
            xa_out.append(out["xa_kv"])
        seq = out["tokens"]
        n = len(init_tokens) + len(seq)
        tokens = np.full((1, ctx), self.ids.eot, np.int64)
        tokens[0, : len(init_tokens)] = init_tokens
        tokens[0, len(init_tokens) : n] = seq
        tok_lps = np.zeros((1, ctx), np.float32)
        tok_lps[0, len(init_tokens) : n] = out["token_logprobs"]
        res = DecodeResult(
            tokens=tokens,
            lengths=np.asarray([min(n + 1, ctx)], np.int64),
            sum_logprobs=np.asarray([out["sum_logprob"]], np.float32),
            avg_logprobs=np.asarray([out["avg_logprob"]], np.float32),
            no_speech_probs=np.asarray([out["no_speech_prob"]], np.float32),
            token_logprobs=tok_lps,
        )
        if span is not None:
            _decode_attrs(span, "batcher", "one", len(init_tokens), len(init_tokens) + sample_len,
                          1, res)
        return res

    def _transcribe_longform(
        self,
        audio: np.ndarray,
        options: RequestOptions,
        metrics: PerformanceMetrics,
    ) -> list[TranscriptionResult]:
        s = self.settings
        cfg = self.cfg
        tok = self.tokenizer
        sp = tok.special
        ids = self.ids
        temperature0, beam_size, best_of = self._decode_options(options)
        sample_len = token_cap_bucket(options.max_decode_tokens)
        no_ts = s.no_timestamps if options.no_timestamps is None else options.no_timestamps

        # Beam-strategy requests always decode at the full audio context,
        # as in the JAX package.
        if beam_size > 1 and temperature0 <= 0.0:
            options = dataclasses.replace(options, audio_ctx=0)

        language, lang_prob, xa_kv_w0, xa_ctx_w0 = self._resolve_language(audio, options)
        task = "translate" if (options.translate or s.translate) else "transcribe"

        clusterer = SpeakerClusterer(s.cluster_threshold)
        diarize = options.enable_diarization or s.enable_diarization

        prompt_text_tokens: list[int] = (
            tok.encode(" " + options.prompt.strip()) if options.prompt.strip() else []
        )

        n_windows_total = -(-audio.shape[0] // N_SAMPLES)
        if not options.condition_on_previous_text and not prompt_text_tokens and n_windows_total > 1:
            return self._transcribe_batched(audio, options, language, lang_prob, task,
                                            clusterer, diarize)

        carried_tokens: list[int] = []
        results: list[TranscriptionResult] = []
        n = audio.shape[0]
        seek = 0  # in samples
        while seek < n:
            if options.should_abort and options.should_abort():
                break
            window = np.zeros(N_SAMPLES, np.float32)
            remain = min(n - seek, N_SAMPLES)
            window[:remain] = audio[seek : seek + remain]
            window_dur_cs = int(round(remain / SAMPLE_RATE * 100))  # centisec

            n_ctx_w = self._window_ctx(remain, options.audio_ctx)
            # Speculative decoding: greedy with a draft, both models' cross
            # K/V from one encode. Above parallel_requests = 1 only while the
            # batcher of the window's width is idle (the request decodes
            # alone); concurrent bursts ride the batcher.
            pool = self._batchers.get(n_ctx_w or cfg.n_audio_ctx)
            use_spec = (self.draft_params is not None and temperature0 <= 0.0
                        and beam_size <= 1
                        and (s.parallel_requests == 1 or pool is None or pool.is_idle()))
            xa_kv_draft = None
            if use_spec:
                xa_kv, xa_kv_draft = self._encode_window_with_draft(window[None], n_ctx_w)
            elif seek == 0 and xa_kv_w0 is not None and xa_ctx_w0 == n_ctx_w:
                xa_kv = xa_kv_w0  # the detect pass encoded this very window
            elif temperature0 <= 0.0 and beam_size <= 1:
                # Greedy: the encode waits for _decode_one, where the
                # batcher's admission tick may encode it with others'.
                xa_kv = None
            else:
                xa_kv = self._encode_window(window[None], n_ctx_w)

            # Decoder preamble: [sot_prev + carried/prompt] [sot lang task].
            prefix = prompt_text_tokens + carried_tokens
            prefix = prefix[-(cfg.n_text_ctx // 2 - 1) :]
            if sample_len < SAMPLE_LEN:
                # Capped decodes pin the prefill to TICK_PREFILL: keep the
                # carried prompt inside it.
                prefix = prefix[-(TICK_PREFILL - 8) :]
            init_tokens: list[int] = []
            if prefix:
                init_tokens = [sp.sot_prev] + prefix
            sot_index = len(init_tokens)
            init_tokens += tok.sot_sequence(language if cfg.is_multilingual else None, task)
            sample_begin = len(init_tokens)

            # Temperature-fallback ladder.
            temps = [temperature0 + 0.2 * i for i in range(6)]
            temps = [t for t in temps if t <= 1.0 + 1e-6] or [temperature0]
            chosen = None
            used_temp = temps[0]
            for t in temps:
                used_temp = t
                xa_holder: list = []
                res = self._decode_one(
                    xa_kv, init_tokens, sample_begin, sot_index, t, beam_size, best_of,
                    should_abort=options.should_abort, sample_len=sample_len,
                    window_audio=window if xa_kv is None else None, n_ctx=n_ctx_w,
                    xa_out=xa_holder, xa_kv_draft=xa_kv_draft if t <= 0.0 else None,
                )
                if xa_kv is None and xa_holder:
                    xa_kv = xa_holder[0]  # encoded by _decode_one or the batcher
                if res is None:  # aborted mid-decode
                    return results
                with tracing.begin("segments") if tracing.on else tracing.OFF:
                    seq = np.asarray(res.tokens[0])[sample_begin : int(res.lengths[0])]
                    text_tokens = [int(x) for x in seq if x < ids.eot]
                    text = tok.decode(text_tokens)
                    avg_lp = float(res.avg_logprobs[0])
                    needs_fallback = (
                        quality_gate_fails(s.quality_gate, text, text_tokens)
                        or avg_lp < s.logprob_threshold
                    )
                no_speech = (
                    float(res.no_speech_probs[0]) > s.no_speech_threshold
                    and avg_lp < s.logprob_threshold
                )
                if no_speech:
                    chosen = None  # silence: skip window, no retry
                    break
                if not needs_fallback:
                    chosen = res
                    break
                chosen = res  # keep last attempt if all fail
            if chosen is None:
                seek += remain
                carried_tokens = []
                continue

            seq = np.asarray(chosen.tokens[0])[sample_begin : int(chosen.lengths[0])]
            tok_lps = np.asarray(chosen.token_logprobs[0])[sample_begin : int(chosen.lengths[0])]

            with tracing.begin("segments") if tracing.on else tracing.OFF:
                segments, advance_cs = _parse_segments(seq, tok_lps, ids, window_dur_cs)
            base_cs = int(round(seek / SAMPLE_RATE * 100))

            # Token-level timestamps: DTW over cross-attention, one extra
            # teacher-forced pass per window; window-relative seconds.
            token_times = None
            if segments and not no_ts:
                try:
                    align_seq = [t for t in map(int, seq) if t != ids.eot]
                    with self._stage("align"):
                        token_times = self._token_times(xa_kv, init_tokens + align_seq,
                                                        sample_begin, max(1, remain // 320))
                except Exception:  # noqa: BLE001 — timestamps are best-effort, as there
                    log.exception("token timestamps failed; segment bounds used")
                    token_times = None

            results.extend(
                self._build_segment_results(
                    segments, base_cs, token_times, audio, language,
                    lang_prob, options, clusterer, diarize,
                )
            )

            # Prompt carry-over: condition on previous text unless the
            # ladder got hot (the prompt resets above t = 0.5).
            all_text_tokens = [int(x) for x in seq if x < ids.eot]
            if all_text_tokens and used_temp <= 0.5:
                carried_tokens = (carried_tokens + all_text_tokens)[-(cfg.n_text_ctx // 2 - 1) :]
            else:
                carried_tokens = []

            seek += max(1, int(round(advance_cs / 100.0 * SAMPLE_RATE)))

        # speaker_turn_next: a speaker change between consecutive segments.
        if diarize:
            for a, b in zip(results, results[1:]):
                if a.speaker_id and b.speaker_id and a.speaker_id != b.speaker_id:
                    a.speaker_turn_next = True
        return results

    # ------------------------------------------------------------------
    def _transcribe_batched(
        self,
        audio: np.ndarray,
        options: RequestOptions,
        language: str,
        lang_prob: float,
        task: str,
        clusterer: SpeakerClusterer,
        diarize: bool,
    ) -> list[TranscriptionResult]:
        """Batched long-form path: fixed 30 s strides, the windows of a
        group (max_batch_size) decoded in one call
        (condition_on_previous_text=False). The temperature ladder
        re-decodes a whole group when any window fails its gates; accepted
        windows keep their first passing result."""
        s = self.settings
        cfg = self.cfg
        tok = self.tokenizer
        ids = self.ids
        temperature0, beam_size, best_of = self._decode_options(options)

        n = audio.shape[0]
        n_windows = -(-n // N_SAMPLES)
        group_size = max(1, s.max_batch_size)

        init_tokens = tok.sot_sequence(language if cfg.is_multilingual else None, task)
        sample_begin = len(init_tokens)
        prefill_len = prompt_bucket(sample_begin)
        sample_len = token_cap_bucket(options.max_decode_tokens)
        no_ts = s.no_timestamps if options.no_timestamps is None else options.no_timestamps
        max_len = min(cfg.n_text_ctx, prefill_len + sample_len)
        results: list[TranscriptionResult] = []

        for g0 in range(0, n_windows, group_size):
            if options.should_abort and options.should_abort():
                break
            g_idx = list(range(g0, min(g0 + group_size, n_windows)))
            W = len(g_idx)
            windows = np.zeros((W, N_SAMPLES), np.float32)
            durs_cs = []
            for j, w in enumerate(g_idx):
                remain = min(n - w * N_SAMPLES, N_SAMPLES)
                windows[j, :remain] = audio[w * N_SAMPLES : w * N_SAMPLES + remain]
                durs_cs.append(int(round(remain / SAMPLE_RATE * 100)))

            xa_kv = self._encode_window(windows)
            tinit = np.full((W, cfg.n_text_ctx), ids.eot, np.int64)
            tinit[:, :sample_begin] = init_tokens

            accepted: dict[int, tuple] = {}  # j -> (seq, tok_lps)
            silent: set[int] = set()
            temps = [temperature0 + 0.2 * i for i in range(6)]
            temps = [t for t in temps if t <= 1.0 + 1e-6] or [temperature0]
            last = {}
            for t in temps:
                if len(accepted) + len(silent) == W:
                    break
                with self._stage("decode") as span:
                    res = self._replay.call(
                        "decode", xa_kv, tinit, sample_begin, 0, t, beam_size, 1, max_len,
                        prefill_len, None, options.should_abort is not None,
                        own=options.should_abort)
                if res is None:  # aborted mid-decode → stop the request
                    return results
                if span is not None:
                    _decode_attrs(span, "engine", "batched", sample_begin, max_len, beam_size, res)
                with tracing.begin("segments") if tracing.on else tracing.OFF:
                    toks_np, lens_np, lps_np = res.tokens, res.lengths, res.token_logprobs
                    for j in range(W):
                        if j in accepted or j in silent:
                            continue
                        seq = toks_np[j, sample_begin : lens_np[j]]
                        tok_lps = lps_np[j, sample_begin : lens_np[j]]
                        text_toks = [int(x) for x in seq if x < ids.eot]
                        text = tok.decode(text_toks)
                        avg_lp = float(res.avg_logprobs[j])
                        no_speech = (
                            float(res.no_speech_probs[j]) > s.no_speech_threshold
                            and avg_lp < s.logprob_threshold
                        )
                        if no_speech:
                            silent.add(j)
                            continue
                        ok = (
                            not quality_gate_fails(s.quality_gate, text, text_toks)
                            and avg_lp >= s.logprob_threshold
                        )
                        last[j] = (seq, tok_lps)
                        if ok:
                            accepted[j] = (seq, tok_lps)
            for j in range(W):
                if j not in accepted and j not in silent and j in last:
                    accepted[j] = last[j]  # keep best-effort final attempt

            # Batched token-time alignment for accepted windows.
            token_times: dict[int, np.ndarray] = {}
            if accepted and not no_ts:
                try:
                    with self._stage("align"):
                        token_times = self._align_batch(
                            xa_kv, accepted, init_tokens, sample_begin, durs_cs)
                except Exception:  # noqa: BLE001 — timestamps are best-effort, as there
                    log.exception("token timestamps failed; segment bounds used")
                    token_times = {}

            for j in sorted(accepted):
                seq, tok_lps = accepted[j]
                base_cs = g_idx[j] * 3000  # 30 s per window in centisec
                with tracing.begin("segments") if tracing.on else tracing.OFF:
                    segments, _ = _parse_segments(seq, tok_lps, ids, durs_cs[j])
                results.extend(
                    self._build_segment_results(
                        segments, base_cs, token_times.get(j), audio, language, lang_prob,
                        options, clusterer, diarize,
                    )
                )

        if diarize:
            for a, b in zip(results, results[1:]):
                if a.speaker_id and b.speaker_id and a.speaker_id != b.speaker_id:
                    a.speaker_turn_next = True
        return results

    def _align_batch(self, xa_kv, accepted, init_tokens, sample_begin, durs_cs) -> dict:
        """One alignment pass over the accepted windows of a group → token
        times per window."""
        cfg, ids = self.cfg, self.ids
        keys = sorted(accepted)
        seqs = {j: [int(x) for x in accepted[j][0] if x != ids.eot] for j in keys}
        t_max = max(len(seqs[j]) for j in keys)
        if t_max <= 0:
            return {}
        width = min(align_bucket(sample_begin + t_max), cfg.n_text_ctx)
        align = np.full((len(keys), width), ids.eot, np.int64)
        for r, j in enumerate(keys):
            align[r, :sample_begin] = init_tokens
            align[r, sample_begin : sample_begin + len(seqs[j])] = seqs[j]
        scores = self._replay.call("align_batch", xa_kv, np.asarray(keys, np.int64), align)
        out = {}
        for r, j in enumerate(keys):
            n_frames = max(1, int(durs_cs[j] / 2))
            sc = scores[r, sample_begin : sample_begin + len(seqs[j])]
            if sc.shape[0]:
                out[j] = token_boundaries(sc, n_frames)
        return out

    def _align_batch_op(self, xa_kv, rows: np.ndarray, align: np.ndarray,
                        own=None) -> np.ndarray:
        """The alignment scores [R, T, F] of the token rows ``align`` over the
        windows ``rows`` of ``xa_kv``, on the host."""
        with self._eager, self._device.shared():
            rows_t = to_device(rows, self.device)
            sel = {k: v.index_select(1, rows_t) for k, v in xa_kv.items()}
            return to_host(alignment_scores(self.cfg, self.params, sel,
                                            to_device(align, self.device))).numpy()

    def _token_times(self, xa_kv, tokens: list, sample_begin: int, n_frames: int) -> np.ndarray:
        """One window's token times: the alignment pass on the device (an op),
        then DTW on the host."""
        scores = self._replay.call("align", xa_kv, np.asarray(tokens, np.int64))
        return times_of_scores(scores, sample_begin, n_frames)

    def _align_op(self, xa_kv, tokens: np.ndarray, own=None) -> np.ndarray:
        with self._eager, self._device.shared():
            return window_scores(self.cfg, self.params, xa_kv, tokens)

    def _build_segment_results(
        self,
        segments,
        base_cs: int,
        token_times,
        audio: np.ndarray,
        language: str,
        lang_prob: float,
        options: RequestOptions,
        clusterer: SpeakerClusterer,
        diarize: bool,
    ) -> list[TranscriptionResult]:
        """Per-segment post-processing for both long-form paths (gates,
        prosody, clustering)."""
        with self._stage("prosody"):
            s = self.settings
            tok = self.tokenizer
            n = audio.shape[0]
            out: list[TranscriptionResult] = []
            for seg in segments:
                raw_text = tok.decode(seg["tokens"])
                text = clean_utf8(raw_text).strip()
                if is_hallucination(text):
                    continue
                probs = [float(np.exp(lp)) for lp in seg["logprobs"]]
                avg_p = float(np.mean(probs)) if probs else 0.0
                if avg_p < s.min_segment_avg_prob:
                    continue
                t0_cs = base_cs + seg["t0"]
                t1_cs = base_cs + seg["t1"]
                s0 = min(max(0, int(t0_cs / 100.0 * SAMPLE_RATE)), n)
                s1 = min(max(s0, int(t1_cs / 100.0 * SAMPLE_RATE)), n)
                if s1 - s0 >= 160:
                    tags = extract_prosody(audio[s0:s1], SAMPLE_RATE, options.prosody_opts)
                else:
                    tags = AffectiveTags()
                speaker_id = clusterer.assign_or_add(tags.speaker_vec) if diarize else ""
                token_datas = []
                for t_id, lp, pos in zip(seg["tokens"], seg["logprobs"], seg["positions"]):
                    if token_times is not None and pos < len(token_times):
                        tt0 = base_cs + int(round(token_times[pos, 0] * 100))
                        tt1 = base_cs + int(round(token_times[pos, 1] * 100))
                    else:
                        tt0, tt1 = t0_cs, t1_cs
                    token_datas.append(
                        TokenData(text=clean_utf8(tok.token_piece(t_id)),
                                  p=float(np.exp(lp)), t0=tt0, t1=tt1)
                    )
                out.append(
                    TranscriptionResult(
                        text=text, language=language,
                        language_probability=lang_prob, prob=avg_p,
                        t0=t0_cs, t1=t1_cs, tokens=token_datas,
                        token_count=len(token_datas),
                        gender_proxy=tags.gender_proxy,
                        emotion_proxy=tags.emotion_proxy,
                        arousal=tags.arousal, valence=tags.valence,
                        affective=tags, speaker_id=speaker_id,
                    )
                )
            return out


def _compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _token_entropy(text_tokens) -> float:
    """whisper.cpp's sequence entropy: -Σ p·ln(p) over the token-count
    distribution of the last 32 sampled tokens (whisper_sequence_score).
    High entropy = diverse output; low = repetition loop."""
    import math

    toks = list(text_tokens)[-32:]
    if not toks:
        return 0.0
    n = len(toks)
    counts: dict[int, int] = {}
    for t in toks:
        counts[t] = counts.get(t, 0) + 1
    return -sum((c / n) * math.log(c / n) for c in counts.values())


def quality_gate_fails(mode: str, text: str, text_tokens) -> bool:
    """Temperature-fallback trigger (avg-logprob check is separate).

    ``mode="entropy"``: whisper.cpp semantics behind the reference's
    entropy_thold=2.40 — fails when MORE than 32 tokens were sampled and
    their last-32 count entropy is below 2.40.
    ``mode="compression_ratio"``: openai-whisper semantics — fails when
    the zlib compression ratio of the decoded text exceeds 2.4.
    ``mode="off"``: never fails (single-rung decode; the avg-logprob and
    no-speech gates still apply unless their thresholds are moved)."""
    if mode in ("off", "none"):
        return False
    if mode == "compression_ratio":
        return _compression_ratio(text) > COMPRESSION_RATIO_THRESHOLD
    return len(text_tokens) > 32 and _token_entropy(text_tokens) < ENTROPY_THRESHOLD


def _parse_segments(seq, tok_lps, ids: TokenIds, window_dur_cs: int):
    """Split a sampled token sequence into timestamped segments.

    Returns (segments, advance_cs): each segment is {"tokens", "logprobs",
    "positions", "t0", "t1"} with times in centiseconds relative to the
    window; advance is how far to move the audio cursor (whisper long-form
    semantics: to the last complete timestamp if the window ended with one,
    else the whole window)."""
    ts_begin = ids.timestamp_begin
    segments = []
    cur_tokens: list[int] = []
    cur_lps: list[float] = []
    cur_pos: list[int] = []
    t0 = 0
    open_seg = False
    last_ts = 0  # centisec of last timestamp token seen
    for pos, (t_id, lp) in enumerate(zip(map(int, seq), tok_lps)):
        if t_id == ids.eot:
            break
        if t_id >= ts_begin:
            cs = (t_id - ts_begin) * 2  # 0.02 s per step
            last_ts = cs
            if open_seg:
                if cur_tokens:
                    segments.append({"tokens": cur_tokens, "logprobs": cur_lps,
                                     "positions": cur_pos, "t0": t0, "t1": cs})
                cur_tokens, cur_lps, cur_pos = [], [], []
                open_seg = False
            else:
                t0 = cs
                open_seg = True
        else:
            cur_tokens.append(t_id)
            cur_lps.append(float(lp))
            cur_pos.append(pos)
    if cur_tokens:
        # Unterminated trailing segment: close at window end.
        segments.append({"tokens": cur_tokens, "logprobs": cur_lps, "positions": cur_pos,
                         "t0": t0, "t1": window_dur_cs})
        advance = window_dur_cs
    else:
        advance = last_ts if last_ts > 0 else window_dur_cs
    return segments, max(advance, 1)
