"""Typed runtime configuration with the reference service's environment
surface: a copy of the JAX package's ``config.py`` (``Settings``,
``load_settings``), the same ``STT_WHISPER_SERVICE_*`` names, defaults and
derived rules (``MODEL_SIZE`` -> ``ggml-{size}.bin``, the logprob sign).

What the port reads differently:

  * ``device``: ``"auto"`` and ``"cuda"`` mean the CUDA card, and the engine
    raises when there is none; ``"cpu"`` runs the plain PyTorch versions
    (the tests). Nothing falls back from one to the other.
  * ``beam_size`` above ``MAX_BEAM_SIZE`` is refused where the settings load
    (``load_settings``) and where the engine is built: the beam kernels' slot
    masks are 32 bits (``ops/beam_attention.MAX_BEAMS``).
  * ``flash_attn``: the encoder's attention always runs the K2 kernel on the
    card; ``FLASH_ATTN=0`` has no effect there (the engine says so in its
    log).
  * ``mesh_shape`` other than ``"1"`` takes one process per device of the
    mesh (joined by ``parallel.maybe_initialize_distributed``): rank 0
    serves and the other ranks replay its device operations
    (``runtime/engine.py``, ``parallel/replay.py``); a draft model together
    with a mesh is refused.
"""

from __future__ import annotations

import dataclasses
import os

_PREFIX = "STT_WHISPER_SERVICE_"
# The most beams an item may have: the beam kernels' slot masks are 32 bits
# (ops/beam_attention.MAX_BEAMS; the JAX package takes any beam size).
MAX_BEAM_SIZE = 32


def _env(name: str, default: str) -> str:
    return os.environ.get(_PREFIX + name, default)


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(_PREFIX + name)
    return int(val) if val is not None else default


def _env_float(name: str, default: float) -> float:
    val = os.environ.get(_PREFIX + name)
    return float(val) if val is not None else default


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(_PREFIX + name)
    if val is None:
        return default
    return val.strip().lower() in ("true", "1")


@dataclasses.dataclass
class Settings:
    """All service settings, with the reference service's defaults."""

    host: str = "0.0.0.0"
    http_port: int = 15030
    grpc_port: int = 15031
    metrics_port: int = 15032

    # --- Main model ---
    model_dir: str = "/models"
    model_size: str = "medium"
    model_filename: str = "ggml-medium.bin"
    model_url_template: str = (
        "https://huggingface.co/ggerganov/whisper.cpp/resolve/main/"
        "ggml-{model_name}.bin"
    )
    model_load_timeout: int = 600

    # --- VAD (reference config.h:24-37) ---
    vad_model_filename: str = "ggml-silero-vad.bin"
    vad_model_url: str = (
        "https://huggingface.co/ggml-org/whisper-vad/resolve/main/"
        "ggml-silero-v6.2.0.bin"
    )
    enable_vad: bool = True
    vad_threshold: float = 0.75
    vad_ms_min_duration: int = 500

    # --- Performance & batching (config.h:39-45) ---
    n_threads: int = 4
    parallel_requests: int = 2
    request_queue_timeout_ms: int = 5000
    # "auto" / "cuda": the CUDA card (the engine raises without one);
    # "cpu": the plain PyTorch versions.
    device: str = "auto"
    # "int4" = int8 weights + packed int4 cross K/V (the JAX package's
    # default), "int8" = int8 weights and cross K/V (the reference
    # service's), anything else = unquantized weights and a bf16 slab.
    compute_type: str = "int4"
    # Self-attention KV-cache storage: "auto" stores float8_e4m3fn when
    # compute_type is quantized (int8/int4) and the compute dtype
    # otherwise; "f8" / "bf16" force it.
    self_cache: str = "auto"

    # --- Generation (config.h:47-66) ---
    language: str = "auto"
    translate: bool = False
    no_timestamps: bool = False
    beam_size: int = 5
    temperature: float = 0.0
    best_of: int = 5
    logprob_threshold: float = -0.7
    no_speech_threshold: float = 0.85
    # Temperature-fallback trigger: "entropy" = whisper.cpp's gate behind
    # the reference's hardcoded entropy_thold=2.40 (stt_engine.cpp:241);
    # "compression_ratio" = openai-whisper's zlib-ratio>2.4 form.
    quality_gate: str = "entropy"
    # Per-segment avg token-probability drop gate (the reference hardcodes
    # 0.40, stt_engine.cpp:263-264,305-311). Exposed so deployments (and
    # the gate-passing streaming bench) can relax it; 0 disables.
    min_segment_avg_prob: float = 0.40
    flash_attn: bool = True
    suppress_nst: bool = True

    # --- Diarization (config.h:67-71) ---
    enable_diarization: bool = False
    cluster_threshold: float = 0.88

    sample_rate: int = 16000
    stream_buffer_samples: int = 8000  # 500 ms @ 16 kHz
    # Streaming settings (runtime/streaming.py, and the tick classes that
    # SttEngine.warmup() captures): commit stable segments early and trim
    # the buffer; decode partial ticks greedy even when the default
    # strategy is beam.
    stream_incremental: bool = False
    stream_greedy_partials: bool = True

    log_level: str = "info"
    grpc_ca_path: str = ""
    grpc_cert_path: str = ""
    grpc_key_path: str = ""

    # --- Additions of the JAX package (no reference counterpart) ---
    # Encoder audio context (whisper.cpp's audio_ctx): 0 = the full 1500
    # positions; -1 = per window the smallest of {384, 768, 1152, 1500}
    # covering its audio; N = a fixed context (64..1500).
    audio_ctx: int = 0
    # Speculative decoding (models/speculative.py): a draft model of the
    # same encoder width (e.g. "large-v3-turbo" for "large-v3") proposes
    # spec_gamma tokens per round and the target verifies them in one pass;
    # a greedy window's output is the target's greedy decode.
    draft_model: str = ""
    spec_gamma: int = 4
    # Decode micro-batch size: windows per call on the batched long-form
    # path (condition_on_previous_text=False).
    max_batch_size: int = 8
    # Continuous batcher and beam gang settings (not ported yet).
    fused_idle_fastpath: bool = True
    gang_window_ms: int = 30
    # Self-KV read-bucket granularity of the greedy loop
    # (models/sampling.cvalid_buckets); 0 reads the whole slab every step.
    cvalid_rows: int = 0
    # Mesh axes for weight sharding: "1" = single chip. e.g. "2x4" = dp=2, tp=4.
    mesh_shape: str = "1"
    # Weight/activation dtype on device.
    dtype: str = "bfloat16"


def load_settings() -> Settings:
    """Read settings from the environment, as the JAX package's
    ``load_settings`` does; refuses a ``BEAM_SIZE`` above ``MAX_BEAM_SIZE``."""
    s = Settings()
    s.host = _env("LISTEN_ADDRESS", s.host)
    s.http_port = _env_int("HTTP_PORT", s.http_port)
    s.grpc_port = _env_int("GRPC_PORT", s.grpc_port)
    s.metrics_port = _env_int("METRICS_PORT", s.metrics_port)

    s.model_dir = _env("MODEL_DIR", s.model_dir)
    s.model_size = _env("MODEL_SIZE", "medium")
    # Derived config: MODEL_SIZE → ggml-{size}.bin (config.h:112-114).
    s.model_filename = _env("MODEL_FILENAME", f"ggml-{s.model_size}.bin")

    s.vad_model_filename = _env("VAD_MODEL", s.vad_model_filename)
    s.vad_model_url = _env("VAD_URL", s.vad_model_url)
    s.enable_vad = _env_bool("ENABLE_VAD", s.enable_vad)
    s.vad_threshold = _env_float("VAD_THRESHOLD", s.vad_threshold)
    s.vad_ms_min_duration = _env_int("VAD_MS_MIN_DURATION", s.vad_ms_min_duration)

    s.flash_attn = _env_bool("FLASH_ATTN", s.flash_attn)
    s.suppress_nst = _env_bool("SUPPRESS_NST", s.suppress_nst)

    s.enable_diarization = _env_bool("ENABLE_DIARIZATION", s.enable_diarization)
    s.cluster_threshold = _env_float("CLUSTER_THRESHOLD", s.cluster_threshold)

    s.n_threads = _env_int("THREADS", s.n_threads)
    s.parallel_requests = _env_int("PARALLEL_REQUESTS", s.parallel_requests)
    s.request_queue_timeout_ms = _env_int(
        "QUEUE_TIMEOUT_MS", s.request_queue_timeout_ms
    )
    # Knobs the reference service's loader never read: the compute path,
    # the device and the provisioning wait.
    s.device = _env("DEVICE", s.device)
    s.compute_type = _env("COMPUTE_TYPE", s.compute_type)
    s.self_cache = _env("SELF_CACHE", s.self_cache)
    s.model_load_timeout = _env_int("MODEL_LOAD_TIMEOUT", s.model_load_timeout)
    s.no_timestamps = _env_bool("NO_TIMESTAMPS", s.no_timestamps)
    s.draft_model = _env("DRAFT_MODEL", s.draft_model)
    s.spec_gamma = _env_int("SPEC_GAMMA", s.spec_gamma)

    s.language = _env("LANGUAGE", s.language)
    s.translate = _env_bool("TRANSLATE", s.translate)

    s.beam_size = _env_int("BEAM_SIZE", s.beam_size)
    s.temperature = _env_float("TEMPERATURE", s.temperature)
    s.best_of = _env_int("BEST_OF", s.best_of)

    s.logprob_threshold = _env_float("LOGPROB_THRESHOLD", s.logprob_threshold)
    # Sign normalization: logprob threshold must be negative (config.h:149-155).
    if s.logprob_threshold > 0.0:
        s.logprob_threshold = -s.logprob_threshold

    s.no_speech_threshold = _env_float("NO_SPEECH_THRESHOLD", s.no_speech_threshold)
    s.quality_gate = _env("QUALITY_GATE", s.quality_gate)
    s.min_segment_avg_prob = _env_float(
        "MIN_SEGMENT_AVG_PROB", s.min_segment_avg_prob
    )
    s.sample_rate = _env_int("SAMPLE_RATE", s.sample_rate)
    s.stream_buffer_samples = _env_int(
        "STREAM_BUFFER_SAMPLES", s.stream_buffer_samples
    )
    s.stream_incremental = _env_bool("STREAM_INCREMENTAL", s.stream_incremental)
    s.stream_greedy_partials = _env_bool(
        "STREAM_GREEDY_PARTIALS", s.stream_greedy_partials
    )
    s.audio_ctx = _env_int("AUDIO_CTX", s.audio_ctx)

    s.log_level = _env("LOG_LEVEL", s.log_level)
    s.grpc_ca_path = os.environ.get("GRPC_TLS_CA_PATH", s.grpc_ca_path)
    s.grpc_cert_path = _env("CERT_PATH", s.grpc_cert_path)
    s.grpc_key_path = _env("KEY_PATH", s.grpc_key_path)

    # Legacy unprefixed knob kept for the bench harnesses; prefixed wins.
    s.cvalid_rows = int(os.environ.get("SSTW_CVALID_ROWS", s.cvalid_rows))
    s.cvalid_rows = _env_int("CVALID_ROWS", s.cvalid_rows)
    s.max_batch_size = _env_int("MAX_BATCH_SIZE", s.max_batch_size)
    s.fused_idle_fastpath = _env_bool("FUSED_IDLE_FASTPATH", s.fused_idle_fastpath)
    s.gang_window_ms = _env_int("GANG_WINDOW_MS", s.gang_window_ms)
    s.mesh_shape = _env("MESH_SHAPE", s.mesh_shape)
    s.dtype = _env("DTYPE", s.dtype)
    check_beam_size(s.beam_size)
    return s


def check_beam_size(beam_size: int) -> None:
    """Refuse a beam size the beam kernels cannot serve."""
    if beam_size > MAX_BEAM_SIZE:
        raise ValueError(
            f"beam_size {beam_size} > {MAX_BEAM_SIZE}: the beam kernels take at most "
            f"{MAX_BEAM_SIZE} beams (32-bit slot masks)"
        )
