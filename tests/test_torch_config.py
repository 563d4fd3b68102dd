"""The port's settings (``config.py``) against the JAX package's: the
defaults field for field, and ``load_settings`` under the same environment.
Exact equality (plain values). The port refuses a beam size its beam
kernels cannot serve where the settings load."""

import dataclasses

import pytest

from sentiric_stt_whisper_service_tpu import config as ref
from sentiric_stt_whisper_service_tpu_torch import config
from sentiric_stt_whisper_service_tpu_torch.ops.beam_attention import MAX_BEAMS

PRE = "STT_WHISPER_SERVICE_"

ENV = {
    "LISTEN_ADDRESS": "127.0.0.1", "HTTP_PORT": "18030", "GRPC_PORT": "18031",
    "METRICS_PORT": "18032", "MODEL_DIR": "/srv/models", "MODEL_SIZE": "large-v3",
    "VAD_MODEL": "vad.bin", "VAD_URL": "http://localhost/vad.bin", "ENABLE_VAD": "false",
    "VAD_THRESHOLD": "0.6", "VAD_MS_MIN_DURATION": "250", "FLASH_ATTN": "0",
    "SUPPRESS_NST": "false", "ENABLE_DIARIZATION": "true", "CLUSTER_THRESHOLD": "0.9",
    "THREADS": "8", "PARALLEL_REQUESTS": "3", "QUEUE_TIMEOUT_MS": "1234", "DEVICE": "cpu",
    "COMPUTE_TYPE": "int8", "SELF_CACHE": "bf16", "MODEL_LOAD_TIMEOUT": "123",
    "NO_TIMESTAMPS": "true", "DRAFT_MODEL": "", "SPEC_GAMMA": "3", "LANGUAGE": "tr",
    "TRANSLATE": "1", "BEAM_SIZE": "9", "TEMPERATURE": "0.2", "BEST_OF": "3",
    "LOGPROB_THRESHOLD": "0.5", "NO_SPEECH_THRESHOLD": "0.7",
    "QUALITY_GATE": "compression_ratio", "MIN_SEGMENT_AVG_PROB": "0.1",
    "SAMPLE_RATE": "8000", "STREAM_BUFFER_SAMPLES": "4000", "STREAM_INCREMENTAL": "true",
    "STREAM_GREEDY_PARTIALS": "false", "AUDIO_CTX": "-1", "LOG_LEVEL": "debug",
    "CERT_PATH": "/c.pem", "KEY_PATH": "/k.pem", "CVALID_ROWS": "64", "MAX_BATCH_SIZE": "4",
    "FUSED_IDLE_FASTPATH": "false", "GANG_WINDOW_MS": "10", "MESH_SHAPE": "1",
    "DTYPE": "float32",
}


def test_default_settings_match():
    assert dataclasses.asdict(config.Settings()) == dataclasses.asdict(ref.Settings())
    assert [f.name for f in dataclasses.fields(config.Settings)] == [
        f.name for f in dataclasses.fields(ref.Settings)]


@pytest.mark.parametrize("env", [{}, ENV], ids=["empty", "every_variable"])
def test_load_settings_matches(monkeypatch, env):
    for key in ENV:
        monkeypatch.delenv(PRE + key, raising=False)
    monkeypatch.delenv("GRPC_TLS_CA_PATH", raising=False)
    monkeypatch.delenv("SSTW_CVALID_ROWS", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(PRE + key, value)
    if env:
        monkeypatch.setenv("GRPC_TLS_CA_PATH", "/ca.pem")
    got, want = config.load_settings(), ref.load_settings()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if env:
        assert got.logprob_threshold == -0.5 and got.model_filename == "ggml-large-v3.bin"


def test_beam_size_above_the_kernels_is_refused(monkeypatch):
    assert config.MAX_BEAM_SIZE == MAX_BEAMS
    monkeypatch.setenv(PRE + "BEAM_SIZE", str(MAX_BEAMS))
    assert config.load_settings().beam_size == MAX_BEAMS
    monkeypatch.setenv(PRE + "BEAM_SIZE", str(MAX_BEAMS + 1))
    with pytest.raises(ValueError, match="beam_size"):
        config.load_settings()
    assert ref.load_settings().beam_size == MAX_BEAMS + 1  # the JAX package takes it
