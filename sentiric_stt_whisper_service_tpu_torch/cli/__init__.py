"""The gRPC test client (``python -m sentiric_stt_whisper_service_tpu_torch.cli``)."""

from .main import main  # noqa: F401
