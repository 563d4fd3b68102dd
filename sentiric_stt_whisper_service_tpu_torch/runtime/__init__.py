from .engine import (  # noqa: F401
    EngineBusyException,
    PerformanceMetrics,
    RequestOptions,
    SttEngine,
    TokenData,
    TranscriptionResult,
)
from .vad import is_speech_detected, set_vad_model  # noqa: F401
from .streaming import StreamEvent, StreamingSession  # noqa: F401
