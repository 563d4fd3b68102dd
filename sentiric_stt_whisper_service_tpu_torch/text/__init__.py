from .filters import (  # noqa: F401
    BANNED_PHRASES,
    SHORT_NOISES,
    clean_utf8,
    is_hallucination,
)
