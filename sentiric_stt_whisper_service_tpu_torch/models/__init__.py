from .beam import decode_window_beam, topk_small  # noqa: F401
from .graphs import DecodeGraphs  # noqa: F401
from .sampling import (  # noqa: F401
    DecodeResult,
    TokenIds,
    apply_timestamp_rules,
    build_suppress_mask,
    decode_window,
    decode_window_best_of,
    detect_language,
)
from .whisper import (  # noqa: F401
    Whisper,
    WhisperConfig,
    config_for,
    decoder_apply,
    decoder_step,
    decoder_step_beam,
    encode_xa_kv,
    encode_xa_kv_q,
    encoder_apply,
    init_kv_cache,
    init_params,
    param_count,
    precompute_xa_kv,
    sinusoids,
)
