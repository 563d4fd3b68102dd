from .resample import resample  # noqa: F401
from .wav import (  # noqa: F401
    DecodedAudio,
    decode_with_ffmpeg,
    has_wav_header,
    parse_wav_robust,
    pcm16_to_f32,
    write_wav,
)
