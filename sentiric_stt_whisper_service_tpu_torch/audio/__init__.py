from .resample import resample  # noqa: F401
from .wav import parse_wav_robust, pcm16_to_f32, write_wav  # noqa: F401
