"""Hallucination filtering + UTF-8 sanitation.

A copy of the JAX package's ``text/filters.py``, itself a byte-for-byte
behavioral port of the reference service's filter (its utils.h:214-306
``is_hallucination``, :65-99 ``clean_utf8``). Notes on fidelity:

  * lengths are UTF-8 *byte* lengths (C++ ``std::string::length``);
  * lowercase is ASCII-only (C++ ``::tolower`` ignores multibyte chars —
    which is exactly why the banned list carries Turkish case variants);
  * punctuation stripping is ASCII ``ispunct`` from both ends.
"""

from __future__ import annotations

# Banned phrase list (utils.h:224-261) — Whisper subtitle-artifact
# hallucinations in Turkish/English/Japanese.
BANNED_PHRASES = (
    "altyazı", "Altyazı", "ALTYAZI",
    "sesli betimleme", "Sesli betimleme",
    "senkron", "Senkron",
    "www.", ".com",
    "izlediğiniz için", "İzlediğiniz için", "İZLEDİĞİNİZ İÇİN",
    "teşekkürler", "Teşekkürler", "TEŞEKKÜRLER",
    "teşekkür ederim", "Teşekkür ederim", "TEŞEKKÜR EDERİM",
    "thank you", "Thank you", "Thanks for watching",
    "abone ol", "Abone ol",
    "videoyu beğen", "bir sonraki videoda",
    "devam edecek", "Devam edecek",
    "transcription:", "subtitle:",
    "2分", "ご視聴",
    "I'm going to go",
    "Okay.", "Bye.", "Ahem.", "Ahem",
    "Umarım", "umarım",
)

# Short interjection noises (utils.h:297-299).
SHORT_NOISES = (
    "Hıhı", "hıhı", "Pffft", "pffft", "Ehem", "ehem", "Hmm", "hmm",
    "Aa", "aa", "Ah", "ah", "Oh", "oh", "Eh", "eh",
)

_WS = " \t\n\r\f\v"
_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")  # ASCII ispunct


def _ascii_lower(s: str) -> str:
    return "".join(chr(ord(c) + 32) if "A" <= c <= "Z" else c for c in s)


def _strip_punct(s: str) -> str:
    while s and s[-1] in _PUNCT:
        s = s[:-1]
    while s and s[0] in _PUNCT:
        s = s[1:]
    return s


def _blen(s: str) -> int:
    return len(s.encode("utf-8"))


def is_hallucination(raw_text: str) -> bool:
    """True if the segment text is a known Whisper hallucination pattern."""
    text = raw_text.strip(_WS)
    if not text:
        return True
    if _blen(text) < 2:
        return True
    if all(c in " \t\n\v\f\r.,?!" for c in text):
        return True
    if text.startswith("[") and text.endswith("]"):
        return True
    if text.startswith("(") and text.endswith(")"):
        return True

    lower = _ascii_lower(text)
    for phrase in BANNED_PHRASES:
        if _blen(phrase) > 4 and (phrase in lower or phrase in text):
            return True

    stripped = _strip_punct(lower)
    stripped_orig = _strip_punct(text)
    for phrase in BANNED_PHRASES:
        if _blen(phrase) <= 6:
            if stripped == _ascii_lower(phrase) or stripped_orig == phrase:
                return True

    for noise in SHORT_NOISES:
        if stripped == noise or stripped_orig == noise:
            return True
    return False


def clean_utf8(data) -> str:
    """Drop invalid UTF-8 sequences, keep valid ones (utils.h:65-99
    algorithm: leading-byte classification + continuation check only)."""
    if isinstance(data, str):
        raw = data.encode("utf-8", errors="surrogateescape")
    else:
        raw = bytes(data)
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        c = raw[i]
        if c < 0x80:
            size = 1
        elif (c & 0xE0) == 0xC0:
            size = 2
        elif (c & 0xF0) == 0xE0:
            size = 3
        elif (c & 0xF8) == 0xF0:
            size = 4
        else:
            i += 1
            continue
        if i + size > n:
            break
        if all((raw[i + j] & 0xC0) == 0x80 for j in range(1, size)):
            out += raw[i : i + size]
            i += size
        else:
            i += 1
    return out.decode("utf-8", errors="replace")
