"""Byte-level BPE tokenizer for Whisper, with its own rank engine.

The JAX package builds a ``tiktoken.Encoding`` over the same ranks. This
copy needs no ``tiktoken``: decoding concatenates the byte strings of the
inverted rank table, and encoding runs the same pre-split and the same
lowest-rank-first pair merging as tiktoken over the same ranks.

Vocab sources, as in the JAX package: a GGML checkpoint's embedded vocab
(rank-ordered byte strings), HF-style ``vocab.json`` on disk, a
``*.tiktoken`` ranks file, any rank table (``WhisperTokenizer(ranks)``), or
the offline byte-fallback vocab.
"""

from __future__ import annotations

import base64
import functools
import json
import re
import sys
import unicodedata
from typing import Iterable, Optional, Sequence

from .whisper_tokens import SpecialTokens, layout_for_vocab

# The GPT-2 pre-split pattern tiktoken is given:
#   's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
# stdlib ``re`` has no \p{..} classes, and its \s differs from the Unicode
# White_Space property that tiktoken's regex engine uses, so all three
# classes are spelled out as explicit code-point ranges.
_WHITE_SPACE = (
    (0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
    (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
    (0x3000, 0x3000),
)


def _category_ranges() -> dict[str, list[tuple[int, int]]]:
    """Code-point ranges of the Unicode letters ("L") and numbers ("N"),
    by general category, in one pass over the code space."""
    out: dict[str, list[tuple[int, int]]] = {"L": [], "N": []}
    run_cls, run_start = None, 0
    for cp in range(sys.maxunicode + 2):
        cls = unicodedata.category(chr(cp))[0] if cp <= sys.maxunicode else None
        cls = cls if cls in out else None
        if cls != run_cls:
            if run_cls is not None:
                out[run_cls].append((run_start, cp - 1))
            run_cls, run_start = cls, cp
    return out


def _class_body(ranges) -> str:
    return "".join(
        f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges
    )


@functools.lru_cache(maxsize=1)
def _split_regex() -> re.Pattern:
    classes = _category_ranges()
    letters = _class_body(classes["L"])
    numbers = _class_body(classes["N"])
    space = _class_body(_WHITE_SPACE)
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+"
        rf"| ?[^{space}{letters}{numbers}]+|[{space}]+(?![^{space}])|[{space}]+"
    )


def _gpt2_byte_encoder() -> dict[int, str]:
    """GPT-2's reversible byte↔unicode mapping (for vocab.json decoding)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _bpe_merge(ranks: dict[bytes, int], piece: bytes) -> list[int]:
    """tiktoken's merge rule: repeatedly join the adjacent pair whose
    concatenation has the lowest rank (the leftmost on a tie)."""
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_i, best_rank = -1, None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_i, best_rank = i, r
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return [ranks[p] for p in parts]


class WhisperTokenizer:
    """Whisper text tokenizer: byte-level BPE + special-token layout."""

    def __init__(
        self,
        mergeable_ranks: dict[bytes, int],
        num_languages: int = 99,
    ):
        self.ranks = mergeable_ranks
        self.special = SpecialTokens(len(mergeable_ranks), num_languages)
        self._pieces = {rank: piece for piece, rank in mergeable_ranks.items()}

    # -- core ---------------------------------------------------------------
    @property
    def n_vocab(self) -> int:
        return self.special.n_vocab

    @property
    def eot(self) -> int:
        return self.special.eot

    def encode(self, text: str) -> list[int]:
        """Special-token strings in ``text`` encode as plain text (tiktoken's
        ``disallowed_special=()``)."""
        out: list[int] = []
        for m in _split_regex().finditer(text):
            piece = m.group().encode("utf-8")
            rank = self.ranks.get(piece)
            out.extend([rank] if rank is not None else _bpe_merge(self.ranks, piece))
        return out

    def _join(self, ids: Iterable[int]) -> bytes:
        return b"".join(self._pieces[int(i)] for i in ids)

    def decode(self, ids: Iterable[int]) -> str:
        ids = [int(i) for i in ids if int(i) < self.special.eot]
        return self._join(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return self._join(i for i in ids if int(i) < self.special.eot)

    def decode_with_timestamps(self, ids: Iterable[int]) -> str:
        out: list[str] = []
        chunk: list[int] = []
        for i in map(int, ids):
            if i >= self.special.eot:
                if chunk:
                    out.append(self.decode(chunk))
                    chunk = []
                if i != self.special.eot:
                    out.append(self.special.special_token_string(i))
            else:
                chunk.append(i)
        if chunk:
            out.append(self.decode(chunk))
        return "".join(out)

    def token_piece(self, token_id: int) -> str:
        """Single-token text (special tokens render as <|...|>)."""
        token_id = int(token_id)
        if token_id >= self.special.eot:
            return self.special.special_token_string(token_id)
        return self.decode([token_id])

    # -- prompt assembly ----------------------------------------------------
    def sot_sequence(
        self,
        language: Optional[str] = None,
        task: str = "transcribe",
        with_timestamps: bool = True,
    ) -> list[int]:
        """[sot, lang, task(, notimestamps)] decoder preamble."""
        s = self.special
        seq = [s.sot]
        if language is not None:
            seq.append(s.language_token(language))
            seq.append(s.translate if task == "translate" else s.transcribe)
        if not with_timestamps:
            seq.append(s.no_timestamps)
        return seq

    # -- suppression sets ---------------------------------------------------
    @functools.cached_property
    def non_speech_tokens(self) -> tuple[int, ...]:
        """Tokens for music/annotation symbols, suppressed when suppress_nst
        is on. Mirrors openai-whisper's dynamic computation against the
        active vocab."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for symbol in symbols + list(miscellaneous):
            for tok in [symbol, " " + symbol]:
                ids = self.encode(tok)
                if len(ids) == 1:
                    result.add(ids[0])
                elif symbol in miscellaneous and ids:
                    result.add(ids[0])
        # whisper also suppresses " -" and " '" first tokens
        for tok in [" -", " '"]:
            ids = self.encode(tok)
            if len(ids) == 1:
                result.add(ids[0])
        return tuple(sorted(result))

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_ggml_vocab(cls, tokens: Sequence[bytes], n_vocab: int) -> "WhisperTokenizer":
        """Build from a GGML checkpoint's embedded vocab (rank order).

        ``tokens`` are the raw byte strings stored in the .bin file;
        ``n_vocab`` is the model's full vocab size (incl. specials).
        """
        layout = layout_for_vocab(n_vocab)
        base = tokens[: layout.base_vocab]
        ranks = {bytes(t): i for i, t in enumerate(base)}
        if len(ranks) != layout.base_vocab:
            raise ValueError("duplicate tokens in GGML vocab")
        return cls(ranks, layout.num_languages)

    @classmethod
    def from_hf_files(cls, vocab_json: str, num_languages: int = 99):
        """Build from HF-style vocab.json (gpt2 byte-encoder strings)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        byte_dec = {v: k for k, v in _gpt2_byte_encoder().items()}
        ranks: dict[bytes, int] = {}
        for tok_str, rank in vocab.items():
            if tok_str.startswith("<|"):
                continue  # specials are derived from the layout
            ranks[bytes(byte_dec[c] for c in tok_str)] = rank
        return cls(ranks, num_languages)

    @classmethod
    def from_tiktoken_file(cls, path: str, num_languages: int = 99):
        """Build from a ``*.tiktoken`` ranks file (base64 token, rank per line)."""
        ranks = {}
        with open(path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
        return cls(ranks, num_languages)

    @classmethod
    def byte_fallback(cls, base_vocab: int = 256, num_languages: int = 99):
        """Offline test tokenizer: 256 single-byte tokens (+ padding ranks).

        Exact round-trip for any text, no merges. Used when no real vocab is
        available (zero-egress environments, unit tests).
        """
        ranks = {bytes([i]): i for i in range(256)}
        # Pad with unreachable multi-byte ranks if a larger base is requested
        # (e.g. to mimic a real model's vocab size).
        i = 256
        while len(ranks) < base_vocab:
            ranks[b"\x00" + i.to_bytes(3, "big")] = i
            i += 1
        return cls(ranks, num_languages)


@functools.lru_cache(maxsize=2)
def fallback_tokenizer(n_vocab: int = 51865) -> WhisperTokenizer:
    """Offline tokenizer whose special-token layout matches a real model's
    ``n_vocab`` (default: multilingual 51865). Text round-trips exactly via
    byte tokens; filler ranks pad the base vocab so ids line up with the
    model's logits."""
    layout = layout_for_vocab(n_vocab)
    return WhisperTokenizer.byte_fallback(
        base_vocab=layout.base_vocab, num_languages=layout.num_languages
    )
