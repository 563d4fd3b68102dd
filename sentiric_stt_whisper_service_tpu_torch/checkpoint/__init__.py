"""Checkpoint loading: GGML .bin (whisper.cpp) and safetensors (HF).

The JAX package's Orbax ``save_params`` / ``restore_params`` (fine-tuning
state of a JAX pytree) are not ported: they are JAX-only, and the port's
counterpart waits for the checkpoint converter (ROADMAP queue 1 item 16).
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..config import Settings
from ..models.whisper import WhisperConfig
from ..tokenizer import WhisperTokenizer, fallback_tokenizer
from .ggml import load_ggml, write_ggml  # noqa: F401
from .manager import ModelManager  # noqa: F401
from .safetensors_io import load_safetensors  # noqa: F401


def load_checkpoint(settings: Settings, cfg: WhisperConfig | None = None, device="cpu"):
    """Resolve + load the configured checkpoint → (model, tokenizer), the
    model a ``Whisper`` on ``device`` in ``settings.dtype``.

    GGML files carry their vocab (→ exact tokenizer); safetensors fall back
    to a sibling vocab.json or the byte-fallback tokenizer.
    """
    path = Path(settings.model_dir) / settings.model_filename
    if not path.exists():
        ModelManager.ensure_model(settings)
    dtype = torch.bfloat16 if settings.dtype == "bfloat16" else torch.float32
    if path.suffix == ".safetensors":
        file_cfg, model = load_safetensors(str(path), dtype, device)
        tok = _sibling_tokenizer(path, file_cfg)
        return model, tok
    file_cfg, model, vocab_tokens, n_vocab = load_ggml(str(path), dtype, device)
    if vocab_tokens:
        try:
            tok = WhisperTokenizer.from_ggml_vocab(vocab_tokens, n_vocab)
        except Exception:
            tok = fallback_tokenizer(n_vocab)
    else:
        tok = fallback_tokenizer(n_vocab)
    return model, tok


def _sibling_tokenizer(path: Path, cfg: WhisperConfig):
    vocab_json = path.parent / "vocab.json"
    if vocab_json.exists():
        return WhisperTokenizer.from_hf_files(str(vocab_json), cfg.num_languages)
    return fallback_tokenizer(cfg.n_vocab)
