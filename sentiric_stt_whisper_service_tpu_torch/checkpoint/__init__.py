"""Checkpoint loading: GGML .bin (whisper.cpp) and safetensors (HF); and
the parameters' own save / restore (``save_params`` / ``restore_params``).

The JAX package saves a parameter pytree with Orbax (a checkpoint
directory). The port writes one safetensors file instead: the parameter
tree flattened to the JAX package's dotted names (``decoder.blocks.attn.q.w``,
each layer's leaves stacked on a leading axis), fp32, through a temporary
file renamed into place.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..config import Settings
from ..models.params import from_jax_numpy, to_numpy_tree
from ..models.whisper import Whisper, WhisperConfig
from ..tokenizer import WhisperTokenizer, fallback_tokenizer
from .ggml import load_ggml, write_ggml  # noqa: F401
from .manager import ModelManager  # noqa: F401
from .safetensors_io import (  # noqa: F401
    flatten_tree,
    load_safetensors,
    read_safetensors,
    unflatten_tree,
    write_safetensors,
)


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


# ---------------------------------------------------------------------------
# Save / restore of the parameters (fine-tuning state; the counterpart of the
# JAX package's Orbax save_params / restore_params)
# ---------------------------------------------------------------------------


def save_params(path: str, params) -> None:
    """Save ``params`` (an unquantized, unfused ``Whisper``, or a nested
    dict of arrays or tensors) to the safetensors file ``path``, atomically:
    written to a temporary file beside it, then renamed over it."""
    tree = to_numpy_tree(params) if isinstance(params, Whisper) else params
    target = Path(path).resolve()
    fd, tmp = tempfile.mkstemp(prefix=target.name + ".", suffix=".tmp", dir=target.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            write_safetensors(f, flatten_tree(tree), metadata={"format": "sstw-params"})
        os.replace(tmp, target)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def restore_params(path: str, like=None):
    """Restore what :func:`save_params` wrote: the nested dict of numpy
    arrays, or with ``like`` its form: a ``Whisper`` like ``like`` (its
    config, dtype and device), or for a dict each leaf in the dtype and on
    the device of ``like``'s leaf (numpy leaves stay numpy)."""
    tree = unflatten_tree(read_safetensors(str(Path(path).resolve())))
    if like is None:
        return tree
    if isinstance(like, Whisper):
        device = next(like.parameters()).device
        return from_jax_numpy(tree, like.cfg, device, like.cfg.dtype)

    def cast(value, ref):
        if isinstance(ref, dict):
            return {k: cast(value[k], r) for k, r in ref.items()}
        if isinstance(ref, torch.Tensor):
            return torch.from_numpy(np.array(value)).to(ref.device, ref.dtype)
        return np.asarray(value, np.asarray(ref).dtype)

    return cast(tree, like)
