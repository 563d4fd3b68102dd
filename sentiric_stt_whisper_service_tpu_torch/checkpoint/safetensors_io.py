"""Safetensors / HF-transformers Whisper checkpoint loader.

A copy of the JAX package's ``checkpoint/safetensors_io.py``: HF
``model.safetensors`` with ``model.encoder.layers.N.*`` naming
(WhisperForConditionalGeneration) or the bare ``encoder.layers.N.*``
variant (WhisperModel). The name mapping is the same numpy; the last step
builds a ``Whisper`` module through ``models/params.from_jax_numpy``. The
file is read here (``read_safetensors``: an 8-byte header length, a JSON
header, the raw tensors), so the port needs no ``safetensors`` package.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..models.params import from_jax_numpy, stack_layers
from ..models.whisper import Whisper, WhisperConfig

_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
           "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a numpy array (BF16 as fp32)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        raw = data[a:b]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, _DTYPES[info["dtype"]])
        out[name] = arr.reshape(info["shape"])
    return out


def _strip_prefix(name: str) -> str:
    for p in ("model.", "whisper."):
        if name.startswith(p):
            name = name[len(p) :]
    return name


def tree_from_hf_state(state: dict[str, np.ndarray], dtype=torch.bfloat16):
    """Map an HF whisper state dict → (config, the JAX package's parameter
    layout with fp32 numpy leaves)."""
    t = {_strip_prefix(k): v for k, v in state.items()}

    def dims():
        n_mels = t["encoder.conv1.weight"].shape[1]
        d_a = t["encoder.conv1.weight"].shape[0]
        n_vocab, d_t = t["decoder.embed_tokens.weight"].shape
        n_audio_layer = 1 + max(
            int(k.split(".")[2]) for k in t if k.startswith("encoder.layers.")
        )
        n_text_layer = 1 + max(
            int(k.split(".")[2]) for k in t if k.startswith("decoder.layers.")
        )
        n_audio_ctx = t["encoder.embed_positions.weight"].shape[0]
        n_text_ctx = t["decoder.embed_positions.weight"].shape[0]
        # Heads follow the official family ratios (d/64).
        return WhisperConfig(
            n_mels=n_mels, n_vocab=n_vocab,
            n_audio_ctx=n_audio_ctx, n_audio_state=d_a,
            n_audio_head=d_a // 64, n_audio_layer=n_audio_layer,
            n_text_ctx=n_text_ctx, n_text_state=d_t,
            n_text_head=d_t // 64, n_text_layer=n_text_layer,
            dtype=dtype,
        )

    cfg = dims()

    def lin(prefix, bias=True):
        p = {"w": np.asarray(np.asarray(t[prefix + ".weight"]).T, np.float32)}
        if bias:
            p["b"] = np.asarray(t[prefix + ".bias"], np.float32)
        return p

    def ln(prefix):
        return {
            "g": np.asarray(t[prefix + ".weight"], np.float32),
            "b": np.asarray(t[prefix + ".bias"], np.float32),
        }

    def attn(prefix):
        return {
            "q": lin(prefix + ".q_proj"),
            "k": lin(prefix + ".k_proj", bias=False),
            "v": lin(prefix + ".v_proj"),
            "o": lin(prefix + ".out_proj"),
        }

    def block(side, i, cross):
        p = f"{side}.layers.{i}"
        d = {
            "attn_ln": ln(p + ".self_attn_layer_norm"),
            "attn": attn(p + ".self_attn"),
            "mlp_ln": ln(p + ".final_layer_norm"),
            "mlp_1": lin(p + ".fc1"),
            "mlp_2": lin(p + ".fc2"),
        }
        if cross:
            d["cross_attn_ln"] = ln(p + ".encoder_attn_layer_norm")
            d["cross_attn"] = attn(p + ".encoder_attn")
        return d


    def conv(prefix):
        return {
            "w": np.asarray(
                np.asarray(t[prefix + ".weight"]).transpose(2, 1, 0), np.float32
            ),
            "b": np.asarray(t[prefix + ".bias"], np.float32),
        }

    params = {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "conv2": conv("encoder.conv2"),
            "pos": np.asarray(t["encoder.embed_positions.weight"], np.float32),
            "blocks": stack_layers(
                [block("encoder", i, False) for i in range(cfg.n_audio_layer)]
            ),
            "ln_post": ln("encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": np.asarray(t["decoder.embed_tokens.weight"], np.float32),
            "pos_emb": np.asarray(t["decoder.embed_positions.weight"], np.float32),
            "blocks": stack_layers(
                [block("decoder", i, True) for i in range(cfg.n_text_layer)]
            ),
            "ln": ln("decoder.layer_norm"),
        },
    }
    return cfg, params


def params_from_hf_state(state: dict[str, np.ndarray], dtype=torch.bfloat16,
                         device="cpu") -> tuple[WhisperConfig, Whisper]:
    """Map an HF whisper state dict → (config, ``Whisper`` on ``device``)."""
    cfg, tree = tree_from_hf_state(state, dtype)
    return cfg, from_jax_numpy(tree, cfg, device, dtype)


def load_safetensors(path: str, dtype=torch.bfloat16, device="cpu"):
    """Load an HF safetensors checkpoint → (config, ``Whisper``)."""
    return params_from_hf_state(read_safetensors(path), dtype, device)
