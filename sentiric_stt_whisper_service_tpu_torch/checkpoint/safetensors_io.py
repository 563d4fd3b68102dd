"""Safetensors / HF-transformers Whisper checkpoint loader.

A copy of the JAX package's ``checkpoint/safetensors_io.py``: HF
``model.safetensors`` with ``model.encoder.layers.N.*`` naming
(WhisperForConditionalGeneration) or the bare ``encoder.layers.N.*``
variant (WhisperModel). The name mapping is the same numpy; the last step
builds a ``Whisper`` module through ``models/params.from_jax_numpy``. The
format is read and written here (``read_safetensors`` /
``write_safetensors``: an 8-byte little-endian header length, a JSON
header padded to 8 bytes, the raw little-endian tensors), so the port needs
no ``safetensors`` package. ``flatten_tree`` / ``unflatten_tree`` map a
parameter tree to and from its dotted names (the JAX package's converter
walk), the layout of ``checkpoint.save_params``.
"""

from __future__ import annotations

import json
import os
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


_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _raw(value) -> tuple[str, tuple, bytes]:
    """(dtype code, shape, little-endian bytes) of an array or a tensor;
    a bfloat16 tensor is written as BF16."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return "BF16", tuple(value.shape), value.view(torch.int16).numpy().tobytes()
        value = value.numpy()
    a = np.asarray(value)
    code = _CODES.get(a.dtype.newbyteorder("<"))
    if code is None:
        raise ValueError(f"safetensors: no dtype code for {a.dtype}")
    return code, a.shape, np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tobytes()


def write_safetensors(path, tensors: dict, metadata: dict | None = None) -> None:
    """Write ``tensors`` (name → numpy array or torch tensor) as a
    safetensors file that ``read_safetensors`` and the ``safetensors``
    package load. The tensors follow each other with no gap, the wider
    element types first and by name within a width, so each starts aligned
    to its element size; the header is padded with spaces so the data
    starts 8-byte aligned. ``path`` is a path or a binary file."""
    raws = {name: _raw(v) for name, v in tensors.items()}
    def width(name):
        code = raws[name][0]
        return 2 if code == "BF16" else np.dtype(_DTYPES[code]).itemsize

    order = sorted(raws, key=lambda n: (-width(n), n))
    header, at = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in order:
        code, shape, data = raws[name]
        header[name] = {"dtype": code, "shape": list(shape), "data_offsets": [at, at + len(data)]}
        at += len(data)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    f = open(path, "wb") if isinstance(path, (str, os.PathLike)) else path
    try:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(raws[name][2])
    finally:
        if f is not path:
            f.close()


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict → {dotted name: leaf}, the JAX package's converter walk."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flatten_tree(v, name) if isinstance(v, dict) else {name: v})
    return out


def unflatten_tree(flat: dict) -> dict:
    """The inverse of ``flatten_tree``."""
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


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
