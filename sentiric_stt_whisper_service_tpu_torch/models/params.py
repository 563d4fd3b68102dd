"""Carry the JAX package's parameters across into this package's modules,
and back.

``from_jax_numpy`` takes the JAX package's parameter pytree with its leaves
already converted to numpy (``jax.tree.map(np.asarray, params)``, done by
the caller so this package never imports JAX) and returns a ``Whisper``
module holding the same values. Each stacked ``[L, ...]`` leaf is unstacked
into its layer's submodule. Quantized and fused leaves map as well
(``w_q``/``scale``, the fused ``attn.qkv``, ``tok_emb_q``/``tok_emb_scale``),
so a test can quantize on either side and compare. ``to_numpy_tree`` is
the inverse for an unquantized module: the same pytree layout with numpy
leaves (the checkpoint writer's input, and what tests compare).
``silero_from_numpy`` carries the JAX package's Silero VAD parameters
across (the same names and torch layouts on both sides).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .whisper import Attention, Dense, LayerNorm, Whisper, WhisperConfig, _param

_FP32_LEAVES = ("scale", "tok_emb_scale")  # quantization scales stay fp32


def _tensor(a, name: str, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.from_numpy(a.copy()).to(device)
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(device, torch.float32 if name in _FP32_LEAVES else dtype)


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def from_jax_numpy(tree: dict, cfg: WhisperConfig, device, dtype=None) -> Whisper:
    """Reference parameter pytree (numpy leaves) → ``Whisper`` on ``device``.
    Float leaves become ``dtype`` (default ``cfg.dtype``); int8 leaves and
    quantization scales keep their types."""
    dtype = dtype or cfg.dtype
    model = Whisper(dataclasses.replace(cfg, dtype=dtype), device)

    def t(a, name=""):
        return _tensor(a, name, dtype, device)

    def fill_dense(m: Dense, leaf: dict) -> None:
        b = t(leaf["b"]) if "b" in leaf else None
        if "w_q" in leaf:
            m.assign(w_q=t(leaf["w_q"]), scale=t(leaf["scale"], "scale"), b=b)
        else:
            m.assign(w=t(leaf["w"]), b=b)

    def fill(module: torch.nn.Module, leaf: dict) -> None:
        for name, sub in leaf.items():
            child = getattr(module, name)
            if isinstance(child, Dense):
                fill_dense(child, sub)
            elif isinstance(child, LayerNorm):
                child.g, child.b = _param(t(sub["g"])), _param(t(sub["b"]))
            elif isinstance(child, Attention) and "qkv" in sub:
                child.qkv = Dense()
                fill_dense(child.qkv, sub["qkv"])
                fill_dense(child.o, sub["o"])
                child.q = child.k = child.v = None
            else:
                fill(child, sub)

    enc, dec = tree["encoder"], tree["decoder"]
    m_enc, m_dec = model.encoder, model.decoder
    m_enc.conv1_w, m_enc.conv1_b = _param(t(enc["conv1"]["w"])), _param(t(enc["conv1"]["b"]))
    m_enc.conv2_w, m_enc.conv2_b = _param(t(enc["conv2"]["w"])), _param(t(enc["conv2"]["b"]))
    m_enc.pos = t(enc["pos"])
    for i, block in enumerate(m_enc.blocks):
        fill(block, _layer(enc["blocks"], i))
    fill(m_enc, {"ln_post": enc["ln_post"]})

    if "tok_emb_q" in dec:
        m_dec.set_quantized_embedding(t(dec["tok_emb_q"]), t(dec["tok_emb_scale"], "tok_emb_scale"))
    else:
        m_dec.tok_emb = _param(t(dec["tok_emb"]))
    m_dec.pos_emb = _param(t(dec["pos_emb"]))
    for i, block in enumerate(m_dec.blocks):
        fill(block, _layer(dec["blocks"], i))
    fill(m_dec, {"ln": dec["ln"]})
    return model


def silero_from_numpy(tree: dict, device) -> dict:
    """The JAX package's Silero VAD parameters with numpy leaves
    (``jax.tree.map(np.asarray, params)``) → ``models/silero_vad``'s dict of
    fp32 tensors on ``device``. Both packages keep torch's layouts (conv
    weights OIT, LSTM gates i, f, g, o), so every leaf carries over as it
    is."""
    return {name: torch.from_numpy(np.array(a, np.float32)).to(device)
            for name, a in tree.items()}


def stack_layers(per_layer: list[dict]) -> dict:
    """Per-layer trees → one tree with each leaf stacked on a leading axis."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: stack_layers([p[k] for p in per_layer]) for k in first}
    return np.stack(per_layer)


def to_numpy_tree(model: Whisper) -> dict:
    """An unquantized, unfused ``Whisper`` → the JAX package's parameter
    pytree with fp32 numpy leaves, each layer's leaves stacked on a leading
    ``[L]`` axis."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    def tree(module: torch.nn.Module) -> dict:
        out = {}
        for name, child in module.named_children():
            if isinstance(child, Dense):
                out[name] = {"w": leaf(child.w)} | ({"b": leaf(child.b)} if child.b is not None
                                                    else {})
            elif isinstance(child, LayerNorm):
                out[name] = {"g": leaf(child.g), "b": leaf(child.b)}
            else:
                out[name] = tree(child)
        return out

    enc, dec = model.encoder, model.decoder
    return {
        "encoder": {
            "conv1": {"w": leaf(enc.conv1_w), "b": leaf(enc.conv1_b)},
            "conv2": {"w": leaf(enc.conv2_w), "b": leaf(enc.conv2_b)},
            "pos": leaf(enc.pos),
            "blocks": stack_layers([tree(b) for b in enc.blocks]),
            "ln_post": tree(enc)["ln_post"],
        },
        "decoder": {
            "tok_emb": leaf(dec.tok_emb),
            "pos_emb": leaf(dec.pos_emb),
            "blocks": stack_layers([tree(b) for b in dec.blocks]),
            "ln": tree(dec)["ln"],
        },
    }
