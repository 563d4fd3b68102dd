"""Weight-only int8 quantization and the int8/int4 cross-K/V slabs.

Integer tensors and scales are bit-equal to the JAX package's
``ops/quant.py`` as that package runs it: the same fp32 scale arithmetic,
round-half-to-even, clip and ``1e-12`` scale floor.

Layouts:
  * dense ``w [.., d_in, d_out]`` → ``w_q`` int8 + ``scale`` f32 ``[d_out]``
    (symmetric, per output channel: axis ``-2`` reduced).
  * embedding ``[V, d]`` → int8 + per-row scale ``[V]``.
  * cross K/V ``[L, B, H, hd, F]`` (KF layout) → int8 + per-position scale
    ``[L, B, H, F]`` (reduced over hd), or the packed int4 carrier
    ``[L, B, H, hd, F/2]``: byte j = (q[j + F/2] << 4) | (q[j] & 0xF).

The port keeps the packed carrier as its storage: the int4 kernel
(``ops/decode_attention.decode_attention_i4``) reads it as it is.

``quantize_params`` and ``fuse_decoder_qkv`` change a ``models/whisper.Whisper``
module in place (a large-v3 copy would double its device memory) and return
it.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quantize_weight(w: torch.Tensor, axis: int = -2):
    """Symmetric int8 quantization reducing over ``axis``.

    Returns (w_q int8, scale f32 with ``axis`` removed)."""
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=axis)
    scale = torch.clamp(amax / 127.0, min=_EPS)
    w_q = torch.clamp(torch.round(w32 / scale.unsqueeze(axis)), -127, 127).to(torch.int8)
    return w_q, scale


def _quantize_kv(x: torch.Tensor, bits: int):
    """[.., hd, F] → (int8 values or packed int4 carrier, scale [.., F]).

    The JAX package quantizes the cross slab inside ``jit``, where XLA
    turns ``amax / qmax`` into ``amax * fp32(1 / qmax)``; the same product
    here keeps the scales bit-equal. (Weights are quantized outside ``jit``
    there, with a true division: ``quantize_weight``.)"""
    qmax = 7.0 if bits == 4 else 127.0
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-2)
    scale = torch.clamp(amax * (1.0 / qmax), min=_EPS)
    q = torch.clamp(torch.round(x32 / scale.unsqueeze(-2)), -qmax, qmax).to(torch.int8)
    return (_pack_nibbles(q) if bits == 4 else q), scale


def quantize_xa_kv(xa_kv: dict, bits: int = 8) -> dict:
    """Quantize a cross-attention KV dict ``{"k","v"}: [L,B,H,hd,F]`` (KF
    layout) → ``{"k_q","v_q"}`` int8 (bits=8) or ``{"k_p","v_p"}`` packed
    int4 (bits=4), plus ``"k_scale","v_scale"`` f32 ``[L,B,H,F]``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k, k_scale = _quantize_kv(xa_kv["k"], bits)
    v, v_scale = _quantize_kv(xa_kv["v"], bits)
    names = ("k_p", "v_p") if bits == 4 else ("k_q", "v_q")
    return {names[0]: k, "k_scale": k_scale, names[1]: v, "v_scale": v_scale}


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] along the last axis (even length F) →
    packed int8 [.., F/2]: byte j = (q[j + F/2] << 4) | (q[j] & 0xF).
    ``q << 4`` stays inside int8's range for |q| ≤ 8, so nothing wraps."""
    F = q.shape[-1]
    if F % 2:
        raise ValueError(f"int4 packing needs an even last axis, got {F}")
    lo = q[..., : F // 2] & 0x0F
    hi = torch.bitwise_left_shift(q[..., F // 2 :], 4)
    return (hi | lo).to(torch.int8)


def unpack_nibbles_i8(p: torch.Tensor) -> torch.Tensor:
    """Packed int8 [.., F/2] → int8 [.., F] holding the int4 values in
    original position order (low nibbles are positions [0, F/2))."""
    lo = ((p & 0x0F) ^ 8) - 8  # sign-extend the low nibble
    hi = torch.bitwise_right_shift(p, 4)  # arithmetic shift on int8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def unpack_xa_kv(xa_kv: dict) -> dict:
    """Packed int4 carrier → int8 KV dict holding the int4 values; any
    other dict passes through. For the plain (T > 1) cross-attention."""
    if "k_p" not in xa_kv:
        return xa_kv
    return {
        "k_q": unpack_nibbles_i8(xa_kv["k_p"]),
        "k_scale": xa_kv["k_scale"],
        "v_q": unpack_nibbles_i8(xa_kv["v_p"]),
        "v_scale": xa_kv["v_scale"],
    }


def _dense_modules(model):
    from ..models.whisper import Dense

    return [m for m in model.modules() if isinstance(m, Dense)]


def _refuse_shard(model, name: str) -> None:
    if getattr(model, "mesh", None) is not None:
        raise ValueError(f"{name}: the model is a tensor-parallel shard (parallel/mesh.py)")


def quantize_params(model, encoder: bool = True, embedding: bool = True):
    """Quantize a ``Whisper`` module to weight-only int8, in place.

    Transformer-block dense weights (and optionally the token embedding)
    become int8; conv stems, positional embeddings and layer norms keep
    their dtype. ``models/whisper.dense`` dispatches on ``w_q``. A
    tensor-parallel shard is refused: quantize, then shard, as the JAX
    package does (a row-parallel layer's scales span every shard's rows)."""
    _refuse_shard(model, "quantize_params")
    blocks = list(model.decoder.blocks)
    if encoder:
        blocks += list(model.encoder.blocks)
    for block in blocks:
        for m in _dense_modules(block):
            if m.w is not None:
                m.set_quantized(*quantize_weight(m.w, axis=-2))
    if embedding and model.decoder.tok_emb is not None:
        emb_q, emb_scale = quantize_weight(model.decoder.tok_emb, axis=-1)
        model.decoder.set_quantized_embedding(emb_q, emb_scale)
    return model


def fuse_decoder_qkv(model):
    """Concatenate each decoder block's self-attention q/k/v projections
    into one ``qkv`` dense ([d, 3d]), in place: one product instead of
    three on the decode path. Works on float or int8 weights (column-wise
    concat of w/w_q, scale, and bias with zeros for the bias-free k). A
    tensor-parallel shard is refused: under tp q/k/v stay apart, as the JAX
    engine keeps them."""
    from ..models.whisper import Dense

    _refuse_shard(model, "fuse_decoder_qkv")
    for block in model.decoder.blocks:
        attn = block.attn
        if attn.qkv is not None:  # already fused
            continue
        q, k, v = attn.q, attn.k, attn.v
        kb = k.b if k.b is not None else torch.zeros_like(q.b)
        b = torch.cat([q.b, kb, v.b], dim=-1)
        if q.w_q is not None:
            attn.qkv = Dense(
                w_q=torch.cat([q.w_q, k.w_q, v.w_q], dim=-1),
                scale=torch.cat([q.scale, k.scale, v.scale], dim=-1),
                b=b,
            )
        else:
            attn.qkv = Dense(w=torch.cat([q.w, k.w, v.w], dim=-1), b=b)
        attn.q = attn.k = attn.v = None
    return model


def is_quantized(model) -> bool:
    dec = model.decoder
    return dec.tok_emb_q is not None or any(
        m.w_q is not None for m in _dense_modules(dec.blocks)
    )
