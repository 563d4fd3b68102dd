"""Single-token attention for the autoregressive decoder (K3, K4): the
wrappers of ``csrc/decode_attention.cu`` and their plain version.

Layout: K/V are stored "KF", ``[S, H, hd, F]`` with the position axis minor,
the layout of the JAX package's ``ops/decode_attention.py`` and of the cross
slab that ``models/whisper.precompute_xa_kv`` builds. Slab forms:

  * bf16 slab, with an optional causal bound ``pos[s]`` (K3, plain form);
  * int8 slab with per-position ``k_scale``/``v_scale`` (K3, int8 form):
    ``k_scale`` multiplies the scores, ``v_scale`` the softmax weights;
  * packed int4 carrier ``[S, H, hd, F/2]`` with the same scales (K4): byte
    j holds position j in its low nibble and position j + F/2 in its high
    nibble (``ops/quant._pack_nibbles``).

A CPU tensor takes ``decode_attention_reference`` (after unpacking, for
int4). On CUDA the kernels take bf16 queries, hd = 64, and return bf16. Both
are a cluster of eight blocks per (item, head), each holding 1/8 of the
positions of all 64 K and V rows, whose softmax partials merge over
distributed shared memory: K3 (``csrc/decode_attention.cu``) over bf16 or
int8 rows, copying only the positions a causal ``pos[s]`` leaves (all of
them, weighed evenly as the plain version's mask does, where pos[s] < 0), K4 (``csrc/decode_attention_i4.cu``) over the carrier's columns.
Both take any slab alignment, K3 any F up to ``MAX_F`` and K4 any even F up
to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .quant import unpack_nibbles_i8

HEAD_DIM = 64
# The largest F whose blocks fit the kernels' 200 KB of dynamic shared
# memory: a K3 bf16 block holds 64 rows of about F/4 + 19 bytes (rounded to
# 16) and F/8 fp32, 200 KB at this F (csrc/decode_attention.cu smem_bytes);
# K3's int8 block and a K4 block hold less.
MAX_F = 12_288


def decode_attention_reference(q, k, v, k_scale=None, v_scale=None, pos=None,
                               scale=1.0, out_dtype=None):
    """Plain version (KF layout, fp32 throughout) — the function the JAX
    production path calls for the decode step's cross read."""
    out_dtype = out_dtype or q.dtype
    qf = q.float() * scale  # [S,H,hd]
    scores = torch.einsum("shd,shdf->shf", qf, k.float())
    if k_scale is not None:
        scores = scores * k_scale
    if pos is not None:
        col = torch.arange(scores.shape[-1], device=scores.device)[None, None, :]
        scores = scores.masked_fill(col > pos[:, None, None], -1e30)
    w = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        w = w * v_scale
    out = torch.einsum("shf,shdf->shd", w, v.float())
    return out.to(out_dtype)


def _check_shapes(name, q, k, v, F, scales=()):
    S, H, hd = q.shape
    if hd != HEAD_DIM or k.shape[:3] != (S, H, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: need q [S, H, 64] and k, v [S, H, 64, *], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not 0 < F <= MAX_F:
        raise ValueError(f"{name}: F = {F} outside (0, {MAX_F}]")
    for s in scales:
        if s.shape != (S, H, F):
            raise ValueError(f"{name}: scale shape {tuple(s.shape)} != {(S, H, F)}")


def decode_attention(
    q: torch.Tensor,  # [S, H, hd]
    k: torch.Tensor,  # [S, H, hd, F] bf16 or int8 (KF layout)
    v: torch.Tensor,  # [S, H, hd, F]
    k_scale: Optional[torch.Tensor] = None,  # [S, H, F] f32 (int8 slabs)
    v_scale: Optional[torch.Tensor] = None,
    pos: Optional[torch.Tensor] = None,  # [S] int32: attend cols ≤ pos[s]
    scale: float = 1.0,  # score scale (hd**-0.5)
) -> torch.Tensor:
    """q_len = 1 attention over per-head KF slabs → [S, H, hd]. CUDA: K3
    (bf16 slab, or int8 slab with scales); CPU: the plain version."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, k_scale, v_scale, pos, scale)
    F = k.shape[-1]
    quantized = k_scale is not None
    name = "decode_attention"
    if quantized:
        kernels.check_cuda(name, q, k, v, k_scale, v_scale,
                           dtypes=(torch.bfloat16, torch.int8, torch.int8,
                                   torch.float32, torch.float32))
        _check_shapes(name, q, k, v, F, (k_scale, v_scale))
    else:
        kernels.check_cuda(name, q, k, v, dtypes=(torch.bfloat16,) * 3)
        _check_shapes(name, q, k, v, F)
    if pos is not None:
        kernels.check_cuda(name, q, pos, dtypes=(torch.bfloat16, torch.int32))
        if pos.shape != (q.shape[0],):
            raise ValueError(f"{name}: pos shape {tuple(pos.shape)} != {(q.shape[0],)}")
    S, H, _ = q.shape
    out = torch.empty_like(q)
    pos_ptr = pos.data_ptr() if pos is not None else None
    stream = kernels.stream_handle(q.device)
    if quantized:
        kernels.call("sstw_decode_attention_i8", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     k_scale.data_ptr(), v_scale.data_ptr(), pos_ptr, out.data_ptr(),
                     S, H, F, scale, stream)
    else:
        kernels.call("sstw_decode_attention_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     pos_ptr, out.data_ptr(), S, H, F, scale, stream)
    kernels.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_i4(
    q: torch.Tensor,  # [S, H, hd]
    k_p: torch.Tensor,  # [S, H, hd, F/2] int8: packed int4 carrier
    v_p: torch.Tensor,
    k_scale: torch.Tensor,  # [S, H, F] f32
    v_scale: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
    """q_len = 1 attention over a packed int4 slab → [S, H, hd]. CUDA: K4,
    unpacking nibbles in registers; CPU: the plain version on the unpacked
    slab."""
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, unpack_nibbles_i8(k_p), unpack_nibbles_i8(v_p), k_scale, v_scale,
            scale=scale,
        )
    name = "decode_attention_i4"
    kernels.check_cuda(name, q, k_p, v_p, k_scale, v_scale,
                       dtypes=(torch.bfloat16, torch.int8, torch.int8,
                               torch.float32, torch.float32))
    F = 2 * k_p.shape[-1]
    _check_shapes(name, q, k_p, v_p, F, (k_scale, v_scale))
    S, H, _ = q.shape
    out = torch.empty_like(q)
    kernels.call("sstw_decode_attention_i4", q.data_ptr(), k_p.data_ptr(), v_p.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), S, H, F, scale,
                 kernels.stream_handle(q.device))
    kernels.LAUNCHES["decode_attention_i4"] += 1
    return out
