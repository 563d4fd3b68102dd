"""Attention of the beam-search decode step (K5, K6): the wrappers of
``csrc/beam_attention.cu`` (K5) and ``csrc/beam_cross_attention.cu`` (K6)
and their plain versions.

K5, ``beam_attention`` (the TPU kernel it replaces: the JAX package's
``ops/beam_attention.py:214``, ``beam_attention``). Ancestry-masked beam
self-attention: every destination beam kd of an item attends over all K
source-slot caches of that item, ``anc[b, kd, ks, c]`` saying whether beam kd
reads position c from slot ks, with one fp32 softmax over (ks, c) jointly.
Slot caches are ``[B*K, H, C, hd]``, position-major, slot s of item b at row
b*K + s; bf16, or int8 with per-row scales ``[B*K, H, C]`` (``k_scale``
multiplies the scores, ``v_scale`` the softmax weights). ``c_valid`` bounds
the positions read, exact while the mask is zero beyond it.

K6, ``beam_cross_attention`` and ``beam_cross_attention_i4`` (the TPU kernel
it replaces: ``ops/beam_attention.py:333``, ``beam_cross_attention``). The K
beam queries of an item, ``[B, H, K, hd]``, against the item's shared,
untiled KF cross slab ``[B, H, hd, F]``: bf16, int8 with per-position scales
``[B, H, F]``, or the packed int4 carrier ``[B, H, hd, F/2]`` with the same
scales (byte j holds positions j and j + F/2, ``ops/quant._pack_nibbles``),
read as it is. Its numerics are those of the JAX package's
``models/whisper._attend_xa``, the function that package's beam step calls.

A CPU tensor takes the plain version (after unpacking, for int4). On CUDA the
kernels take bf16 queries, hd = 64 and at most ``MAX_BEAMS`` = 32 beams, and
return bf16. A cluster serves at most 8 query beams: above 8 the beams of an
item split into groups of ``beam_groups`` in the same launch, each group's
cluster reading all K slots (K5) or the whole slab (K6) for its own beams,
which is exact, since no beam's output reads another beam's query.
Both run a cluster of four blocks per (item, head), and both copy 16-byte
pieces of their K and V into shared memory, so those must start on 16-byte
boundaries. K5's blocks split the live (position, slot) rows below
``c_valid``: each stages the item's ancestry, numbers the live rows and takes
a quarter of them, holding up to 256 at a time with K fp32 scores each, and
forms both products on the tensor cores; the four blocks' softmax partials
merge over distributed shared memory. K6's blocks split d: each holds a
quarter of the slab's d rows and the K x F fp32 scores (one bulk copy per
quarter). The JAX package's head-paired slot cache is a TPU lane
workaround and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .quant import unpack_nibbles_i8

HEAD_DIM = 64
MAX_BEAMS = 32  # slots an item may have: K5's slot masks are 32 bits
GROUP_BEAMS = 8  # query beams a cluster takes: a warp each in K5, an unrolled row each in K6
NEG = -1e30  # the JAX package's mask value
_MAX_SMEM_BYTES = 200 * 1024  # csrc/slab_attention.cuh MAX_DYNAMIC_SMEM
_CLUSTER = 4  # blocks per (item, head): K5 a quarter of the live rows each, K6 a d quarter each
_K5_CHUNK = 256  # csrc/beam_attention.cu CHUNK_MAX: rows a K5 block stages at once


def read_len(C: int, c_valid: int) -> int:
    """Positions a ``c_valid`` bound leaves of a C-long cache (0: all)."""
    return c_valid if 0 < c_valid < C else C


def beam_groups(K: int) -> int:
    """Query beams a K6 cluster takes: K split into ceil(K / 8) groups of
    equal size but for the last (csrc/beam_cross_attention.cu ``launch``)."""
    groups = -(-K // GROUP_BEAMS)
    return -(-K // groups)


def _beam_smem_bytes(KG: int, K: int, C: int, cv: int, itemsize: int) -> int:
    """Dynamic shared memory of one K5 block serving KG of K query beams
    (csrc/beam_attention.cu ``layout``): the group's rows of the ancestry, a
    row number and a 32-bit slot mask per position, the block's list of live
    rows (at most a quarter of K x cv, rounded up), one chunk's K rows (in
    tiles of 8) and V rows, KG scores a row, KG weights a row as bf16 high
    and low parts (rows padded to 16), and (int8) two scales a row."""
    rows = -(-K * cv // _CLUSTER)
    chunk = min(_K5_CHUNK, rows)
    align16 = lambda x: -(-x // 16) * 16  # noqa: E731
    at = align16(align16(align16(KG * K * C + 32) + 8 * cv) + 4 * rows)
    at += -(-chunk // 8) * 8 * HEAD_DIM * itemsize  # K rows, whole tiles of 8
    at = align16(at + chunk * (HEAD_DIM * itemsize + 4 * KG))  # V rows, scores
    at += 2 * KG * -(-chunk // 16) * 16 * 2  # weights: bf16 high and low parts
    return at + (8 * chunk if itemsize == 1 else 0)


def beam_attention_groups(K: int, C: int, cv: int, itemsize: int) -> tuple[int, int]:
    """(query beams a K5 cluster takes, its block's shared memory): the
    fewest groups, at least ceil(K / 8), whose blocks fit
    (csrc/beam_attention.cu ``group_size``)."""
    groups = -(-K // GROUP_BEAMS)
    while True:
        kg = -(-K // groups)
        smem = _beam_smem_bytes(kg, K, C, cv, itemsize)
        if kg == 1 or smem <= _MAX_SMEM_BYTES:
            return kg, smem
        groups += 1


def beam_attention_reference(q, k, v, anc, beam_size: int, scale: float = 1.0,
                             c_valid: int = 0, k_scale=None, v_scale=None):
    """Plain version of K5, fp32 throughout: the JAX package's
    ``beam_attention_reference`` (unpaired layout), with optional per-row
    int8 scales. q [B*K, H, hd]; k, v [B*K, H, C, hd]; anc [B, K, K, C] bool.
    Returns [B*K, H, hd] in q's dtype."""
    BK, H, C, hd = k.shape
    K = beam_size
    B = BK // K
    cv = read_len(C, c_valid)

    def slots(x):  # [B*K, H, C, ..] → [B, K, H, cv, ..] fp32
        return x[:, :, :cv].float().reshape(B, K, H, cv, *x.shape[3:])

    qs = (q.float() * scale).reshape(B, K, H, hd)
    scores = torch.einsum("bkhd,bshcd->bhksc", qs, slots(k))  # [B, H, Kd, Ks, cv]
    if k_scale is not None:
        scores = scores * slots(k_scale).permute(0, 2, 1, 3)[:, :, None]
    scores = scores.masked_fill(~anc[:, None, :, :, :cv], NEG)
    w = torch.softmax(scores.reshape(B, H, K, K * cv), dim=-1).reshape(B, H, K, K, cv)
    if v_scale is not None:
        w = w * slots(v_scale).permute(0, 2, 1, 3)[:, :, None]
    out = torch.einsum("bhksc,bshcd->bkhd", w, slots(v))
    return out.reshape(BK, H, hd).to(q.dtype)


def beam_attention(
    q: torch.Tensor,  # [B*K, H, hd]
    k: torch.Tensor,  # [B*K, H, C, hd] bf16 or int8
    v: torch.Tensor,
    anc: torch.Tensor,  # [B, K, K, C] bool
    beam_size: int,
    scale: float = 1.0,  # score scale (hd**-0.5)
    c_valid: int = 0,  # read positions [0, c_valid) only; 0 = all
    k_scale: Optional[torch.Tensor] = None,  # [B*K, H, C] f32 (int8 slabs)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ancestry-masked beam self-attention → [B*K, H, hd]. CUDA: K5 (bf16
    slab, or int8 slab with scales), one launch; CPU: the plain version."""
    if q.device.type == "cpu":
        return beam_attention_reference(q, k, v, anc, beam_size, scale, c_valid, k_scale, v_scale)
    name = "beam_attention"
    quantized = k_scale is not None
    if quantized:
        kernels.check_cuda(name, q, k, v, k_scale, v_scale, anc,
                           dtypes=(torch.bfloat16, torch.int8, torch.int8,
                                   torch.float32, torch.float32, torch.bool))
    else:
        kernels.check_cuda(name, q, k, v, anc, dtypes=(torch.bfloat16,) * 3 + (torch.bool,))
    BK, H, C, hd = k.shape
    K = beam_size
    if (hd != HEAD_DIM or tuple(q.shape) != (BK, H, hd) or v.shape != k.shape
            or not 1 <= K <= MAX_BEAMS or BK % K):
        raise ValueError(f"{name}: need q [B*K, H, 64], k, v [B*K, H, C, 64], 1 <= K <= "
                         f"{MAX_BEAMS}; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, K = {K}")
    B = BK // K
    if tuple(anc.shape) != (B, K, K, C):
        raise ValueError(f"{name}: anc shape {tuple(anc.shape)} != {(B, K, K, C)}")
    if quantized and not tuple(k_scale.shape) == tuple(v_scale.shape) == (BK, H, C):
        raise ValueError(f"{name}: scale shapes {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)} != {(BK, H, C)}")
    cv = read_len(C, c_valid)
    _, smem = beam_attention_groups(K, C, cv, k.element_size())
    if smem > _MAX_SMEM_BYTES or C > 0xFFFF:
        raise ValueError(f"{name}: K = {K} beams over a {C}-row cache need {smem} > "
                         f"{_MAX_SMEM_BYTES} bytes of shared memory")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must start on 16-byte boundaries")
    out = torch.empty_like(q)
    stream = kernels.stream_handle(q.device)
    if quantized:
        kernels.call("sstw_beam_attention_i8", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     k_scale.data_ptr(), v_scale.data_ptr(), anc.data_ptr(), out.data_ptr(),
                     B, H, C, K, cv, scale, stream)
    else:
        kernels.call("sstw_beam_attention_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     anc.data_ptr(), out.data_ptr(), B, H, C, K, cv, scale, stream)
    kernels.LAUNCHES["beam_attention"] += 1
    return out


def beam_cross_attention_reference(q, k, v, k_scale=None, v_scale=None, scale: float = 1.0,
                                   return_weights: bool = False):
    """Plain version of K6: the JAX package's ``models/whisper._attend_xa``
    on one layer's slab. q [B, H, T, hd]; k, v [B, H, hd, F] (bf16/fp32, or
    int8 with ``k_scale``/``v_scale`` [B, H, F]); ``scale`` is the whole score
    scale. Unquantized, q is scaled in its own dtype and the weights are
    rounded to the slab's dtype; quantized, ``k_scale * scale`` multiplies
    the scores after q·k and ``v_scale`` the fp32 weights, rounded to q's
    dtype. Returns [B, H, T, hd], and with ``return_weights`` also the fp32
    softmax weights [B, H, T, F] (the JAX package's ``_attend_xa`` returns
    both)."""
    if k_scale is None:
        w = torch.softmax(torch.matmul((q * scale).float(), k.float()), dim=-1)
        out = torch.matmul(w.to(v.dtype).float(), v.float().transpose(-1, -2)).to(v.dtype)
    else:
        scores = torch.matmul(q.float(), k.float()) * (k_scale * scale)[:, :, None, :]
        w = torch.softmax(scores, dim=-1)
        wv = (w * v_scale[:, :, None, :]).to(q.dtype)
        out = torch.matmul(wv.float(), v.float().transpose(-1, -2)).to(q.dtype)
    return (out, w) if return_weights else out


def _check_cross(name, q, k, v, F, scales=()):
    B, H, K, hd = q.shape
    if hd != HEAD_DIM or tuple(k.shape[:3]) != (B, H, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: need q [B, H, K, 64] and k, v [B, H, 64, *], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    # per block: the K and V quarters of the slab, a fp32 score row padded to
    # a multiple of 4 for each beam of its group, and the two scale rows
    smem = 2 * (HEAD_DIM // _CLUSTER) * k.shape[-1] * k.element_size() + 4 * (
        beam_groups(max(K, 1)) * -(-F // 4) * 4 + len(scales) * F)
    if not 1 <= K <= MAX_BEAMS or smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{name}: K = {K} beams over F = {F} positions: need 1 <= K <= "
                         f"{MAX_BEAMS} and {smem} <= {_MAX_SMEM_BYTES} bytes of shared memory")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must start on 16-byte boundaries")
    for s in scales:
        if tuple(s.shape) != (B, H, F):
            raise ValueError(f"{name}: scale shape {tuple(s.shape)} != {(B, H, F)}")


def beam_cross_attention(
    q: torch.Tensor,  # [B, H, K, hd]
    k: torch.Tensor,  # [B, H, hd, F] bf16 or int8 (KF layout)
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # [B, H, F] f32 (int8 slabs)
    v_scale: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """K beam queries per (item, head) against the shared KF slab →
    [B, H, K, hd]. CUDA: K6 (bf16 slab, or int8 slab with scales); CPU: the
    plain version."""
    if q.device.type == "cpu":
        return beam_cross_attention_reference(q, k, v, k_scale, v_scale, scale)
    name = "beam_cross_attention"
    F = k.shape[-1]
    quantized = k_scale is not None
    if quantized:
        kernels.check_cuda(name, q, k, v, k_scale, v_scale,
                           dtypes=(torch.bfloat16, torch.int8, torch.int8,
                                   torch.float32, torch.float32))
        _check_cross(name, q, k, v, F, (k_scale, v_scale))
    else:
        kernels.check_cuda(name, q, k, v, dtypes=(torch.bfloat16,) * 3)
        _check_cross(name, q, k, v, F)
    B, H, K, _ = q.shape
    out = torch.empty_like(q)
    stream = kernels.stream_handle(q.device)
    if quantized:
        kernels.call("sstw_beam_cross_attention_i8", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), B, H, F, K, scale,
                     stream)
    else:
        kernels.call("sstw_beam_cross_attention_bf16", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), B, H, F, K, scale, stream)
    kernels.LAUNCHES["beam_cross_attention"] += 1
    return out


def beam_cross_attention_i4(
    q: torch.Tensor,  # [B, H, K, hd]
    k_p: torch.Tensor,  # [B, H, hd, F/2] int8: packed int4 carrier
    v_p: torch.Tensor,
    k_scale: torch.Tensor,  # [B, H, F] f32
    v_scale: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
    """As ``beam_cross_attention`` over a packed int4 slab. CUDA: K6,
    unpacking nibbles in registers; CPU: the plain version on the unpacked
    slab."""
    if q.device.type == "cpu":
        return beam_cross_attention_reference(
            q, unpack_nibbles_i8(k_p), unpack_nibbles_i8(v_p), k_scale, v_scale, scale)
    name = "beam_cross_attention"
    kernels.check_cuda(name, q, k_p, v_p, k_scale, v_scale,
                       dtypes=(torch.bfloat16, torch.int8, torch.int8,
                               torch.float32, torch.float32))
    F = 2 * k_p.shape[-1]
    _check_cross(name, q, k_p, v_p, F, (k_scale, v_scale))
    B, H, K, _ = q.shape
    out = torch.empty_like(q)
    kernels.call("sstw_beam_cross_attention_i4", q.data_ptr(), k_p.data_ptr(), v_p.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), B, H, F, K, scale,
                 kernels.stream_handle(q.device))
    kernels.LAUNCHES["beam_cross_attention"] += 1
    return out
