"""Approximate int8 encoder attention in the style of SageAttention (P1): the
wrapper of ``csrc/flash_q8.cu`` and its plain version.

The function of the JAX package's TPU probe ``tools/bench_flash_int8.py``
(``flash_q8``, kernel body ``_quant_kernel``), per (batch, head), with L the
real length and every product in the kernel's own body:

  * q per row: ``qmax = max(max|q_row|, 1e-6)``, ``q8 = round(q * (127 / qmax))``;
  * k per head, over all of K: ``kmax = max(max|k|, 1e-6)``,
    ``k8 = round(k * (127 / kmax))``;
  * ``scores = (q8 · k8ᵀ in int32) * (qmax * (kmax / 127²))``;
    ``e = exp(scores - rowmax)``, ``s = Σ e`` in fp32 over the unquantized e;
  * ``qk8``: ``o = bf16(e) · v`` in fp32, then ``o / s`` in bf16;
  * ``full8``: v per head and channel over L: ``vmax = max(max|v_col|, 1e-6)``,
    ``v8 = round(v * (127 / vmax))``; ``p8 = round(e * 127)``;
    ``o = (p8 · v8 in int32) * (vmax / 127²)``, then ``o / s`` in bf16.

``round`` is round-half-to-even and every division a true IEEE division, so
the kernel's int8 codes equal the plain version's bit for bit.
Interface: head-major [B, H, L, 64] bf16, q and k each pre-scaled by d^-0.25
by the caller, as ``ops/flash_attention``. A CPU tensor takes
``flash_q8_plain``; a CUDA tensor the kernel; anything else raises.
"""

from __future__ import annotations

import torch

from .. import kernels

HEAD_DIM = 64  # the kernel's d
MODES = ("qk8", "full8")
KEY_TILE = 64  # the kernel's key tile: k8 and v8 are padded to a multiple of it
_Q127 = 127.0 * 127.0
P8_FLIPS = 4  # p8 codes per row that full8_tolerance allows to be off by one
# The key at each position of a v8 tile: in each group of 16, position 4t + b
# holds key 8 (b // 2) + 2t + b % 2, the order in which the kernel's PV
# product takes p8 from the score fragments (``csrc/flash_q8.cu:v8_slot``).
V8_ORDER = tuple((i & 48) + 8 * ((i & 3) >> 1) + 2 * ((i >> 2) & 3) + (i & 1)
                 for i in range(KEY_TILE))
# The kernel's C entry: which of its two kernels a call launches.
PREPASS, ATTENTION = 1, 2


def _absmax(x: torch.Tensor, dims) -> torch.Tensor:
    return x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-6)


def _codes(x: torch.Tensor, xmax: torch.Tensor) -> torch.Tensor:
    # A true division 127 / xmax (``127.0 / t`` would take t's reciprocal
    # times 127, another rounding), then the product, rounded half to even.
    return torch.round(x * torch.div(torch.full_like(xmax, 127.0), xmax)).to(torch.int8)


def _weights(qb: torch.Tensor, kb: torch.Tensor):
    """One batch item's (e, s, q8, k8) from fp32 q and k [H, L, d]: the
    unquantized softmax terms e [H, L, L] and their row sums s [H, L, 1]. The
    product runs in float64, which holds the int32 sums exactly (int8
    products over 1500 keys exceed 2^24, so fp32 would not)."""
    qmax = _absmax(qb, -1)  # [H, L, 1]
    kmax = _absmax(kb, (-2, -1))  # [H, 1, 1]
    q8, k8 = _codes(qb, qmax), _codes(kb, kmax)
    s32 = torch.matmul(q8.double(), k8.double().transpose(-1, -2)).float()
    scores = s32 * (qmax * (kmax / _Q127))
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return e, e.sum(-1, keepdim=True), q8, k8


def full8_tolerance(q, k, v, want: torch.Tensor, flips: int = P8_FLIPS) -> torch.Tensor:
    """A bound per element [B, H, L, d] on |kernel - plain| for full8, from
    the arithmetic. The int32 product is exact in both, so the fp32 values
    before the bf16 rounding differ only through s (fp32 sums in another
    order, relative error far below a bf16 step) and through p8 codes that
    an exp a few ulp off flips: two bf16 steps at the element itself, plus
    ``flips`` codes per row off by one, each moving the channel's sum by
    |v8| <= 127 and so the output by max|v_col| / 127 over the row's s.
    The kernel's exp is __expf's arithmetic, documented within 2 +
    floor(1.173 |x|) ulp: at most 8 ulp where a code can be 1 or more
    (e * 127 >= 0.5, so x >= -5.54); the plain version's exp is within 2.
    So e * 127 moves by at most 10 * 127 * 2^-23 * e < 1.6e-4 e, and a code
    flips only where e * 127 lies that near a half: about 3e-4 s flips in
    a row of sum s <= L, under 0.5 even for 1500 equal keys and under 0.1
    for the probe's rows (s in the tens to hundreds)."""
    s = torch.stack([_weights(qb, kb)[1] for qb, kb in zip(q.float(), k.float())])
    vmax = v.float().abs().amax(-2, keepdim=True)  # [B, H, 1, d]
    return 2**-6 * want.float().abs() + flips * vmax / (127.0 * s)


def flash_q8_plain(q, k, v, mode: str = "qk8", return_codes: bool = False):
    """Plain PyTorch version, one batch item at a time, in the kernel's
    operation order. Both products run in float64 (see ``_weights``); TF32
    plays no part. ``return_codes`` also returns the int8 codes
    {"q8", "k8"[, "v8"]}, each [B, H, L, d]."""
    if mode not in MODES:
        raise ValueError(f"flash_q8: mode {mode!r} is not one of {MODES}")
    outs, codes = [], {"q8": [], "k8": [], "v8": []}
    for qb, kb, vb in zip(q.float(), k.float(), v.float()):  # [H, L, d] each
        e, s, q8, k8 = _weights(qb, kb)
        if mode == "qk8":
            o = torch.matmul(e.to(v.dtype).double(), vb.double()).float()
        else:
            vmax = _absmax(vb, -2)  # [H, 1, d]
            v8 = _codes(vb, vmax)
            p8 = torch.round(e * 127.0)
            o = torch.matmul(p8.double(), v8.double()).float() * (vmax / _Q127)
            codes["v8"].append(v8)
        outs.append((o / s).to(v.dtype))
        codes["q8"].append(q8)
        codes["k8"].append(k8)
    out = torch.stack(outs)
    if not return_codes:
        return out
    return out, {name: torch.stack(c) for name, c in codes.items() if c}


def tile_v8(v8: torch.Tensor) -> torch.Tensor:
    """v8 codes [bh, L, d] as the kernel's pre-pass writes them: tiles of 64
    keys [bh, lp / 64, d, 64] (channel-major), keys in ``V8_ORDER`` within
    each tile, zeros past L."""
    bh, L, d = v8.shape
    lp = -(-L // KEY_TILE) * KEY_TILE
    padded = torch.zeros((bh, lp, d), dtype=v8.dtype, device=v8.device)
    padded[:, :L] = v8
    tiles = padded.view(bh, lp // KEY_TILE, KEY_TILE, d).transpose(2, 3)
    return tiles[..., list(V8_ORDER)].contiguous()


def untile_v8(tiles: torch.Tensor, L: int) -> torch.Tensor:
    """The inverse of :func:`tile_v8`: [bh, lp / 64, d, 64] tiles back to
    codes [bh, L, d]."""
    bh, n, d, _ = tiles.shape
    keys = torch.empty_like(tiles)
    keys[..., list(V8_ORDER)] = tiles
    return keys.transpose(2, 3).reshape(bh, n * KEY_TILE, d)[:, :L]


def flash_q8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str = "qk8",
             return_codes: bool = False):
    """Approximate attention, head-major [B, H, L, 64] bf16. CUDA: P1's
    kernels (a quantizing pre-pass per (batch, head), then the attention);
    CPU: ``flash_q8_plain``. ``return_codes`` also returns the kernel's int8
    codes {"q8", "k8"[, "v8"]}, each [B, H, L, d]."""
    if mode not in MODES:
        raise ValueError(f"flash_q8: mode {mode!r} is not one of {MODES}")
    if q.device.type == "cpu":
        return flash_q8_plain(q, k, v, mode, return_codes)
    kernels.check_cuda("flash_q8", q, k, v, dtypes=(torch.bfloat16,) * 3)
    B, H, L, d = q.shape
    if d != HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_q8: need q, k, v of one shape [B, H, L, 64], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_q8: q, k and v must start on 16-byte boundaries")
    full8 = mode == "full8"
    out, scratch = torch.empty_like(q), prepass_buffers(B * H, L, full8, q.device)
    q8 = torch.empty_like(q, dtype=torch.int8) if return_codes else None
    launch(q, k, v, out, scratch, q8, full8, PREPASS | ATTENTION)
    kernels.LAUNCHES["flash_q8"] += 1
    if not return_codes:
        return out
    k8, _, v8t, _ = scratch
    codes = {"q8": q8, "k8": k8[:, :L].reshape(B, H, L, d)}
    if full8:
        codes["v8"] = untile_v8(v8t.view(B * H, -1, d, KEY_TILE), L).reshape(B, H, L, d)
    return out, codes


def prepass_buffers(bh: int, L: int, full8: bool, device) -> tuple:
    """The pre-pass's outputs, read by the attention kernel: k8 [bh, lp, 64],
    kmax [bh] and, for full8, the v8 tiles [bh, lp * 64] (see
    :func:`tile_v8`) and vmax [bh, 64] (empty for qk8)."""
    lp = -(-L // KEY_TILE) * KEY_TILE
    return (torch.empty((bh, lp, HEAD_DIM), dtype=torch.int8, device=device),
            torch.empty((bh,), dtype=torch.float32, device=device),
            torch.empty((bh, lp * HEAD_DIM) if full8 else (0,), dtype=torch.int8, device=device),
            torch.empty((bh, HEAD_DIM) if full8 else (0,), dtype=torch.float32, device=device))


def launch(q, k, v, out, scratch, q8, full8: bool, parts: int) -> None:
    """One call of the C entry: the pre-pass (``PREPASS``), the attention
    (``ATTENTION``) or both, on checked tensors. ``flash_q8`` is the
    caller; a timing harness may launch one kernel alone."""
    B, H, L, _ = q.shape
    k8, kmax, v8t, vmax = scratch
    kernels.call(
        "sstw_flash_q8", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        k8.data_ptr(), kmax.data_ptr(), v8t.data_ptr(), vmax.data_ptr(),
        q8.data_ptr() if q8 is not None else None, B * H, L, int(full8), parts,
        kernels.stream_handle(q.device),
    )
