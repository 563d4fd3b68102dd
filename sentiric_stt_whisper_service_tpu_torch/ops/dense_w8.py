"""The weight-only int8 product at small M (W8): the wrappers of
``csrc/dense_w8.cu`` and their plain versions.

``y = x · W_q`` with the int8 weight read once and converted to bf16 in
registers, the per-output-channel fp32 scale applied to the fp32 sum and the
result rounded once: the arithmetic of the JAX package's ``dense`` and
``tied_logits`` (``models/whisper.py``), which leave the conversion to XLA's
operand fusion. Two forms, in the layouts the weights already have:

  * ``dense_w8``: ``w_q [K, N]`` (a ``Dense``'s int8 weight), bf16 out, the
    bf16 bias added after the rounding when one is given (a row-parallel
    shard adds its bias after the reduce instead);
  * ``logits_w8``: ``emb_q [N, K]`` (the int8 token embedding), fp32 out, no
    bias.

``models/whisper`` sends a product here when its rows (the product of x's
leading dimensions) are at most ``M_MAX`` and x is bf16 or on the CPU
(``serves``): the decode steps, the batcher's pool, the gang, the
speculative verify and draft steps, prefill and the align passes. Larger
products (the encoder and the cross K/V at 1500 rows a window) keep the cast
and ``torch.matmul``, bound by operations rather than bytes.

A CPU tensor takes the plain version. On CUDA the kernel takes bf16 x with
K a multiple of 16 (and N of 16 for ``dense_w8``) and 16-byte aligned
operands, and raises on anything else.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

# The most rows the kernel serves: above it cuBLAS over the cast weight is
# as fast at large-v3's K and N on the H100 (PERF.md, the W8 row).
M_MAX = 256


def rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def serves(x: torch.Tensor) -> bool:
    """Whether ``dense_w8`` / ``logits_w8`` take a product with input ``x``."""
    return rows(x) <= M_MAX and (x.device.type == "cpu" or x.dtype == torch.bfloat16)


def dense_w8_plain(x, w_q, scale, b=None):
    """Plain version of ``dense_w8``: fp32 sum, scale, one rounding to x's
    dtype, then the bias."""
    y = (torch.matmul(x.float(), w_q.float()) * scale).to(x.dtype)
    return y if b is None else y + b


def logits_w8_plain(x, emb_q, scale):
    """Plain version of ``logits_w8``: x [..., K] against emb_q [N, K], fp32."""
    return torch.matmul(x.float(), emb_q.float().T) * scale


def _launch(fn: str, x, w, scale, b, N: int, out_dtype) -> torch.Tensor:
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    operands = (x2, w, scale) + ((b,) if b is not None else ())
    kernels.check_cuda(fn, *operands,
                       dtypes=(torch.bfloat16, torch.int8, torch.float32, torch.bfloat16))
    if scale.shape != (N,) or (b is not None and b.shape != (N,)):
        raise ValueError(f"{fn}: scale / bias shapes {tuple(scale.shape)} / "
                         f"{None if b is None else tuple(b.shape)} != {(N,)}")
    if K % 16 or (fn == "sstw_dense_w8" and N % 16):
        raise ValueError(f"{fn}: K = {K} and N = {N} must be multiples of 16")
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError(f"{fn}: operands must start on 16-byte boundaries")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    args = (x2.data_ptr(), w.data_ptr(), scale.data_ptr())
    if fn == "sstw_dense_w8":
        args += (b.data_ptr() if b is not None else None,)
    kernels.call(fn, *args, out.data_ptr(), M, K, N, kernels.stream_handle(x.device))
    kernels.LAUNCHES["dense_w8"] += 1
    return out.reshape(*x.shape[:-1], N)


def dense_w8(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] · w_q [K, N] int8, times ``scale`` [N], rounded to x's
    dtype once, plus ``b`` [N]. CUDA: the kernel; CPU: the plain version."""
    if x.device.type == "cpu":
        return dense_w8_plain(x, w_q, scale, b)
    if w_q.shape[0] != x.shape[-1]:
        raise ValueError(f"dense_w8: w_q {tuple(w_q.shape)} against x {tuple(x.shape)}")
    return _launch("sstw_dense_w8", x, w_q, scale, b, w_q.shape[1], torch.bfloat16)


def logits_w8(x: torch.Tensor, emb_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] against the int8 embedding emb_q [N, K] with per-row
    ``scale`` [N] → fp32 [..., N]. CUDA: the kernel; CPU: the plain
    version."""
    if x.device.type == "cpu":
        return logits_w8_plain(x, emb_q, scale)
    if emb_q.shape[1] != x.shape[-1]:
        raise ValueError(f"logits_w8: emb_q {tuple(emb_q.shape)} against x {tuple(x.shape)}")
    return _launch("sstw_logits_w8", x, emb_q, scale, None, emb_q.shape[0], torch.float32)
