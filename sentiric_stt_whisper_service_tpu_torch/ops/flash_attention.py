"""Flash self-attention for the Whisper encoder (K2): the wrapper of
``csrc/flash_attention.cu`` and its plain version.

The kernel keeps each query tile's scores on chip: the [B, H, Lq, Lk] score
tensor never reaches device memory. Interface: head-major q [B, H, Lq, d]
and k, v [B, H, Lk, d], the layout of the JAX package's
``ops/flash_attention.py``, with q and k each pre-scaled by d^-0.25 by the
caller. Lq = Lk is the encoder on one device; a rank of an "sp" mesh holds
Lk / sp query rows against the Lk keys of every rank. A CPU tensor takes
``attention_reference``.

``FlashAttention`` is the wrapper under autograd, for training: its forward
is ``flash_attention`` and it saves q, k and v; its backward recomputes the
fp32 scores and softmax and takes the attention gradient in plain PyTorch
(``attention_backward``). The JAX package has no backward kernel either: its
gradient is XLA's autodiff of the plain path.
"""

from __future__ import annotations

import torch

from .. import kernels

HEAD_DIM = 64  # the kernel's d; every Whisper size has 64-wide heads


def _acc(t: torch.Tensor) -> torch.dtype:
    """The accumulation type: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_reference(q, k, v):
    """Plain version with the same numerics as the kernel's reference in the
    JAX package: fp32 scores and softmax, weights cast to v's dtype, fp32
    products."""
    acc = _acc(q)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(w.to(acc), v.to(acc)).to(v.dtype)


def attention_backward(q, k, v, grad_out):
    """The gradient of softmax(q kᵀ) v with respect to q, k and v, head-major
    q, grad_out [B, H, Lq, d] and k, v [B, H, Lk, d]: the scores and softmax p recomputed in fp32,
    then dv = pᵀ dO, dp = dO vᵀ, ds = p ∘ (dp - rowsum(p ∘ dp)), dq = ds k,
    dk = dsᵀ q, each cast to its input's dtype."""
    acc = _acc(q)
    q32, k32, v32, g32 = q.to(acc), k.to(acc), v.to(acc), grad_out.to(acc)
    p = torch.softmax(torch.matmul(q32, k32.transpose(-1, -2)), dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v32.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: K2 forward on a CUDA tensor (its
    plain version on a CPU tensor), ``attention_backward`` backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        return attention_backward(*ctx.saved_tensors, grad_out)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, head-major q [B, H, Lq, d] against k, v
    [B, H, Lk, d]. CUDA: K2 (bf16, d = 64); CPU: ``attention_reference``."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    kernels.check_cuda("flash_attention", q, k, v, dtypes=(torch.bfloat16,) * 3)
    B, H, Lq, d = q.shape
    Lk = k.shape[2]
    if d != HEAD_DIM or k.shape != (B, H, Lk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q [B, H, Lq, 64] and k, v of one shape "
                         f"[B, H, Lk, 64], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    out = torch.empty_like(q)
    kernels.call(
        "sstw_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B * H, Lq, Lk, kernels.stream_handle(q.device),
    )
    kernels.LAUNCHES["flash_attention"] += 1
    return out
