"""The yardstick of the kernels and of the whole step: the card's peaks, the
least time a call could take, and the work of each kernel from the shapes
its wrapper is given. A model's FLOPs are its family's (``families/``).

The peaks and ``bound`` are a frozen copy of phase 3 of ``chip_smoke.py``
(``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S``, ``EXP_PER_S`` and ``bound`` at the
commit that added this benchmark): NVIDIA's H100 SXM data sheet, dense
rates at 700 W. Each input byte is read once and each output byte written
once; operations count a multiply and an add as two.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
# Exponentials a second on the special-function units: 16 a clock on each
# of the 132 SMs (FlashAttention-3, Shah et al. 2024, section 3).
EXP_PER_S = 3.9e12
HEAD_DIM = 64


def bound(n_bytes: float, ops: dict, exps: float = 0) -> tuple:
    """(least seconds the card could take, what bounds it): the largest of
    the bytes over the memory rate ("bytes"), the operations {type: count}
    over each type's peak, the types' times added ("operations"), and the
    exponentials over the special-function units' rate ("exp")."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "operations": sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()),
             "exp": exps / EXP_PER_S}
    by = max(terms, key=terms.get)
    return terms[by], by


# --- the kernels' work from the shapes their wrappers in ops/ read ---------


def k2_work(bh: int, lq: int, lk: int, d: int = HEAD_DIM) -> tuple:
    """K2 ``flash_attention``: q and out [B*H, Lq, d], k and v [B*H, Lk, d],
    bf16; QKᵀ and PV; one exponential a score."""
    return (2 * bh * d * (2 * lq + 2 * lk), {"bf16": 4 * bh * lq * lk * d}, bh * lq * lk)


def k3_work(s: int, h: int, f: int, slab_bytes: int, scaled: bool, causal: bool,
            d: int = HEAD_DIM) -> tuple:
    """K3 ``decode_attention``: q and out [S, H, d] bf16, the k and v slabs
    [S, H, d, F] of ``slab_bytes`` an element (int8 with fp32 scales
    [S, H, F] each, or bf16), an int32 position a row when causal."""
    n = 2 * (2 * s * h * d) + 2 * s * h * d * f * slab_bytes
    n += 2 * 4 * s * h * f if scaled else 0
    n += 4 * s if causal else 0
    kind = "int8" if slab_bytes == 1 else "bf16"
    return (n, {kind: 4 * s * h * d * f})


def k4_work(s: int, h: int, f: int, d: int = HEAD_DIM) -> tuple:
    """K4 ``decode_attention_i4``: q and out [S, H, d] bf16, the packed int4
    carriers [S, H, d, F/2] and their fp32 scales [S, H, F]."""
    n = 2 * (2 * s * h * d) + 2 * (s * h * d * f // 2) + 2 * 4 * s * h * f
    return (n, {"int8": 4 * s * h * d * f})


def k6_work(b: int, h: int, f: int, k: int, slab_bytes: float, scaled: bool,
            d: int = HEAD_DIM) -> tuple:
    """K6 ``beam_cross_attention``: q and out [B, H, K, d] bf16 against one
    slab [B, H, d, F] an item of ``slab_bytes`` an element (0.5: the packed
    int4 carrier), with fp32 scales [B, H, F] when quantized."""
    n = 2 * (2 * b * h * k * d) + 2 * int(b * h * d * f * slab_bytes)
    n += 2 * 4 * b * h * f if scaled else 0
    kind = "bf16" if slab_bytes == 2 else "int8"
    return (n, {kind: 4 * b * h * k * d * f})


# The kernel library's functions → (kernel, work of their integer
# arguments, in the order the wrapper passes them).
KERNELS = {
    "sstw_flash_attention": ("K2", lambda bh, lq, lk: k2_work(bh, lq, lk)),
    "sstw_decode_attention_bf16": ("K3", lambda s, h, f, causal: k3_work(s, h, f, 2, False, causal)),
    "sstw_decode_attention_i8": ("K3", lambda s, h, f, causal: k3_work(s, h, f, 1, True, causal)),
    "sstw_decode_attention_i4": ("K4", lambda s, h, f: k4_work(s, h, f)),
    "sstw_beam_cross_attention_bf16": ("K6", lambda b, h, f, k: k6_work(b, h, f, k, 2, False)),
    "sstw_beam_cross_attention_i8": ("K6", lambda b, h, f, k: k6_work(b, h, f, k, 1, True)),
    "sstw_beam_cross_attention_i4": ("K6", lambda b, h, f, k: k6_work(b, h, f, k, 0.5, True)),
}

# The kernel's name in a device trace (the __global__ function of csrc/).
TRACE_NAMES = {"K2": "flash_attention_kernel", "K3": "decode_attention_kernel",
               "K4": "decode_attention_i4_kernel", "K6": "beam_cross_attention_kernel"}


def least_seconds(calls: dict, kernel: str) -> float:
    """The least time the card could take for ``calls`` ({(function, ints):
    count}, as ``probe.KernelTap`` counts them) of ``kernel``."""
    total = 0.0
    for (fn, ints), n in calls.items():
        entry = KERNELS.get(fn)
        if entry is None or entry[0] != kernel:
            continue
        total += n * bound(*entry[1](*ints))[0]
    return total


BF16_PEAK = PEAK_OPS_PER_S["bf16"]
