"""Int8 flash-attention probe for the encoder (SageAttention style), on the
card: the JAX package's ``tools/bench_flash_int8.py`` over the port's
kernels.

Variants:
  base  : the production bf16 kernel (K2, ``ops/flash_attention``)
  qk8   : P1 (``ops/flash_q8``), q per row and k per head quantized to int8
          inside the kernel; int8 QKᵀ, bf16 PV
  full8 : P1, qk8 plus int8 PV (e scaled to [0, 127], v per channel)

For each it prints one JSON line: the card, ms per call (CUDA events around
20 calls after a warm-up; the host's clock on the CPU), TFLOP/s over the
4·B·H·L²·d operations of the two products, the relative RMS and max error
against fp32 attention (``attention_reference`` on fp32 copies of the
inputs, TF32 off), and the launches of each kernel in the checked call. A
variant that fails fails the run.

    python -m sentiric_stt_whisper_service_tpu_torch.tools.bench_flash_int8

``BENCH_B``, ``BENCH_H``, ``BENCH_L`` and ``BENCH_D`` set the shape
(default 16, 20, 1500, 64); the inputs come from numpy's seed-0 generator:
q and k at scale d^-0.25, v at unit scale, in bf16. It runs on the card;
``main(device="cpu")`` runs the plain versions on the CPU (the tests).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import kernels
from ..ops.flash_attention import attention_reference, flash_attention
from ..ops.flash_q8 import flash_q8

VARIANTS = ("base", "qk8", "full8")


def shape_from_env() -> tuple[int, int, int, int]:
    return tuple(int(os.environ.get(f"BENCH_{n}", d))
                 for n, d in (("B", "16"), ("H", "20"), ("L", "1500"), ("D", "64")))


def make_inputs(shape, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The probe's q, k, v in bf16 on ``device``, from numpy's seed 0."""
    rng = np.random.default_rng(0)
    scale = shape[-1] ** -0.25
    q = rng.standard_normal(shape) * scale
    k = rng.standard_normal(shape) * scale
    v = rng.standard_normal(shape)
    return tuple(torch.from_numpy(x).to(device=device, dtype=torch.bfloat16) for x in (q, k, v))


def fp32_reference(q, k, v) -> torch.Tensor:
    """fp32 attention of the bf16 inputs (no bf16 weights, fp32 output)."""
    return attention_reference(q.float(), k.float(), v.float())


def rel_errors(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(RMS, max) of |out - ref| over ref's standard deviation."""
    err = out.float() - ref
    std = ref.std().item() or 1.0
    return err.pow(2).mean().sqrt().item() / std, err.abs().max().item() / std


def variant_fn(name: str, q, k, v):
    if name == "base":
        return lambda: flash_attention(q, k, v)
    return lambda: flash_q8(q, k, v, name)


def time_ms(fn, device, iters: int = 20) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def main(device: str = "cuda") -> list[dict]:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_flash_int8: no CUDA device (pass device='cpu' for the "
                           "plain versions)")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 reference in full fp32
    shape = shape_from_env()
    B, H, L, D = shape
    q, k, v = make_inputs(shape, dev)
    ref = fp32_reference(q, k, v)
    flops = 4 * B * H * L * L * D
    rows = []
    for variant in VARIANTS:
        fn = variant_fn(variant, q, k, v)
        before = dict(kernels.LAUNCHES)
        out = fn()
        launched = {n: c - before[n] for n, c in kernels.LAUNCHES.items() if c != before[n]}
        if not bool(torch.isfinite(out.float()).all()):
            raise RuntimeError(f"bench_flash_int8: {variant} gave non-finite values")
        rms, mx = rel_errors(out, ref)
        ms = time_ms(fn, dev)
        row = {"variant": variant, "device": name, "shape": list(shape), "ms": ms,
               "tflops": flops / ms / 1e9, "rel_rms_err": rms, "rel_max_err": mx,
               "launches": launched}
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
