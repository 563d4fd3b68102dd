"""Encoder attention (ops/flash_attention, K2's plain version on CPU)
against the JAX package's Pallas kernel in interpret mode, and K2's own
tile recurrence (csrc/flash_attention.cu) emulated in torch against the same.

Tolerance: atol 2e-5 in fp32, as tests/test_flash_attention.py holds the
Pallas kernel — the same softmax(q kᵀ) v with sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.ops.flash_attention import (
    attention_reference as ref_attention,
)
from sentiric_stt_whisper_service_tpu.ops.flash_attention import flash_attention as ref_flash
from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


LOG2E = 1.4426950408889634


def qkv(L, B=2, H=3, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, L, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, H, L, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, H, L, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("L", [256, 300, 1500])
def test_flash_matches_pallas(L):
    q, k, v = qkv(L)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def k2_tile_recurrence(q, k, v, bq=128, bk=64):
    """K2's arithmetic in fp32: 128-row query tiles, 64-key tiles with the
    keys past L zero-filled and masked, the online softmax in the log2 domain
    (one multiply-add folds log2(e) and the running max into the exponent),
    normalisation deferred to the end."""
    B, H, L, d = q.shape
    n = -(-L // bk) * bk
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, n - L)) for x in (k, v))
    out = torch.empty_like(q)
    for q0 in range(0, L, bq):
        qt = q[:, :, q0:q0 + bq]
        m = torch.full(qt.shape[:-1], -torch.inf)
        l = torch.zeros(qt.shape[:-1])
        acc = torch.zeros(qt.shape)
        for k0 in range(0, n, bk):
            s = qt @ kp[:, :, k0:k0 + bk].transpose(-1, -2)
            s[..., torch.arange(k0, k0 + bk) >= L] = -torch.inf
            mx = torch.maximum(m, s.amax(-1))
            a = torch.exp2((m - mx) * LOG2E)
            p = torch.exp2(s * LOG2E - mx[..., None] * LOG2E)
            l = l * a + p.sum(-1)
            acc = acc * a[..., None] + p @ vp[:, :, k0:k0 + bk]
            m = mx
        out[:, :, q0:q0 + bq] = acc / l[..., None]
    return out


@pytest.mark.parametrize("L", [65, 300, 1500])
def test_k2_tile_recurrence_matches_pallas(L):
    q, k, v = qkv(L, seed=L)
    got = k2_tile_recurrence(*(torch.from_numpy(x) for x in (q, k, v)))
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_plain_version_matches_reference_in_bf16():
    """bf16 inputs: both round the softmax weights to bf16 before the
    second product; tolerance one bf16 step at |x| ≤ 1."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 2, 100, 64)).astype(np.float32) * s for s in (0.3, 0.3, 1))
    got = attention_reference(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want = ref_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2**-7)
