"""The weight-only int8 product (``ops/dense_w8``, W8) on the CPU: its plain
versions against the JAX package's ``dense`` and ``tied_logits``, and how
``models/whisper.dense`` and ``tied_logits`` route int8 products by rows.
The kernel itself is held to the plain versions on the card
(``tests/test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu_torch.models import whisper
from sentiric_stt_whisper_service_tpu_torch.ops import dense_w8
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

K, N = 64, 48


def _weights(rng, with_bias: bool):
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scale = (rng.random(N) * 0.02 + 1e-3).astype(np.float32)
    b = (rng.standard_normal(N) * 0.5).astype(ml_dtypes.bfloat16) if with_bias else None
    return w_q, scale, b


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("values", ["integers", "normal"])
def test_dense_plain_is_the_jax_arithmetic(rng, with_bias, values):
    """bf16 x: the fp32 sum times the scale, rounded once, plus the bias.
    Integer x makes every fp32 sum exact in any order, so the two agree bit
    for bit; normal x leaves them one bf16 step apart at most, where the
    sums' rounding order puts a value on the other side of a bf16 tie."""
    w_q, scale, b = _weights(rng, with_bias)
    x = (rng.integers(-8, 9, (3, 5, K)) if values == "integers"
         else rng.standard_normal((3, 5, K))).astype(ml_dtypes.bfloat16)
    p = {"w_q": jnp.asarray(w_q), "scale": jnp.asarray(scale)}
    if b is not None:
        p["b"] = jnp.asarray(b)
    want = np.asarray(ref.dense(jnp.asarray(x), p)).astype(np.float32)
    got = dense_w8.dense_w8_plain(_bf16(x.astype(np.float32)), torch.from_numpy(w_q),
                                  torch.from_numpy(scale),
                                  None if b is None else _bf16(b.astype(np.float32)))
    assert got.dtype == torch.bfloat16
    if values == "integers":
        np.testing.assert_array_equal(_bf16_np(got), want)
    else:
        np.testing.assert_allclose(_bf16_np(got), want, rtol=2**-8, atol=0)


@pytest.mark.parametrize("values", ["integers", "normal"])
def test_logits_plain_is_the_jax_arithmetic(rng, values):
    """fp32 logits: the fp32 sum times the row scale. Integer x: bit-equal;
    normal x: within fp32 rounding of the sums (another order)."""
    emb_q = rng.integers(-127, 128, (N, K)).astype(np.int8)
    scale = (rng.random(N) * 0.02 + 1e-3).astype(np.float32)
    x = (rng.integers(-8, 9, (2, 3, K)) if values == "integers"
         else rng.standard_normal((2, 3, K))).astype(ml_dtypes.bfloat16)
    dec = {"tok_emb_q": jnp.asarray(emb_q), "tok_emb_scale": jnp.asarray(scale)}
    want = np.asarray(ref.tied_logits(jnp.asarray(x), dec))
    got = dense_w8.logits_w8_plain(_bf16(x.astype(np.float32)), torch.from_numpy(emb_q),
                                   torch.from_numpy(scale))
    assert got.dtype == torch.float32
    if values == "integers":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("dense_w8_plain", "logits_w8_plain"):
            orig = getattr(dense_w8, name)
            monkeypatch.setattr(dense_w8, name, self._wrap(name, orig))

    def _wrap(self, name, orig):
        def spy(x, *args):
            self.calls.append((name, dense_w8.rows(x)))
            return orig(x, *args)
        return spy


def _layer(rng, dtype):
    w_q, scale, b = _weights(rng, True)
    return whisper.Dense(w_q=torch.from_numpy(w_q), scale=torch.from_numpy(scale),
                         b=_bf16(b.astype(np.float32)).to(dtype))


class _Dec:
    def __init__(self, rng):
        self.tok_emb_q = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8))
        self.tok_emb_scale = torch.from_numpy((rng.random(N) * 0.02).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 40, dense_w8.M_MAX])
def test_cpu_products_up_to_m_max_take_the_plain_version(rng, monkeypatch, dtype, rows):
    spy = _Spy(monkeypatch)
    p, dec = _layer(rng, dtype), _Dec(rng)
    x = torch.from_numpy(rng.standard_normal((rows, 1, K)).astype(np.float32)).to(dtype)
    with torch.inference_mode():
        y = whisper.dense(x, p)
        logits = whisper.tied_logits(x, dec)
    assert spy.calls == [("dense_w8_plain", rows), ("logits_w8_plain", rows)]
    assert y.dtype == dtype and y.shape == (rows, 1, N)
    torch.testing.assert_close(y, dense_w8.dense_w8_plain(x, p.w_q, p.scale, p.b),
                               rtol=0, atol=0)
    assert logits.dtype == torch.float32 and logits.shape == (rows, 1, N)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_above_m_max_keep_the_cast(rng, monkeypatch, dtype):
    """Above ``M_MAX`` rows: the weight cast to x's dtype, ``torch.matmul``,
    then the scale (the encoder's and the cross K/V's products)."""
    spy = _Spy(monkeypatch)
    p, dec = _layer(rng, dtype), _Dec(rng)
    x = torch.from_numpy(
        rng.standard_normal((dense_w8.M_MAX + 1, K)).astype(np.float32)).to(dtype)
    with torch.inference_mode():
        y = whisper.dense(x, p)
        logits = whisper.tied_logits(x, dec)
    assert spy.calls == []
    want = (torch.matmul(x, p.w_q.to(dtype)).float() * p.scale).to(dtype) + p.b
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    torch.testing.assert_close(
        logits, torch.matmul(x.float(), dec.tok_emb_q.float().T) * dec.tok_emb_scale,
        rtol=0, atol=0)


@pytest.mark.parametrize("role", ["row", "column"])
def test_tensor_parallel_bias_placement(rng, monkeypatch, role):
    """A row-parallel layer's partial products are reduced, then the bias is
    added once; a column-parallel layer's bias goes into the product. The
    reduce over two ranks holding the same partial doubles it."""
    monkeypatch.setattr(whisper._ReduceFromTP, "apply", staticmethod(lambda y, group: 2 * y))
    monkeypatch.setattr(whisper._CopyToTP, "apply", staticmethod(lambda x, group: x))
    p = _layer(rng, torch.bfloat16)
    p.tp_group, p.tp_role = object(), role
    x = torch.from_numpy(rng.standard_normal((4, 1, K)).astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        y = whisper.dense(x, p)
    if role == "row":
        want = 2 * dense_w8.dense_w8_plain(x, p.w_q, p.scale) + p.b
    else:
        want = dense_w8.dense_w8_plain(x, p.w_q, p.scale, p.b)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_serves(rng):
    x = torch.zeros((dense_w8.M_MAX, 8), dtype=torch.bfloat16)
    assert dense_w8.serves(x) and dense_w8.serves(x.float())
    assert not dense_w8.serves(torch.zeros((dense_w8.M_MAX + 1, 8)))
    assert dense_w8.rows(torch.zeros((2, 3, 8))) == 6
