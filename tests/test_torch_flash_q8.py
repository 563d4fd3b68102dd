"""P1, the int8 encoder attention probe: the port's plain version
(``ops/flash_q8.flash_q8_plain``, the CPU path of ``flash_q8``) against the
JAX package's Pallas kernel (``tools/bench_flash_int8.py:flash_q8``) run in
TPU interpret mode, on the same bf16 inputs from a numpy seed.

Tolerances, as shares of the fp32 reference's std: XLA's CPU arithmetic
rounds ``q * (127 / qmax)`` differently from a true division for a few q
codes (each by 1), and a flipped q code moves a row's scores; full8
amplifies that through the p8 = round(e * 127) codes. For scale, the JAX
kernel's own error against fp32 attention is 0.06-0.37 x std at these
shapes. The k codes are equal. The card tests hold the kernel to the plain
version (``tests/test_torch_cuda_kernels.py``). Also here: the v8 tile
layout the kernel's pre-pass writes (``tile_v8`` / ``untile_v8``), and the
arithmetic identities the kernel rests on (the integer row max, its int32 ->
fp32 step and p8's rint by a float add), on random inputs.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from sentiric_stt_whisper_service_tpu.ops.flash_attention import (
    attention_reference as jax_attention_reference,
)
from sentiric_stt_whisper_service_tpu_torch import kernels
from sentiric_stt_whisper_service_tpu_torch.ops.flash_q8 import (
    KEY_TILE,
    V8_ORDER,
    flash_q8,
    flash_q8_plain,
    full8_tolerance,
    tile_v8,
    untile_v8,
)
from sentiric_stt_whisper_service_tpu_torch.tools import bench_flash_int8
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
TOL = {"qk8": (0.05, 0.005), "full8": (0.25, 0.02)}  # (max, RMS) x the reference's std


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_flash_int8", ROOT / "tools" / "bench_flash_int8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(shape):
    rng = np.random.default_rng(0)
    scale = shape[-1] ** -0.25
    arrays = [rng.standard_normal(shape) * scale, rng.standard_normal(shape) * scale,
              rng.standard_normal(shape)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    th = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in jx]
    return jx, th


@jax.jit
def _jax_codes(q, k, v):
    """The Pallas kernel's codes, by its own expressions, per (batch, head)."""
    q, k, v = (x.astype(jnp.float32) for x in (q, k, v))
    qmax = jnp.maximum(jnp.max(jnp.abs(q), axis=-1, keepdims=True), 1e-6)
    kmax = jnp.maximum(jnp.max(jnp.abs(k), axis=(-2, -1), keepdims=True), 1e-6)
    vmax = jnp.maximum(jnp.max(jnp.abs(v), axis=-2, keepdims=True), 1e-6)
    return tuple(jnp.round(x * (127.0 / m)).astype(jnp.int8)
                 for x, m in ((q, qmax), (k, kmax), (v, vmax)))


# 1500: the encoder's length (ragged against 768-row blocks); 100: ragged and
# B*H > 1 with padding; 768: a multiple of the JAX kernel's block
@pytest.mark.parametrize("shape", [(1, 2, 1500, 64), (2, 3, 100, 64), (1, 2, 768, 64)])
@pytest.mark.parametrize("mode", ["qk8", "full8"])
def test_plain_matches_jax_kernel(mode, shape):
    tool = _jax_tool()
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tool.flash_q8(jq, jk, jv, mode), np.float32)
    got, codes = flash_q8_plain(tq, tk, tv, mode, return_codes=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    std = float(np.asarray(jax_attention_reference(jq, jk, jv), np.float32).std())
    err = np.abs(got.float().numpy() - want)
    max_tol, rms_tol = TOL[mode]
    assert err.max() <= max_tol * std, (err.max() / std, max_tol)
    assert np.sqrt((err**2).mean()) <= rms_tol * std

    q8, k8, v8 = (np.asarray(c) for c in _jax_codes(jq, jk, jv))
    dq = codes["q8"].numpy().astype(np.int32) - q8
    assert np.abs(dq).max() <= 1 and np.count_nonzero(dq) <= 1e-3 * dq.size
    np.testing.assert_array_equal(codes["k8"].numpy(), k8)
    if mode == "full8":
        np.testing.assert_array_equal(codes["v8"].numpy(), v8)
    else:
        assert "v8" not in codes


def test_cpu_tensors_take_the_plain_version():
    (_, _, _), (tq, tk, tv) = _inputs((1, 2, 130, 64))
    before = dict(kernels.LAUNCHES)
    for mode in ("qk8", "full8"):
        torch.testing.assert_close(flash_q8(tq, tk, tv, mode), flash_q8_plain(tq, tk, tv, mode),
                                   rtol=0, atol=0)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="mode"):
        flash_q8(tq, tk, tv, "int4")
    meta = torch.empty(1, 2, 64, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_q8(meta, meta, meta)


def test_full8_tolerance_admits_rounding_and_rejects_a_cut_pv():
    """The card's full8 bound: one bf16 step at every element passes; a PV
    without its first 64-key tile, or with one channel 10 % off, fails."""
    q, k, v = bench_flash_int8.make_inputs((1, 2, 1500, 64), "cpu")
    want = flash_q8_plain(q, k, v, "full8")
    tol = full8_tolerance(q, k, v, want)
    assert tol.shape == want.shape and bool((tol > 0).all())

    def worst(out):
        return ((out.float() - want.float()).abs() / tol).max().item()

    assert worst(want.view(torch.int16).add(1).view(torch.bfloat16)) <= 0.5
    v_cut, v_off = v.clone(), v.clone()
    v_cut[:, :, :64] = 0
    v_off[..., 5] *= 1.1
    assert worst(flash_q8_plain(q, k, v_cut, "full8")) > 10
    assert worst(flash_q8_plain(q, k, v_off, "full8")) > 1


def test_probe_main_on_the_cpu(monkeypatch, capsys):
    """The probe's three variants at a small size on the CPU: one JSON line
    each, no kernel launched, errors against fp32 attention that order as
    the quantization does (base < qk8 < full8)."""
    for name, value in (("B", "1"), ("H", "2"), ("L", "200"), ("D", "64")):
        monkeypatch.setenv(f"BENCH_{name}", value)
    before = dict(kernels.LAUNCHES)
    rows = bench_flash_int8.main(device="cpu")
    assert kernels.LAUNCHES == before
    assert [r["variant"] for r in rows] == ["base", "qk8", "full8"]
    assert len(capsys.readouterr().out.strip().splitlines()) == 3
    for r in rows:
        assert r["device"] == "cpu" and r["shape"] == [1, 2, 200, 64] and r["ms"] > 0
        assert 0 < r["rel_rms_err"] <= r["rel_max_err"] < 1
    assert rows[0]["rel_rms_err"] < rows[1]["rel_rms_err"] < rows[2]["rel_rms_err"]
    q, k, v = bench_flash_int8.make_inputs((1, 2, 200, 64), "cpu")
    rms, mx = bench_flash_int8.rel_errors(flash_q8_plain(q, k, v, "full8"),
                                          bench_flash_int8.fp32_reference(q, k, v))
    assert (rms, mx) == (rows[2]["rel_rms_err"], rows[2]["rel_max_err"])


def test_probe_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_flash_int8.main()


@pytest.mark.parametrize("bh,L", [(1, 1), (2, 64), (3, 65), (2, 100), (1, 1500)])
def test_v8_tiles_round_trip(bh, L):
    """``tile_v8`` lays v8 codes out as the kernel's pre-pass writes them
    (64-key tiles, channel-major, keys in ``V8_ORDER``, zeros past L);
    ``untile_v8``, which turns the kernel's tiles back into codes for
    ``return_codes``, is its inverse."""
    rng = np.random.default_rng(L)
    v8 = torch.from_numpy(rng.integers(-127, 128, size=(bh, L, 64), dtype=np.int8))
    tiles = tile_v8(v8)
    n = -(-L // KEY_TILE)
    assert tiles.shape == (bh, n, 64, KEY_TILE) and tiles.dtype == torch.int8
    assert torch.equal(untile_v8(tiles, L), v8)
    for w in range(KEY_TILE):  # slot w of tile i holds key 64 i + V8_ORDER[w], all channels
        key = V8_ORDER[w]
        if key < L:
            assert torch.equal(tiles[:, 0, :, w], v8[:, key])
    assert not untile_v8(tiles, n * KEY_TILE)[:, L:].any()
    # V8_ORDER is the order in which a lane of the PV product's A fragment
    # takes its keys: k-index 4t + b of each group of 16 holds key
    # 8 (b // 2) + 2t + b % 2.
    assert sorted(V8_ORDER) == list(range(KEY_TILE))
    for i, key in enumerate(V8_ORDER):
        t, b = (i % 16) // 4, i % 4
        assert key == 16 * (i // 16) + 8 * (b // 2) + 2 * t + b % 2


_S32_MAX = 127 * 127 * 64  # the largest |q8 . k8| at d = 64


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(-_S32_MAX, _S32_MAX), min_size=1, max_size=64),
       st.floats(2.0**-40, 2.0**10, allow_nan=False, allow_infinity=False, width=32))
def test_integer_row_max_equals_the_float_max(scores, mult):
    """The kernel's pass 1 takes the row max on the int32 scores and scales
    it once: fmul(float(max s32), mult) equals max(fmul(float(s32), mult))
    bit for bit, since float(s32) is exact below 2^24 and a product with a
    positive mult does not decrease as s32 grows. Its int32 -> fp32 step (an
    integer add to 1.5 * 2^23, then a float subtract) equals the conversion
    for |s32| < 2^22."""
    s32 = np.asarray(scores, np.int32)
    m = np.float32(mult)
    per_element = (s32.astype(np.float32) * m).max()
    assert (np.float32(s32.max()) * m).tobytes() == per_element.tobytes()
    magic = (s32 + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    assert magic.tobytes() == s32.astype(np.float32).tobytes()


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(0.0, 1.0, allow_nan=False, width=32), min_size=1, max_size=64))
def test_p8_by_a_float_add_equals_rint(e):
    """full8's p8 = rint(e * 127): the kernel adds 1.5 * 2^23 to e * 127 and
    takes the low byte, which rounds half to even as torch.round does."""
    x = np.asarray(e, np.float32) * np.float32(127.0)
    low = ((x + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(np.int64)
    assert np.array_equal(low, torch.round(torch.from_numpy(x)).long().numpy())
