"""The kernels' work and the Whisper family's FLOPs against hand-worked values at
phase 3's shapes (``chip_smoke.py``: K2 [4, 20, 1500, 64] bf16; K3 int8 and
K4 at S = 4 and S = 8 over F = 1500; K6 int4 at B = 4 and B = 8, K = 5)."""

from __future__ import annotations

import pytest

from benchmark import bounds
from benchmark.families.whisper import flops


def ms(work):
    return bounds.bound(*work)[0] * 1e3


def test_k2_is_bound_by_operations():
    n_bytes, ops, exps = bounds.k2_work(4 * 20, 1500, 1500)
    assert n_bytes == 4 * 4 * 20 * 1500 * 64 * 2  # q, k, v, out in bf16
    assert ops == {"bf16": 4 * 4 * 20 * 1500 * 1500 * 64}  # 46.08e9
    assert exps == 4 * 20 * 1500 * 1500
    t, by = bounds.bound(n_bytes, ops, exps)
    assert by == "operations" and t * 1e3 == pytest.approx(0.04659, rel=1e-3)


@pytest.mark.parametrize("s,want_ms", [(4, 0.00488), (8, 0.00976)])
def test_k3_int8_is_bound_by_bytes(s, want_ms):
    n_bytes, ops = bounds.k3_work(s, 20, 1500, 1, True, False)
    # q and out bf16, k and v int8, two fp32 scale rows per position
    assert n_bytes == 2 * s * 20 * 64 * 2 + 2 * s * 20 * 64 * 1500 + 2 * 4 * s * 20 * 1500
    assert ops == {"int8": 4 * s * 20 * 64 * 1500}
    assert ms((n_bytes, ops)) == pytest.approx(want_ms, rel=2e-3)


@pytest.mark.parametrize("s,want_ms", [(4, 0.002585), (8, 0.005170)])
def test_k4(s, want_ms):
    n_bytes, _ = bounds.k4_work(s, 20, 1500)
    assert n_bytes == 2 * s * 20 * 64 * 2 + 2 * s * 20 * 64 * 750 + 2 * 4 * s * 20 * 1500
    assert ms(bounds.k4_work(s, 20, 1500)) == pytest.approx(want_ms, rel=2e-3)


@pytest.mark.parametrize("b,want_ms", [(4, 0.002609), (8, 0.005218)])
def test_k6_int4(b, want_ms):
    n_bytes, ops = bounds.k6_work(b, 20, 1500, 5, 0.5, True)
    assert n_bytes == 2 * b * 20 * 5 * 64 * 2 + 2 * b * 20 * 64 * 750 + 2 * 4 * b * 20 * 1500
    assert ops == {"int8": 4 * b * 20 * 5 * 64 * 1500}
    assert ms((n_bytes, ops)) == pytest.approx(want_ms, rel=2e-3)


def test_least_seconds_sums_calls_at_their_sizes():
    calls = {("sstw_decode_attention_i4", (8, 20, 1500)): 10,
             ("sstw_decode_attention_i4", (4, 20, 1500)): 5,
             ("sstw_beam_cross_attention_i4", (8, 20, 1500, 5)): 3,
             ("sstw_decode_attention_i8", (8, 20, 1500, False)): 7,
             ("sstw_flash_attention", (80, 1500, 1500)): 2,
             ("sstw_log_mel", (1, 480000, 3000, 128, 394)): 9}
    assert bounds.least_seconds(calls, "K4") * 1e3 == pytest.approx(
        10 * 0.005170 + 5 * 0.002585, rel=2e-3)
    assert bounds.least_seconds(calls, "K6") * 1e3 == pytest.approx(3 * 0.005218, rel=2e-3)
    assert bounds.least_seconds(calls, "K3") * 1e3 == pytest.approx(7 * 0.00976, rel=2e-3)
    assert bounds.least_seconds(calls, "K2") * 1e3 == pytest.approx(2 * 0.04659, rel=1e-3)


LARGE_V3 = dict(d_model=1280, encoder_layers=32, decoder_layers=32, encoder_ffn_dim=5120,
                decoder_ffn_dim=5120, num_mel_bins=128, vocab_size=51866,
                max_source_positions=1500)


def test_model_flops_large_v3():
    d, t = 1280, 1500
    layer = 2 * t * 4 * d * d + 2 * t * 2 * d * 4 * d + 4 * t * t * d  # 70.5e9
    convs = 2 * 3000 * 3 * 128 * d + 2 * t * 3 * d * d
    assert flops.encode_flops(LARGE_V3) == 32 * layer + convs
    assert flops.encode_flops(LARGE_V3) == pytest.approx(2.2735e12, rel=1e-3)
    assert flops.cross_kv_flops(LARGE_V3) == 32 * 4 * t * d * d  # 314.6e9
    # a token at position 0: 6 d^2 products (self q, k, v, o; cross q, o),
    # the MLP, attention over one self position and 1500 audio ones; logits
    tok = 32 * (12 * d * d + 16 * d * d + 4 * d + 4 * t * d) + 2 * d * 51866
    assert flops.token_flops(LARGE_V3, 0) == tok
    # about 2.4 TFLOP a 128-token request (the issue's sizing)
    assert flops.window_flops(LARGE_V3, 131) == pytest.approx(2.82e12, rel=0.02)
    turbo = dict(LARGE_V3, decoder_layers=4)
    assert flops.window_flops(turbo, 131, beams=1) < flops.window_flops(LARGE_V3, 131)
    assert flops.window_flops(LARGE_V3, 10, beams=5) - flops.window_flops(LARGE_V3, 10) == \
        pytest.approx(4 * sum(flops.token_flops(LARGE_V3, p) for p in range(10)))
