"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided in the fixture, not at import). This file imports neither
JAX nor the JAX package, so on a machine with the card and no JAX run it
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Small shapes with the slices' widths (hd = 64, 20 heads, 5 beams, and 9 and
16 for K5's and K6's groups of query beams, ragged lengths and read bounds);
``chip_smoke.py`` checks the full slice shapes.
Tolerances: the JAX package's 3e-4 for the fp32 log-mel; for bf16 outputs,
two bf16 steps at the largest plain output (fp32 sums in another order, then
bf16 rounding), four for K6, whose plain version also rounds its softmax
weights to bf16. W8's fp32 logits: the worst-case error of two fp32 sums of
K terms in any order, 2 K 2^-24 times the sum of the terms' magnitudes.
"""

import pytest
import torch

from sentiric_stt_whisper_service_tpu_torch import kernels
from sentiric_stt_whisper_service_tpu_torch.ops import beam_attention as ba
from sentiric_stt_whisper_service_tpu_torch.ops import dense_w8 as w8
from sentiric_stt_whisper_service_tpu_torch.ops import decode_attention as da
from sentiric_stt_whisper_service_tpu_torch.ops import fused_mel, mel, quant
from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close_bf16(got, want, steps=2, per_item=False):
    """Within ``steps`` bf16 steps of the largest plain output; with
    ``per_item``, of each item's (the first axis) own largest as well."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= steps * 2**-7 * want.float().abs().max().item(), err
    for g, w in zip(got, want) if per_item else ():
        _close_bf16(g, w, steps)


# 300 and 100 frames: a ragged last tile of eight; 201 samples: the
# shortest clip (one frame); 1359 samples: one whole tile
@pytest.mark.parametrize("n_samples,n_mels", [(48000, 80), (16123, 128), (201, 80), (1359, 128)])
def test_log_mel(dev, n_samples, n_mels):
    audio = torch.randn(3, n_samples, device=dev) * 0.1
    before = kernels.LAUNCHES["log_mel"]
    got = mel.clamp_and_scale(fused_mel.log_mel_power_fused(audio, n_mels))
    assert kernels.LAUNCHES["log_mel"] == before + 1
    want = mel.clamp_and_scale(mel.log_mel_power(audio, n_mels))
    assert got.shape == want.shape == (3, n_samples // 160, n_mels)
    assert (got - want).abs().max().item() <= 3e-4


# ragged lengths around the 128-row query and 64-key tiles, and B * H that
# is a multiple of nothing
@pytest.mark.parametrize("B,H,L", [(2, 20, L) for L in (1, 64, 65, 127, 129, 300, 1500)]
                         + [(1, 13, 1500), (3, 7, 129)])
def test_flash_attention(dev, B, H, L):
    q, k, v = ((torch.randn(B, H, L, 64, device=dev) * s).bfloat16() for s in (0.3, 0.3, 1.0))
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    _close_bf16(got, attention_reference(q, k, v))


# a rank's rows of an sp mesh (Lq = Lk / sp) against every key, ragged pairs,
# and more query rows than keys
@pytest.mark.parametrize("B,H,Lq,Lk", [(1, 20, 750, 1500), (1, 20, 384, 768), (2, 7, 37, 101),
                                       (1, 3, 200, 64)])
def test_flash_attention_query_and_key_lengths(dev, B, H, Lq, Lk):
    q = (torch.randn(B, H, Lq, 64, device=dev) * 0.3).bfloat16()
    k, v = ((torch.randn(B, H, Lk, 64, device=dev) * s).bfloat16() for s in (0.3, 1.0))
    before = kernels.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v)
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape
    _close_bf16(got, attention_reference(q, k, v))
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(q, k, v[:, :, :-1].contiguous())


@pytest.mark.parametrize("form", ["bf16", "causal", "int8", "int4"])
def test_decode_attention(dev, form):
    S, H, HD, F = 3, 20, 64, 1500
    q = torch.randn(S, H, HD, device=dev).bfloat16()
    k, v = torch.randn(2, S, H, HD, F, device=dev).unbind(0)
    scale = HD**-0.5
    if form == "int4":
        (kp, ks), (vp, vs) = quant._quantize_kv(k, 4), quant._quantize_kv(v, 4)
        got = da.decode_attention_i4(q, kp, vp, ks, vs, scale=scale)
        want = da.decode_attention_reference(
            q, quant.unpack_nibbles_i8(kp), quant.unpack_nibbles_i8(vp), ks, vs, scale=scale)
    elif form == "int8":
        (k8, ks), (v8, vs) = quant.quantize_weight(k), quant.quantize_weight(v)
        got = da.decode_attention(q, k8, v8, ks, vs, scale=scale)
        want = da.decode_attention_reference(q, k8, v8, ks, vs, scale=scale)
    else:
        pos = torch.tensor([0, 600, F - 1], dtype=torch.int32, device=dev) if form == "causal" else None
        kb, vb = k.bfloat16(), v.bfloat16()
        got = da.decode_attention(q, kb, vb, pos=pos, scale=scale)
        want = da.decode_attention_reference(q, kb, vb, pos=pos, scale=scale)
    _close_bf16(got, want, per_item=form == "causal")


# F = 1 and 7: fewer positions than the cluster's eight blocks; 1501: odd;
# MAX_F: the largest whose blocks fit. offset 2: every row starts only 2-byte
# aligned (bf16 rows of odd F, int8 rows of any F, start on no 4-byte boundary).
@pytest.mark.parametrize("F", [1, 7, 1501, da.MAX_F])
@pytest.mark.parametrize("form", ["bf16", "causal", "int8"])
@pytest.mark.parametrize("offset", [0, 2])
def test_decode_attention_ragged(dev, F, form, offset):
    """K3's position split over its cluster at ragged F, under causal bounds
    on and just past a block boundary (position 0 only: seven idle blocks),
    and none (pos = -1: every position weighed evenly, as the plain version
    does); each item within tolerance of its own outputs."""
    S, H, HD = 4, 20, 64
    q = torch.randn(S, H, HD, device=dev).bfloat16()
    k, v = torch.randn(2, S, H, HD, F, device=dev).unbind(0)
    scales, pos = (), None
    if form == "int8":
        (k, ks), (v, vs) = quant.quantize_weight(k), quant.quantize_weight(v)
        scales = (ks, vs)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    if form == "causal":
        per = -(-F // 8)
        pos = torch.tensor([0, 2 * per - 1, 2 * per, -1], dtype=torch.int32,
                           device=dev).clamp(max=F - 1)
    if offset:
        n = offset // k.element_size()
        k, v = (torch.cat([torch.zeros(n, dtype=x.dtype, device=dev), x.reshape(-1)])[n:]
                .view(x.shape) for x in (k, v))
        assert k.data_ptr() % 16 == offset
    before = kernels.LAUNCHES["decode_attention"]
    got = da.decode_attention(q, k, v, *scales, pos=pos, scale=HD**-0.5)
    assert kernels.LAUNCHES["decode_attention"] == before + 1
    _close_bf16(got, da.decode_attention_reference(q, k, v, *scales, pos=pos, scale=HD**-0.5),
                per_item=True)


@pytest.mark.parametrize("R", [1, 11, 375, 750])  # F/2: eight blocks divide none of them
@pytest.mark.parametrize("offset", [0, 2])
def test_decode_attention_i4_ragged(dev, R, offset):
    """K4's column split over its cluster at ragged carrier widths, and a
    carrier that starts 2 bytes past a 16-byte boundary."""
    S, H, HD = 3, 20, 64
    q = torch.randn(S, H, HD, device=dev).bfloat16()
    k, v = torch.randn(2, S, H, HD, 2 * R, device=dev).unbind(0)
    (kp, ks), (vp, vs) = quant._quantize_kv(k, 4), quant._quantize_kv(v, 4)
    if offset:
        kp, vp = (torch.cat([torch.zeros(offset, dtype=x.dtype, device=dev), x.reshape(-1)])
                  [offset:].view(x.shape) for x in (kp, vp))
        assert kp.data_ptr() % 16 == offset
    before = kernels.LAUNCHES["decode_attention_i4"]
    got = da.decode_attention_i4(q, kp, vp, ks, vs, scale=HD**-0.5)
    assert kernels.LAUNCHES["decode_attention_i4"] == before + 1
    _close_bf16(got, da.decode_attention_reference(
        q, quant.unpack_nibbles_i8(kp), quant.unpack_nibbles_i8(vp), ks, vs, scale=HD**-0.5))


def _ancestry(B, K, C, pos, g):
    """A random valid ancestry: one source slot per (item, beam, position)
    before ``pos``, none after."""
    src = torch.randint(0, K, (B, K, C), generator=g)
    anc = torch.nn.functional.one_hot(src, K).permute(0, 1, 3, 2).bool().contiguous()
    anc[..., pos:] = False
    return anc


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("C,c_valid,pos", [(160, 0, 150), (160, 128, 100), (200, 77, 77)])
def test_beam_attention(dev, form, C, c_valid, pos):
    B, K, H, HD = 2, 5, 20, 64
    g = torch.Generator().manual_seed(C + c_valid)
    q = torch.randn(B * K, H, HD, generator=g).bfloat16().to(dev)
    k, v = (torch.randn(B * K, H, C, HD, generator=g) * 0.3 for _ in range(2))
    anc = _ancestry(B, K, C, pos, g).to(dev)
    scale = HD**-0.5
    kw = dict(scale=scale, c_valid=c_valid)
    if form == "int8":
        (k8, ks), (v8, vs) = (quant.quantize_weight(x.to(dev), axis=-1) for x in (k, v))
        kw.update(k_scale=ks, v_scale=vs)
        args = (q, k8, v8, anc, K)
    else:
        args = (q, k.bfloat16().to(dev), v.bfloat16().to(dev), anc, K)
    before = kernels.LAUNCHES["beam_attention"]
    got = ba.beam_attention(*args, **kw)
    assert kernels.LAUNCHES["beam_attention"] == before + 1
    _close_bf16(got, ba.beam_attention_reference(*args, **kw))


def _beam_case(dev, form, B, K, C, c_valid, g, masked_beam=True):
    """K5's inputs: ancestry live below a third of the read bound (so the
    last blocks of K5's position split hold no live row) and, with
    ``masked_beam``, one beam that reads nothing (the uniform average)."""
    H, HD = 20, 64
    q = torch.randn(B * K, H, HD, generator=g).bfloat16().to(dev)
    k, v = (torch.randn(B * K, H, C, HD, generator=g) * 0.3 for _ in range(2))
    anc = _ancestry(B, K, C, max(1, (c_valid or C) // 3), g)
    if masked_beam:
        anc[0, K - 1] = False
    kw = dict(scale=HD**-0.5, c_valid=c_valid)
    if form == "int8":
        (k8, ks), (v8, vs) = (quant.quantize_weight(x.to(dev), axis=-1) for x in (k, v))
        kw.update(k_scale=ks, v_scale=vs)
        return (q, k8, v8, anc.to(dev), K), kw
    return (q, k.bfloat16().to(dev), v.bfloat16().to(dev), anc.to(dev), K), kw


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("K", [1, 2, 5, 8, 9, 16])
@pytest.mark.parametrize("c_valid", [1, 37, 128, 129, 160])
def test_beam_attention_ragged(dev, form, K, c_valid):
    """K5's position split over its cluster at ragged read bounds, with
    blocks that hold no live row and a beam that reads nothing; 9 and 16
    beams in two groups of query beams."""
    args, kw = _beam_case(dev, form, 2, K, 160, c_valid, torch.Generator().manual_seed(K))
    before = kernels.LAUNCHES["beam_attention"]
    got = ba.beam_attention(*args, **kw)
    assert kernels.LAUNCHES["beam_attention"] == before + 1
    _close_bf16(got, ba.beam_attention_reference(*args, **kw))


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("K", [8, 32])
def test_beam_attention_chunks(dev, form, K):
    """A 448-row cache read whole by K beams, every row live: 896 (3,584 at
    K = 32, in groups of query beams that fit the shared memory) candidate
    rows a block, staged in chunks of 256 with the softmax carried across."""
    args, kw = _beam_case(dev, form, 1, K, 448, 0, torch.Generator().manual_seed(3),
                          masked_beam=False)
    args = (*args[:3], torch.ones_like(args[3]), args[4])
    _close_bf16(ba.beam_attention(*args, **kw), ba.beam_attention_reference(*args, **kw))


@pytest.mark.parametrize("form", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("K", [1, 5, 8, 9, 16])
@pytest.mark.parametrize("F,q_scale", [(1500, 1.0), (22, 1.0), (1500, 30.0)])
def test_beam_cross_attention(dev, form, K, F, q_scale):
    """F = 22: a quarter row of 11 carrier bytes; q_scale 30: peaked
    softmax rows, so the max subtraction matters."""
    B, H, HD = 2, 20, 64
    q = (torch.randn(B, H, K, HD, device=dev) * q_scale).bfloat16()
    k, v = torch.randn(2, B, H, HD, F, device=dev).unbind(0)
    scale = HD**-0.5
    before = kernels.LAUNCHES["beam_cross_attention"]
    if form == "int4":
        (kp, ks), (vp, vs) = quant._quantize_kv(k, 4), quant._quantize_kv(v, 4)
        got = ba.beam_cross_attention_i4(q, kp, vp, ks, vs, scale=scale)
        want = ba.beam_cross_attention_reference(
            q, quant.unpack_nibbles_i8(kp), quant.unpack_nibbles_i8(vp), ks, vs, scale=scale)
    elif form == "int8":
        (k8, ks), (v8, vs) = quant.quantize_weight(k), quant.quantize_weight(v)
        got = ba.beam_cross_attention(q, k8, v8, ks, vs, scale=scale)
        want = ba.beam_cross_attention_reference(q, k8, v8, ks, vs, scale=scale)
    else:
        kb, vb = k.bfloat16(), v.bfloat16()
        got = ba.beam_cross_attention(q, kb, vb, scale=scale)
        want = ba.beam_cross_attention_reference(q, kb, vb, scale=scale)
    assert kernels.LAUNCHES["beam_cross_attention"] == before + 1
    # the plain version rounds its softmax weights to bf16 (the JAX package's
    # _attend_xa), the kernel keeps them in fp32: four bf16 steps
    _close_bf16(got, want, steps=4)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 2, 10, 32, device=dev).bfloat16()  # head dim 32
    with pytest.raises(ValueError, match="64"):
        flash_attention(q, q, q)
    q = torch.randn(1, 2, 10, 64, device=dev)  # fp32
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, q, q)
    q = torch.randn(1, 2, 10, 64, device=dev).bfloat16().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q, q)
    q = torch.randn(1, 20, ba.MAX_BEAMS + 1, 64, device=dev).bfloat16()  # 33 beams
    k = torch.randn(1, 20, 64, 100, device=dev).bfloat16()
    with pytest.raises(ValueError, match="K = 33"):
        ba.beam_cross_attention(q, k, k)
    q = torch.randn(1, 20, 5, 64, device=dev).bfloat16()
    buf = torch.randn(20 * 64 * 100 + 1, device=dev).bfloat16()
    k = buf[1:].view(1, 20, 64, 100)  # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        ba.beam_cross_attention(q, k, k)
    q = torch.randn(1, 2, 64, device=dev).bfloat16()
    k = torch.randn(1, 2, 64, da.MAX_F + 1, device=dev).bfloat16()  # K3's blocks would not fit
    with pytest.raises(ValueError, match="outside"):
        da.decode_attention(q, k, k)
    q1 = torch.randn(9, 20, 64, device=dev).bfloat16()
    kv = torch.randn(9, 20, 16, 64, device=dev).to(torch.float8_e4m3fn)  # fp8 slot cache
    anc = torch.ones(1, 9, 9, 16, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        ba.beam_attention(q1, kv, kv, anc, 9)


@pytest.mark.parametrize("seconds", [0.5, 30.0])
def test_silero_sequence_lstm(dev, seconds):
    """Silero's recurrence on the card as one cuDNN LSTM call over the whole
    sequence, against the plain cell loop on the same features on the card
    within 5e-5 (both fp32, TF32 off: sums in another order, carried over
    up to 937 steps; 1.02e-5 measured at 30 s on an H100), and the whole
    clip's probabilities against the CPU's within 1e-4."""
    from sentiric_stt_whisper_service_tpu_torch.models import silero_vad as sv

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = sv.init_silero_params(g)
    audio = torch.randn(int(seconds * 16000), generator=g, device=dev) * 0.2
    with torch.inference_mode():
        feats = sv.silero_features(params, audio)
        seq = sv.lstm_sequence(sv.sequence_lstm(params), feats)
        cells = sv.lstm_cells(params, feats)
        assert seq.shape == cells.shape == (int(seconds * 16000) // sv.CHUNK, sv.STATE_DIM)
        assert (seq - cells).abs().max().item() <= 5e-5
        probs = sv.silero_frame_probs(params, audio)
        plain = sv.silero_frame_probs({k: v.cpu() for k, v in params.items()}, audio.cpu())
    assert (probs.cpu() - plain).abs().max().item() <= 1e-4


# P1 at the encoder's length (ragged against the 64-key tiles and 128-row
# query tiles), at one key, at lengths that straddle a key tile (64, 65), a
# query tile (127, 128, 129) and the ring (100 keys: two tiles, fewer than
# its four stages), at B * H = 139 (not a multiple of the 132 SMs, nor of the
# pre-pass's eight-block clusters' count per SM) and at B * H = 320 with 1500
# keys: 3,840 blocks of 128 rows, several waves.
@pytest.mark.parametrize("mode", ["qk8", "full8"])
@pytest.mark.parametrize("B,H,L", [(2, 20, 1500), (1, 3, 100), (2, 2, 1), (1, 2, 64), (1, 2, 65),
                                   (1, 3, 127), (1, 3, 128), (2, 1, 129), (1, 139, 200),
                                   (16, 20, 1500)])
def test_flash_q8(dev, mode, B, H, L):
    """The int8 codes bit for bit (the same IEEE divisions and rint); the
    output, in qk8, within two bf16 steps at max |plain| (fp32 sums in
    another order, then bf16), and in full8 within ``full8_tolerance`` per
    element: two bf16 steps at the element and a few p8 codes per row that
    an exp one ulp off flips, each worth max|v_col| / 127 over the row's s."""
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_q8 import (
        flash_q8,
        flash_q8_plain,
        full8_tolerance,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(L)
    q, k = ((torch.randn(B, H, L, 64, generator=g, device=dev) * 64**-0.25).bfloat16()
            for _ in range(2))
    v = torch.randn(B, H, L, 64, generator=g, device=dev).bfloat16()
    before = kernels.LAUNCHES["flash_q8"]
    got, codes = flash_q8(q, k, v, mode, return_codes=True)
    assert kernels.LAUNCHES["flash_q8"] == before + 1
    want, want_codes = flash_q8_plain(q, k, v, mode, return_codes=True)
    assert codes.keys() == want_codes.keys()
    for name, c in want_codes.items():
        assert torch.equal(codes[name], c), name
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if mode == "qk8":
        assert err.max().item() <= 2 * 2**-7 * want.float().abs().max().item()
    else:
        assert bool((err <= full8_tolerance(q, k, v, want)).all())


def test_device_trace_records_eager_and_graph_kernels(dev, tmp_path):
    """The recorder behind ``/debug/profile`` (``serving/device_trace``, the
    port's CUPTI source ``csrc/device_trace.cpp``): a trace taken on another
    thread while this one launches K1 eagerly and replays a CUDA graph of
    16 small kernels captured before the trace holds K1 by name and every
    node of each replay, as Chrome trace events, and drops nothing. The
    launches start half a second into the recording, after the tracer's
    lead-in (its start, CUPTI's set-up included, takes tens of
    milliseconds)."""
    import collections
    import json
    import threading
    import time

    from sentiric_stt_whisper_service_tpu_torch.serving import device_trace

    x = torch.randn(64, 64, device=dev)
    audio = torch.randn(1, 16000, device=dev) * 0.1
    fused_mel.log_mel_power_fused(audio, 80)  # the kernels built and loaded first
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(16):
            x.mul_(1.0001)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(16):
            x.mul_(1.0001)
    torch.cuda.synchronize()
    device_trace.lib()  # built before the trace
    stats = []
    tracer = threading.Thread(
        target=lambda: stats.append(device_trace.record(2.0, str(tmp_path / "trace.json"))))
    tracer.start()
    time.sleep(device_trace.LEAD_IN_S + 0.5)
    fused_mel.log_mel_power_fused(audio, 80)
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()
    tracer.join(timeout=60)
    assert not tracer.is_alive()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = collections.Counter(e["name"] for e in events)
    assert stats[0].events == len(events) == stats[0].kernels and stats[0].dropped == 0
    assert any("log_mel_kernel" in n for n in names), names
    assert sum(c for n, c in names.items() if "mul" in n.lower()) >= 5 * 16, names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)


# W8 at the rows and (K, N) of the main paths: decode steps of 1-8 rows, the
# pool (8), the gang (40), speculative verify (5, 10), prefill and the align
# passes (up to M_MAX); large-v3's fused qkv, o / cross q / cross o, fc1,
# fc2, and the tied logits.
W8_ROWS = sorted({1, 2, 5, 8, 10, 16, 40, 64, 128, w8.M_MAX})
W8_SHAPES = [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280)]
W8_VOCAB = 51866


def _w8_operands(dev, M, K, N, g):
    x = (torch.randn(M, K, device=dev, generator=g) * 0.5).bfloat16()
    w_q = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8, generator=g)
    scale = torch.rand(N, device=dev, generator=g) * 0.01 + 1e-4
    b = torch.randn(N, device=dev, generator=g).bfloat16()
    return x, w_q, scale, b


def _logits_close(got, x, emb_q, scale):
    want = w8.logits_w8_plain(x, emb_q, scale)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    magnitude = torch.matmul(x.float().abs(), emb_q.float().abs().T) * scale
    err = (got - want).abs()
    assert bool((err <= 2 * x.shape[-1] * 2**-24 * magnitude + 1e-30).all()), err.max().item()


@pytest.mark.parametrize("M", W8_ROWS)
@pytest.mark.parametrize("K,N", W8_SHAPES)
def test_dense_w8(dev, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M * 7 + K + N)
    x, w_q, scale, b = _w8_operands(dev, M, K, N, g)
    before = kernels.LAUNCHES["dense_w8"]
    got = w8.dense_w8(x, w_q, scale, b)
    bare = w8.dense_w8(x, w_q, scale)
    assert kernels.LAUNCHES["dense_w8"] == before + 2
    torch.cuda.synchronize()
    _close_bf16(got, w8.dense_w8_plain(x, w_q, scale, b))
    _close_bf16(bare, w8.dense_w8_plain(x, w_q, scale))


@pytest.mark.parametrize("M", W8_ROWS)
def test_logits_w8(dev, M):
    K = 1280
    g = torch.Generator(device=dev).manual_seed(M)
    x = (torch.randn(M, K, device=dev, generator=g) * 0.5).bfloat16()
    emb_q = torch.randint(-127, 128, (W8_VOCAB, K), device=dev, dtype=torch.int8, generator=g)
    scale = torch.rand(W8_VOCAB, device=dev, generator=g) * 0.01 + 1e-4
    before = kernels.LAUNCHES["dense_w8"]
    got = w8.logits_w8(x, emb_q, scale)
    assert kernels.LAUNCHES["dense_w8"] == before + 1
    torch.cuda.synchronize()
    _logits_close(got, x, emb_q, scale)


@pytest.mark.parametrize("M", [1, 8, 40, 130])
def test_w8_in_a_cuda_graph(dev, M):
    """Both forms captured in one graph and replayed on new inputs copied
    into the captured ones; the keyed calls the capture collects are its
    ``LAUNCHES`` delta, one a call, at (M, K, N)."""
    K, N = 1280, 3840
    g = torch.Generator(device=dev).manual_seed(M)
    x, w_q, scale, b = _w8_operands(dev, M, K, N, g)
    emb_q = torch.randint(-127, 128, (W8_VOCAB, K), device=dev, dtype=torch.int8, generator=g)
    emb_scale = torch.rand(W8_VOCAB, device=dev, generator=g) * 0.01 + 1e-4
    x_in = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: the library built and loaded
        w8.dense_w8(x_in, w_q, scale, b)
        w8.logits_w8(x_in, emb_q, emb_scale)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(kernels.LAUNCHES)
    with kernels.collecting() as keyed, torch.cuda.graph(graph):
        y = w8.dense_w8(x_in, w_q, scale, b)
        logits = w8.logits_w8(x_in, emb_q, emb_scale)
    added = {k: kernels.LAUNCHES[k] - n for k, n in before.items() if kernels.LAUNCHES[k] != n}
    assert added == {"dense_w8": 2}
    assert keyed == [("sstw_dense_w8", (M, K, N)), ("sstw_logits_w8", (M, K, W8_VOCAB))]
    for _ in range(3):
        x_new = (torch.randn(M, K, device=dev, generator=g) * 0.5).bfloat16()
        x_in.copy_(x_new)
        graph.replay()
        torch.cuda.synchronize()
        _close_bf16(y, w8.dense_w8_plain(x_new, w_q, scale, b))
        _logits_close(logits, x_new, emb_q, emb_scale)


def test_whisper_routes_int8_products_to_w8(dev):
    """``models/whisper.dense`` and ``tied_logits`` launch W8 at most
    ``M_MAX`` rows and cast above; the 3-d input keeps its leading axes."""
    from sentiric_stt_whisper_service_tpu_torch.models import whisper

    g = torch.Generator(device=dev).manual_seed(3)
    K, N = 1280, 1280
    _, w_q, scale, b = _w8_operands(dev, 1, K, N, g)
    p = whisper.Dense(w_q=w_q, scale=scale, b=b)
    for rows, launched in ((w8.M_MAX, 1), (w8.M_MAX + 1, 0)):
        x = torch.randn(rows, 1, K, device=dev, generator=g).bfloat16()
        before = kernels.LAUNCHES["dense_w8"]
        y = whisper.dense(x, p)
        assert kernels.LAUNCHES["dense_w8"] == before + launched
        assert y.shape == (rows, 1, N)
        _close_bf16(y.reshape(rows, N), w8.dense_w8_plain(x.reshape(rows, K), w_q, scale, b))


def test_w8_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x, w_q, scale, b = _w8_operands(dev, 4, 1280, 1280, g)
    with pytest.raises(ValueError, match="dtype"):
        w8.dense_w8(x.float(), w_q, scale, b)
    with pytest.raises(ValueError, match="multiples of 16"):
        w8.dense_w8(x[:, :1272].contiguous(), w_q[:1272].contiguous(), scale, b)
    with pytest.raises(ValueError, match="multiples of 16"):
        w8.dense_w8(x, w_q[:, :1272].contiguous(), scale[:1272].contiguous(), b[:1272].contiguous())
    buf = torch.empty(4 * 1280 + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        w8.dense_w8(buf[1:].view(4, 1280), w_q, scale, b)
    with pytest.raises(ValueError, match="shapes"):
        w8.logits_w8(x, w_q, scale[:7].contiguous())
