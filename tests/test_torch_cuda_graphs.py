"""The graphed decode loops (models/graphs.py) against eager decoding, on the
card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided in the fixture, not at import). This file imports neither
JAX nor the JAX package, so on a machine with the card and no JAX run it
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

The model is ``tiny`` at its published widths (head dim 64, which the
kernels take), bf16, int8 weights, random from a seed, over random encoder
output; B = 2. A graphed window runs the same kernels in the same order as
the eager one, so every field of the two ``DecodeResult``s must be equal,
bit for bit; so must a second request through the same captured class, an
aborted one, and a sampled one from the same generator state. The
continuous batcher's graphed step equals its eager step on the same
admissions (ticks driven by the test), every result bit for bit.
"""

import pytest
import torch

from sentiric_stt_whisper_service_tpu_torch import kernels
from sentiric_stt_whisper_service_tpu_torch.models import (
    DecodeGraphs,
    TokenIds,
    build_suppress_mask,
    config_for,
    decode_window,
    decode_window_beam,
    init_params,
    precompute_xa_kv,
)
from sentiric_stt_whisper_service_tpu_torch.ops.quant import fuse_decoder_qkv, quantize_params
from sentiric_stt_whisper_service_tpu_torch.runtime.batcher import ContinuousBatcher
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

pytestmark = pytest.mark.cuda

B, BUDGET = 2, 24
F8 = torch.float8_e4m3fn


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = config_for("tiny")
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        model = fuse_decoder_qkv(quantize_params(init_params(cfg, g)))
        xa = torch.randn((B, cfg.n_audio_ctx, cfg.n_audio_state), generator=g,
                         device=dev).to(cfg.dtype)
        slabs = {bits: precompute_xa_kv(cfg, model, xa, bits) for bits in (0, 8, 4)}
    tok = fallback_tokenizer(cfg.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sup = torch.from_numpy(build_suppress_mask(cfg.n_vocab, ids, tok.non_speech_tokens)).to(dev)
    sot = tok.sot_sequence("en")
    tinit = torch.full((B, cfg.n_text_ctx), ids.eot, dtype=torch.int64, device=dev)
    tinit[:, :len(sot)] = torch.tensor(sot, device=dev)
    return cfg, model, slabs, ids, sup, tinit, len(sot)


def _greedy(setup, bits, **kw):
    cfg, model, slabs, ids, sup, tinit, sb = setup
    kw.setdefault("self_dtype", F8 if bits else None)
    return decode_window(cfg, model, slabs[bits], tinit, sb, 0, ids, sup, max_len=sb + BUDGET,
                         **kw)


def _beam(setup, K, **kw):
    cfg, model, slabs, ids, sup, tinit, sb = setup
    return decode_window_beam(cfg, model, slabs[4], tinit, sb, 0, ids, sup, beam_size=K,
                              max_len=sb + BUDGET, **kw)


def _assert_equal(got, want):
    assert got is not None and want is not None
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("bits,cross_read", [(4, "decode_attention_i4"),
                                             (8, "decode_attention"), (0, "decode_attention")])
def test_greedy_graph_equals_eager(setup, bits, cross_read):
    cfg = setup[0]
    graphs = DecodeGraphs()
    eager = _greedy(setup, bits, graph=False)
    _greedy(setup, bits, graphs=graphs, sample_cap=4)  # captures the class
    (stats,) = graphs.stats()
    assert stats["graphs"] == 1 and stats["capture_s"] > 0
    kernels.reset_launch_counts()
    got = _greedy(setup, bits, graphs=graphs)
    n = kernels.LAUNCHES[cross_read]
    assert n > 0 and n % cfg.n_text_layer == 0  # a replay adds its capture's launches
    _assert_equal(got, eager)
    # the same class again, with read buckets over a 32-row cache
    buckets = _greedy(setup, bits, graphs=graphs, cvalid_rows=8)
    _assert_equal(buckets, _greedy(setup, bits, graph=False, cvalid_rows=8))
    assert len(graphs.stats()) == 2


@pytest.mark.parametrize("K", [5, 9])
def test_beam_graph_equals_eager(setup, K):
    cfg = setup[0]
    graphs = DecodeGraphs()
    eager = _beam(setup, K, graph=False)
    kernels.reset_launch_counts()
    got = _beam(setup, K, graphs=graphs)
    n5, n6 = kernels.LAUNCHES["beam_attention"], kernels.LAUNCHES["beam_cross_attention"]
    assert n5 == n6 and n5 > 0 and n5 % cfg.n_text_layer == 0
    _assert_equal(got, eager)
    _assert_equal(_beam(setup, K, graphs=graphs), eager)  # the captured class, reloaded


def test_sampled_graph_equals_eager(setup):
    """The same generator state gives the same draws, and both generators
    end in the same state."""
    dev = setup[1].decoder.pos_emb.device
    gen_e = torch.Generator(device=dev).manual_seed(3)
    gen_g = torch.Generator(device=dev).manual_seed(3)
    graphs = DecodeGraphs()
    eager = _greedy(setup, 4, temperature=0.7, generator=gen_e, graph=False)
    got = _greedy(setup, 4, temperature=0.7, generator=gen_g, graphs=graphs)
    _assert_equal(got, eager)
    assert torch.equal(gen_e.get_state(), gen_g.get_state())
    greedy = _greedy(setup, 4, graph=False)
    assert not torch.equal(got.tokens, greedy.tokens)  # it did sample


def _polls(fire_after):
    polls = []

    def should_abort():
        polls.append(1)
        return len(polls) > fire_after

    return should_abort, polls


def test_abort_mid_window_under_graphs(setup):
    """An abort after two chunks of 4 steps returns None after the same
    polls as the eager loop, greedy and beam; the next request through the
    same classes is whole."""
    graphs = DecodeGraphs()
    for kw in (dict(graph=False), dict(graphs=graphs)):
        abort, polls = _polls(2)
        assert _greedy(setup, 4, should_abort=abort, abort_chunk=4, **kw) is None
        assert len(polls) == 3, kw
        abort, polls = _polls(2)
        assert _beam(setup, 5, should_abort=abort, abort_chunk=4, **kw) is None
        assert len(polls) == 3, kw
    _assert_equal(_greedy(setup, 4, graphs=graphs, should_abort=lambda: False, abort_chunk=4),
                  _greedy(setup, 4, graph=False))
    _assert_equal(_beam(setup, 5, graphs=graphs, should_abort=lambda: False, abort_chunk=4),
                  _beam(setup, 5, graph=False))


def _batcher_run(setup, bits, graph):
    """Four requests through a 4-slot pool, ticks driven here: two windows
    admitted together, a raw 30 s window after two ticks, then a carried
    prompt into the first freed slot. Returns the results and the launches."""
    cfg, model, slabs, ids, sup, tinit, sb = setup
    sot = tinit[0, :sb].tolist()
    pool = ContinuousBatcher(cfg, model, ids, sup, max_slots=4, kv_bits=bits,
                             self_dtype=F8 if bits else None, graph=graph)
    pool._stop.set()  # park the worker: the test runs the ticks
    pool._wake.set()
    pool._thread.join(timeout=10)
    item = [{k: v[:, i : i + 1] for k, v in slabs[bits].items()} for i in range(B)]
    audio = torch.Generator().manual_seed(1)
    window = (0.05 * torch.randn(480000, generator=audio)).numpy()
    kernels.reset_launch_counts()
    futs = [pool.submit_encoded(item[i], sot, 0, max_tokens=BUDGET) for i in range(B)]
    pool._worker_tick()
    pool._worker_tick()
    futs.append(pool.submit(window, sot, 0, max_tokens=BUDGET))
    futs.append(pool.submit_encoded(item[1], [ids.sot_prev, 500, 501] + sot, 3,
                                    max_tokens=BUDGET + 8))
    for _ in range(500):
        pool._worker_tick()
        if all(f.done() for f in futs):
            break
    launches = dict(kernels.LAUNCHES)
    pool.shutdown()
    return [f.result(timeout=1) for f in futs], launches


@pytest.mark.parametrize("bits", [4, 8])
def test_batcher_graph_equals_eager(setup, bits):
    """Both quantized pools hold an int8 container (an int4 carrier is
    unpacked at admission), so their step reads it with K3, never K4."""
    cfg = setup[0]
    eager, _ = _batcher_run(setup, bits, graph=False)
    graphed, launches = _batcher_run(setup, bits, graph=True)
    n_k3 = launches["decode_attention"]
    assert n_k3 > 0 and n_k3 % cfg.n_text_layer == 0 and launches["decode_attention_i4"] == 0
    assert launches["log_mel"] == 1 and launches["flash_attention"] == cfg.n_audio_layer
    for got, want in zip(graphed, eager):
        for key in ("tokens", "token_logprobs"):
            assert (got[key] == want[key]).all(), key
        for key in ("sum_logprob", "avg_logprob", "no_speech_prob"):
            assert got[key] == want[key], key
