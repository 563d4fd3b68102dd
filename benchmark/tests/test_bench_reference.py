"""The plain reference against the port, on the CPU at the test size: its
frontend, its quantization, and the whole comparison of a run; the
control one precision below; and a run whose timed path serves altered
tokens, which the comparison has to find."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.families.whisper import reference as R
from benchmark.families.whisper import system
from benchmark.voiced import pcm16, voiced_like

from .conftest import cpu_run, small_config


def test_frontend_matches_the_port():
    """scipy's resample_poly and openai-whisper's log-mel against the
    port's conv1d resampler and its plain log-mel: the resamplers' filters
    differ in their normalisation (5e-4 of full scale here); the log-mel
    is held to 1e-3 of its normalised range."""
    from sentiric_stt_whisper_service_tpu_torch.audio import resample
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel

    pcm = pcm16(voiced_like(np.random.default_rng(1), 4.0, 8000))
    ours = R.window_audio(pcm, 8000, 0)
    theirs = resample(torch.from_numpy(pcm.astype(np.float32) / 32768.0), 8000, 16000).numpy()
    assert np.abs(ours[:theirs.size] - theirs).max() < 2e-3
    want = compute_log_mel(torch.from_numpy(ours)[None], n_mels=128)[0]
    assert (R.log_mel(torch.from_numpy(ours), 128) - want).abs().max() < 1e-3


def test_weight_quantization_matches_the_port():
    """Per-output-channel int8 (and per-row embedding) values as the
    port's ``ops/quant.quantize_weight`` gives them, bit for bit."""
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import quantize_weight

    w = torch.randn(96, 64, generator=torch.Generator().manual_seed(0)).bfloat16()  # HF [out, in]
    q, scale = quantize_weight(w.T, axis=-2)
    assert torch.equal(R.quantize_rows(w, 127), (q.float() * scale).T)
    emb_q, emb_s = quantize_weight(w, axis=-1)
    assert torch.equal(R.quantize_rows(w, 127), emb_q.float() * emb_s[:, None])


def test_cross_kv_quantization_matches_the_port():
    """The int4 carrier's values and the int8 container's, per position."""
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import (
        _quantize_kv,
        unpack_nibbles_i8,
    )

    x = torch.randn(3, 64, 20, generator=torch.Generator().manual_seed(1))  # [H, hd, T]
    for bits in (4, 8):
        q, scale = _quantize_kv(x, bits)
        vals = unpack_nibbles_i8(q) if bits == 4 else q
        assert torch.equal(R.quantize_positions(x, bits), vals.float() * scale[:, None, :])


def test_vocab_matches_the_port():
    from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

    for n in (51865, 51866):
        tok, v = fallback_tokenizer(n), R.Vocab(n)
        sp = tok.special
        assert (v.eot, v.sot, v.transcribe, v.timestamp_begin) == (
            sp.eot, sp.sot, sp.transcribe, sp.timestamp_begin)
        assert v.prompt(9) == tok.sot_sequence("tr")
        assert v.non_speech() == list(tok.non_speech_tokens)


def test_loader_layout_keeps_the_checkpoint():
    """The loader gets the same model from the benchmark's host layout as
    from plain float32 copies of the tensors."""
    from sentiric_stt_whisper_service_tpu_torch.checkpoint.safetensors_io import (
        params_from_hf_state,
    )

    cfg = small_config()
    flat = system.make_flat(cfg, 7, torch.device("cpu"))
    plain = {k: v.float().numpy() for k, v in system.views(flat, cfg).items()}
    a = params_from_hf_state(system.host_arrays(flat, cfg))[1].state_dict()
    b = params_from_hf_state(plain)[1].state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_a_run_agrees_with_the_reference():
    """At the test size the port's bf16 decode (int8 weights, int4 or int8
    cross K/V, fp8 self cache) lies within 0.05 logits of the reference's
    choice and 0.05 of its log-probabilities (CPU readings: about 0.005
    each), and the run is correct under the cell's limits."""
    res = cpu_run()
    r = res["readings"]
    assert r["windows"] >= 3 and r["tokens"] >= 30
    assert r["token_gap"] < 0.05 and r["logprob_err"] < 0.05
    assert res["correct"] is True


def test_the_control_reads_apart_from_the_program():
    """The control (int4 weights) reads at least three times what the
    program reads on both numbers, at the test size as on the card."""
    r = cpu_run()["readings"]
    assert r["control_token_gap"] > 3 * max(r["token_gap"], 1e-3)
    assert r["control_logprob_err"] > 3 * max(r["logprob_err"], 1e-3)


def _alter(tokens: torch.Tensor, at) -> None:
    """Replace a produced text token by another text token."""
    tokens[at] = (tokens[at] + 977) % 50000


@pytest.mark.parametrize("cell", ["v3-turns-greedy", "v3-turns-beam5"])
def test_an_altered_token_is_not_correct(monkeypatch, cell):
    """The timed path with a fault planted where tokens are produced: the
    third token of every window served (the continuous batcher's slot,
    the engine's own decode, the beam's winner) is replaced before the
    engine reads it. ``correct`` comes out false."""
    from sentiric_stt_whisper_service_tpu_torch.models import beam, sampling
    from sentiric_stt_whisper_service_tpu_torch.runtime.batcher import ContinuousBatcher

    harvest, result = ContinuousBatcher._harvest, sampling._decode_result

    def bad_harvest(self, slot, end):
        _alter(self.state.tokens, (slot, len(self._slot_req[slot].init_tokens) + 2))
        return harvest(self, slot, end)

    def bad_result(state, no_speech_probs, sample_begin, ids):
        _alter(state.tokens, (slice(None), sample_begin + 2))
        return result(state, no_speech_probs, sample_begin, ids)

    beam_result = beam._beam_result

    def bad_beam(state, no_speech_probs, sample_begin, K):
        res = beam_result(state, no_speech_probs, sample_begin, K)
        _alter(res.tokens, (slice(None), sample_begin + 2))
        return res

    monkeypatch.setattr(ContinuousBatcher, "_harvest", bad_harvest)
    monkeypatch.setattr(sampling, "_decode_result", bad_result)
    monkeypatch.setattr(beam, "_beam_result", bad_beam)
    res = cpu_run(cell, seed=2**31 + 99, control=False)
    assert res["correct"] is False
    assert res["compared"]["logprob_err"]["value"] > res["compared"]["logprob_err"]["limit"]


def test_a_beam_run_agrees_with_the_reference():
    """The beam cell at the test size: correct under its limits, and the
    reference's own beam search with the best candidate of every beam
    dropped serves first choices far less often than the program."""
    res = cpu_run("v3-turns-beam5")
    r = res["readings"]
    assert res["correct"] is True and r["windows"] >= 3
    assert r["beam_not_first"] < res["compared"]["beam_not_first"]["limit"]
    assert r["fault_prune_beam_not_first"] > max(2 * r["beam_not_first"],
                                                 res["compared"]["beam_not_first"]["limit"])


def test_a_beam_search_that_prunes_wrongly_is_not_correct(monkeypatch):
    """The timed path with the beam step's proposals broken: each beam
    proposes its 2nd to (K + 2)-th tokens, never its best, so the gang
    keeps the wrong hypotheses while every token it serves stays legal,
    among the beam's, with its probability right. ``correct`` comes out
    false on ``beam_not_first`` alone."""
    from sentiric_stt_whisper_service_tpu_torch.models import beam

    topk = beam.topk_small

    def without_the_best(logits, k):
        vals, idx = topk(logits, k + 1)
        return vals[..., 1:], idx[..., 1:]

    monkeypatch.setattr(beam, "topk_small", without_the_best)
    res = cpu_run("v3-turns-beam5", seed=2**31 + 101, control=False)
    c = res["compared"]
    assert res["correct"] is False
    assert c["beam_not_first"]["value"] > c["beam_not_first"]["limit"]
    assert c["logprob_err"]["value"] <= c["logprob_err"]["limit"]
