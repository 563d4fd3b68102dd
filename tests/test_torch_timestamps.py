"""Token timestamps (``models/timestamps.py``) and the cross-attention
weights of ``decoder_apply`` against the JAX package, on the fp32 ``test``
config from the same weights and the same cross K/V (the JAX package's,
carried across), for the fp32 slab and the int8 and packed int4 slabs:

  * ``decoder_apply(collect_cross_attn=True)``: the stacked weights
    [L, B, H, T, F] and the reduced head-and-layer mean [B, T, F] above
    ``cross_attn_layer_begin``, atol 1e-6 (softmax weights of fp32 scores
    that agree to ~1e-6; the weights average 1/F), and the logits at 1e-4;
  * ``alignment_scores`` (normalized per token: (w - mean) / std) at 1e-3,
    about 1e-4 of their range;
  * the host DTW (``median_filter``, ``dtw_path``, ``token_boundaries``,
    ``align_bucket``, copies) exactly on the same scores, and
    ``compute_token_times`` end to end: equal boundaries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import timestamps as ref_ts
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.ops import quant as ref_quant
from sentiric_stt_whisper_service_tpu_torch.models import timestamps, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)
T, F = 20, 300


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    params = ref.init_params(CFG_R, jax.random.key(2))
    rng = np.random.default_rng(4)
    mel = jnp.asarray(rng.standard_normal((2, 2 * F, CFG_R.n_mels)).astype(np.float32))
    xa = ref.encode_xa_kv(CFG_R, params, mel)  # [L, 2, H, hd, F]
    tokens = np.concatenate([np.tile([[50258, 50259, 50359]], (2, 1)),
                             rng.integers(0, 50000, (2, T - 3))], axis=1)
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    return params, model, xa, tokens


def slabs(xa, bits):
    if not bits:
        return xa, {k: t(v) for k, v in xa.items()}
    q = ref_quant.quantize_xa_kv(xa, bits)
    return q, {k: t(v) for k, v in q.items()}


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["fp32", "int8", "int4"])
@pytest.mark.parametrize("begin", [None, 1], ids=["stacked", "reduced"])
def test_decoder_apply_cross_weights(setup, bits, begin):
    params, model, xa, tokens = setup
    xa_r, xa_p = slabs(xa, bits)
    logits_r, _, w_r = ref.decoder_apply(
        CFG_R, params, jnp.asarray(tokens, jnp.int32), jnp.int32(0),
        ref.init_kv_cache(CFG_R, 2, 64), xa_r, collect_cross_attn=True,
        cross_attn_layer_begin=begin)
    with torch.inference_mode():
        logits, _, w = whisper.decoder_apply(
            CFG, model, t(tokens), 0, whisper.init_kv_cache(CFG, 2, 64), xa_p,
            collect_cross_attn=True, cross_attn_layer_begin=begin)
    want_shape = (2, T, F) if begin is not None else (CFG.n_text_layer, 2, CFG.n_text_head, T, F)
    assert tuple(w.shape) == want_shape == tuple(w_r.shape)
    assert w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_r), atol=1e-4)


def test_decoder_apply_single_token_collects(setup):
    """T = 1 with collection takes the plain path (the step has no weights)."""
    params, model, xa, tokens = setup
    _, _, w_r = ref.decoder_apply(CFG_R, params, jnp.asarray(tokens[:, :1], jnp.int32),
                                  jnp.int32(0), ref.init_kv_cache(CFG_R, 2, 64), xa,
                                  collect_cross_attn=True, cross_attn_layer_begin=0)
    with torch.inference_mode():
        out = whisper.decoder_apply(CFG, model, t(tokens[:, :1]), 0,
                                    whisper.init_kv_cache(CFG, 2, 64),
                                    {k: t(v) for k, v in xa.items()}, collect_cross_attn=True,
                                    cross_attn_layer_begin=0)
    assert len(out) == 3
    np.testing.assert_allclose(out[2].numpy(), np.asarray(w_r), atol=1e-6)


@pytest.mark.parametrize("bits", [0, 4], ids=["fp32", "int4"])
def test_alignment_scores_and_token_times(setup, bits):
    params, model, xa, tokens = setup
    xa_r, xa_p = slabs(xa, bits)
    want = np.asarray(ref_ts.alignment_scores(CFG_R, params, xa_r, jnp.asarray(tokens,
                                                                                jnp.int32)))
    got = timestamps.alignment_scores(CFG, model, xa_p, t(tokens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    for row in range(2):
        # the host DTW: the same numpy on the same scores
        sc = want[row, 3:]
        np.testing.assert_array_equal(timestamps.token_boundaries(sc, F // 2),
                                      ref_ts.token_boundaries(sc, F // 2))
        np.testing.assert_array_equal(timestamps.median_filter(sc, 7),
                                      ref_ts.median_filter(sc, 7))
        for a, b in zip(timestamps.dtw_path(-sc), ref_ts.dtw_path(-sc)):
            np.testing.assert_array_equal(a, b)
        one = {k: v[:, row : row + 1] for k, v in xa_p.items()}
        one_r = {k: v[:, row : row + 1] for k, v in xa_r.items()}
        np.testing.assert_array_equal(
            timestamps.compute_token_times(CFG, model, one, tokens[row], 3, F // 2),
            ref_ts.compute_token_times(CFG_R, params, one_r, tokens[row], 3, F // 2))
    for n in (1, 64, 65, 200, 448, 449, 500):
        assert timestamps.align_bucket(n) == ref_ts.align_bucket(n)
