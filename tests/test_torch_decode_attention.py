"""Single-token decode attention (ops/decode_attention, K3/K4's plain
versions on CPU) against the JAX package: the plain, causal and int8 forms
against its Pallas kernel in interpret mode, and the int4 form against
``decode_attention_reference`` on the unpacked slab (the function the JAX
decode path calls); and the kernels' own splits over a cluster emulated in
torch against the same: K3's split of the positions
(csrc/decode_attention.cu) against the Pallas kernel in interpret mode, K4's
split of the carrier's columns (csrc/decode_attention_i4.cu) against the
Pallas int4 kernel in interpret mode.

Tolerance: atol 2e-5 in fp32, as tests/test_decode_attention.py — the same
sums in another order; 2e-2 against the Pallas int4 kernel, which rounds its
query and softmax weights to bf16 (tests/test_beam_attention.py's bf16
tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.ops import quant as ref_quant
from sentiric_stt_whisper_service_tpu.ops.decode_attention import (
    decode_attention as ref_decode,
)
from sentiric_stt_whisper_service_tpu.ops.decode_attention import (
    decode_attention_i4 as ref_decode_i4,
)
from sentiric_stt_whisper_service_tpu.ops.decode_attention import (
    decode_attention_reference as ref_plain,
)
from sentiric_stt_whisper_service_tpu_torch.ops import quant
from sentiric_stt_whisper_service_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_i4,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

S, H, HD, F = 3, 4, 64, 256
SCALE = HD**-0.5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((S, H, HD)).astype(np.float32)
    k = rng.standard_normal((S, H, HD, F)).astype(np.float32)
    v = rng.standard_normal((S, H, HD, F)).astype(np.float32)
    return q, k, v


def t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas(data, causal):
    q, k, v = data
    pos = np.asarray([0, 17, 255], np.int32) if causal else None
    got = decode_attention(t(q), t(k), t(v), pos=None if pos is None else t(pos), scale=SCALE)
    want = ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      pos=None if pos is None else jnp.asarray(pos), scale=SCALE,
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    if causal:  # pos=0 attends only column 0 → output equals v[..., 0]
        np.testing.assert_allclose(got[0].numpy(), v[0, :, :, 0], atol=2e-5)


def test_int8_matches_pallas(data):
    q, k, v = data
    k_q, k_s = ref_quant.quantize_weight(jnp.asarray(k), axis=-2)
    v_q, v_s = ref_quant.quantize_weight(jnp.asarray(v), axis=-2)
    got = decode_attention(t(q), t(k_q), t(v_q), t(k_s), t(v_s), scale=SCALE)
    want = ref_decode(jnp.asarray(q), k_q, v_q, k_s, v_s, scale=SCALE, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_int4_matches_reference_on_unpacked_slab(data):
    q, k, v = data
    packed = ref_quant.quantize_xa_kv({"k": jnp.asarray(k), "v": jnp.asarray(v)}, bits=4)
    got = decode_attention_i4(t(q), t(packed["k_p"]), t(packed["v_p"]),
                              t(packed["k_scale"]), t(packed["v_scale"]), scale=SCALE)
    want = ref_plain(jnp.asarray(q), ref_quant.unpack_nibbles_i8(packed["k_p"]),
                     ref_quant.unpack_nibbles_i8(packed["v_p"]), packed["k_scale"],
                     packed["v_scale"], scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # and the port's own packing gives the same carrier
    mine = quant.quantize_xa_kv({"k": t(k), "v": t(v)}, bits=4)
    np.testing.assert_array_equal(mine["k_p"].numpy(), np.asarray(packed["k_p"]))


LOG2E = 1.4426950408889634


def k4_cluster(q, k_p, v_p, k_scale, v_scale, scale, blocks=8):
    """K4's split of the carrier columns over its cluster and the merge of
    the blocks' softmax partials (csrc/decode_attention_i4.cu), in fp32 on
    the packed carrier [S, H, hd, R], R = F/2: block r of ``blocks`` owns
    carrier columns
    [r per, (r + 1) per), per = ceil(R / blocks), i.e. positions j (low
    nibble) and R + j (high nibble) for those j; it takes its local softmax in
    log2 units (log2(e) folded into the query scale) and its (m, l, o); the
    blocks merge as out = sum_p o_p 2^(m_p - M) / sum_p l_p 2^(m_p - M), a
    block with no columns adding nothing."""
    R = k_p.shape[-1]
    per = -(-R // blocks)
    lo = lambda x: (((x & 15) ^ 8) - 8).float()  # noqa: E731
    hi = lambda x: (x >> 4).float()  # noqa: E731  (arithmetic shift: sign-extended)
    qs = q.float() * (scale * LOG2E)
    parts = []
    for r in range(blocks):
        j0, j1 = min(R, r * per), min(R, r * per + per)
        if j0 == j1:
            continue
        kk = torch.cat([lo(k_p[..., j0:j1]), hi(k_p[..., j0:j1])], dim=-1)
        vv = torch.cat([lo(v_p[..., j0:j1]), hi(v_p[..., j0:j1])], dim=-1)
        ks = torch.cat([k_scale[..., j0:j1], k_scale[..., R + j0:R + j1]], dim=-1)
        vs = torch.cat([v_scale[..., j0:j1], v_scale[..., R + j0:R + j1]], dim=-1)
        s = torch.einsum("shd,shdf->shf", qs, kk) * ks
        m = s.amax(-1)
        e = torch.exp2(s - m[..., None])
        parts.append((m, e.sum(-1), torch.einsum("shf,shdf->shd", e * vs, vv)))
    big = torch.stack([p[0] for p in parts]).amax(0)
    f = [torch.exp2(p[0] - big) for p in parts]
    den = sum(p[1] * fp for p, fp in zip(parts, f))
    num = sum(p[2] * fp[..., None] for p, fp in zip(parts, f))
    return num / den[..., None]


@pytest.mark.parametrize("R", [1, 375, 750])  # F/2: eight blocks divide none of them
def test_k4_cluster_arithmetic_matches_pallas(R):
    rng = np.random.default_rng(R)
    q = rng.standard_normal((S, H, HD)).astype(np.float32)
    k = rng.standard_normal((S, H, HD, 2 * R)).astype(np.float32)
    v = rng.standard_normal((S, H, HD, 2 * R)).astype(np.float32)
    packed = ref_quant.quantize_xa_kv({"k": jnp.asarray(k), "v": jnp.asarray(v)}, bits=4)
    got = k4_cluster(t(q), t(packed["k_p"]), t(packed["v_p"]), t(packed["k_scale"]),
                     t(packed["v_scale"]), SCALE)
    assert got.shape == (S, H, HD)
    unpacked = [ref_quant.unpack_nibbles_i8(packed[n]) for n in ("k_p", "v_p")]
    want = ref_plain(jnp.asarray(q), *unpacked, packed["k_scale"], packed["v_scale"],
                     scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the Pallas kernel takes native int4 and rounds its query and weights to
    # bf16: the JAX package's bf16 tolerance
    native = [ref_quant._unpack_nibbles(packed[n]) for n in ("k_p", "v_p")]
    pallas = ref_decode_i4(jnp.asarray(q, jnp.bfloat16), *native, packed["k_scale"],
                           packed["v_scale"], scale=SCALE, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32), atol=2e-2)


def k3_cluster(q, k, v, k_scale=None, v_scale=None, pos=None, scale=1.0, blocks=8):
    """K3's split of the positions over its cluster and the merge of the
    blocks' softmax partials (csrc/decode_attention.cu), in fp32 on the slab
    [S, H, hd, F]: block r of ``blocks`` owns positions [r per, (r + 1) per),
    per = ceil(F / blocks), and attends those <= pos[s] (all without
    ``pos``); it takes its local softmax in log2 units (log2(e) folded into
    the query scale), k_scale on the scores and v_scale on the weights, and
    its (m, l, o); the blocks merge as in ``k4_cluster``, a block with no
    live position adding nothing. Where pos[s] < 0 every position is live
    with the score 0 (the reference masks all alike and weighs them
    evenly). Returns the output and, per item, the number of blocks with no
    live position."""
    S, H, hd, F = k.shape
    per = -(-F // blocks)
    qs = q.float() * (scale * LOG2E)
    out, idle = torch.empty(S, H, hd), []
    for s in range(S):
        limit = F - 1 if pos is None else int(pos[s])
        even = limit < 0
        limit = F - 1 if even else limit
        parts = []
        for r in range(blocks):
            f0, f1 = min(F, r * per), min(F, r * per + per, limit + 1)
            if f1 <= f0:
                continue
            sc = torch.einsum("hd,hdf->hf", qs[s], k[s, ..., f0:f1].float())
            if even:
                sc = torch.zeros_like(sc)
            elif k_scale is not None:
                sc = sc * k_scale[s, :, f0:f1]
            m = sc.amax(-1)
            e = torch.exp2(sc - m[:, None])
            w = e * v_scale[s, :, f0:f1] if v_scale is not None else e
            parts.append((m, e.sum(-1), torch.einsum("hf,hdf->hd", w, v[s, ..., f0:f1].float())))
        big = torch.stack([p[0] for p in parts]).amax(0)
        f = [torch.exp2(p[0] - big) for p in parts]
        den = sum(p[1] * fp for p, fp in zip(parts, f))
        out[s] = sum(p[2] * fp[:, None] for p, fp in zip(parts, f)) / den[:, None]
        idle.append(blocks - len(parts))
    return out, idle


# F = 1 and 7: blocks with no positions at all; 61 and 1500: eight blocks
# divide neither (the last block holds 5 and 184 positions). The causal
# bounds: position 0 only (every block but the first idle), the last
# position of block 1, the first of block 2, and none (pos = -1: the
# reference weighs every position evenly).
@pytest.mark.parametrize("F", [1, 7, 61, 1500])
@pytest.mark.parametrize("form", ["bf16", "causal", "int8"])
def test_k3_cluster_arithmetic_matches_pallas(F, form):
    rng = np.random.default_rng(F)
    S = 4
    q = rng.standard_normal((S, H, HD)).astype(np.float32)
    k = rng.standard_normal((S, H, HD, F)).astype(np.float32)
    v = rng.standard_normal((S, H, HD, F)).astype(np.float32)
    per = -(-F // 8)
    pos = np.minimum(F - 1, [0, 2 * per - 1, 2 * per, -1]).astype(np.int32)
    scales, jpos, tpos = (), None, None
    if form == "int8":
        (k, k_s), (v, v_s) = (ref_quant.quantize_weight(jnp.asarray(x), axis=-2) for x in (k, v))
        scales = (k_s, v_s)
    elif form == "causal":
        jpos, tpos = jnp.asarray(pos), t(pos)
    got, idle = k3_cluster(t(q), t(k), t(v), *map(t, scales), pos=tpos, scale=SCALE)
    if form == "causal":
        assert idle == ([7] * 4 if F == 1 else [7, 6, 5, 8 - -(-F // per)])
    want = ref_plain(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *scales, pos=jpos,
                     scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    pallas = ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *scales, pos=jpos,
                        scale=SCALE, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5)
