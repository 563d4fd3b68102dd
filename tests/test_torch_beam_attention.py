"""Beam-search attention (ops/beam_attention: K5's and K6's plain versions on
CPU) against the JAX package: its Pallas ``beam_attention`` and
``beam_cross_attention`` in interpret mode, as tests/test_beam_attention.py
runs them, its ``beam_attention_reference``, and ``models/whisper._attend_xa``
(the function its beam step calls for the cross read) on the packed int4
carrier; and K5's and K6's own cluster arithmetic (csrc/beam_attention.cu,
csrc/beam_cross_attention.cu) emulated in torch against the same.

Tolerances: atol 2e-5 where both sides compute in fp32, as
tests/test_torch_decode_attention.py (the same sums in another order). The
Pallas kernels round their matrix-unit operands to bf16 for bf16 inputs and
for int8 slabs (queries and softmax weights), so against those the JAX
package's own bf16 tolerance applies (2e-2, tests/test_beam_attention.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models.whisper import _attend_xa as ref_attend_xa
from sentiric_stt_whisper_service_tpu.ops import quant as ref_quant
from sentiric_stt_whisper_service_tpu.ops.beam_attention import (
    beam_attention as ref_beam,
)
from sentiric_stt_whisper_service_tpu.ops.beam_attention import (
    beam_attention_reference as ref_beam_plain,
)
from sentiric_stt_whisper_service_tpu.ops.beam_attention import (
    beam_cross_attention as ref_cross,
)
from sentiric_stt_whisper_service_tpu_torch.ops.beam_attention import (
    GROUP_BEAMS,
    MAX_BEAMS,
    beam_attention,
    beam_attention_groups,
    beam_cross_attention,
    beam_cross_attention_i4,
    beam_groups,
)
from sentiric_stt_whisper_service_tpu_torch.ops.quant import unpack_nibbles_i8
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

B, K, H, HD, C, F = 2, 3, 4, 64, 128, 256
SCALE = HD**-0.5
FP32, BF16 = 2e-5, 2e-2


def t(a):
    return torch.tensor(np.asarray(a))


def to_dtype(x, name):
    return x if name == "fp32" else x.to(torch.bfloat16)


def self_case(seed, C=C, pos=C - 5):
    """Slot caches and a valid ancestry: one source slot per (item, beam,
    position) before ``pos``, none after."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B * K, H, HD)).astype(np.float32)
    k = (rng.standard_normal((B * K, H, C, HD)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B * K, H, C, HD)) * 0.3).astype(np.float32)
    src = rng.integers(0, K, size=(B, K, C))
    anc = np.zeros((B, K, K, C), bool)
    b, kd, c = np.meshgrid(np.arange(B), np.arange(K), np.arange(C), indexing="ij")
    anc[b, kd, src, c] = True
    anc[:, :, :, pos:] = False
    return q, k, v, anc


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_self_plain_matches_pallas(dtype):
    q, k, v, anc = self_case(0)
    qt, kt, vt = (to_dtype(torch.from_numpy(x), dtype) for x in (q, k, v))
    got = beam_attention(qt, kt, vt, torch.from_numpy(anc), K, scale=SCALE)
    assert got.dtype == qt.dtype and got.shape == (B * K, H, HD)
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = ref_beam(jq, jk, jv, jnp.asarray(anc), beam_size=K, scale=SCALE, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=FP32 if dtype == "fp32" else BF16)
    # the JAX package's plain version computes as this one does (fp32, one
    # rounding to the output dtype)
    plain = ref_beam_plain(jq, jk, jv, jnp.asarray(anc), K, scale=SCALE)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(plain, np.float32),
                               atol=FP32, rtol=0 if dtype == "fp32" else 2**-8)


def test_self_int8_with_scales():
    q, k, v, anc = self_case(1)
    k_q, k_s = ref_quant.quantize_weight(jnp.asarray(k), axis=-1)  # per row
    v_q, v_s = ref_quant.quantize_weight(jnp.asarray(v), axis=-1)
    got = beam_attention(torch.from_numpy(q), t(k_q), t(v_q), torch.from_numpy(anc), K,
                         scale=SCALE, k_scale=t(k_s), v_scale=t(v_s))
    # exact per-row dequantization: the plain version on the dequantized slab
    deq = ref_beam_plain(jnp.asarray(q), k_q.astype(jnp.float32) * k_s[..., None],
                         v_q.astype(jnp.float32) * v_s[..., None], jnp.asarray(anc), K,
                         scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(deq), atol=FP32)
    pallas = ref_beam(jnp.asarray(q), k_q, v_q, jnp.asarray(anc), beam_size=K, scale=SCALE,
                      interpret=True, k_scale=k_s, v_scale=v_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=BF16)


def test_ancestry_selects_the_right_slot():
    """Distinct constant values per slot: each beam's output is the value of
    the one slot its ancestry points at."""
    k_, C_ = 2, 8
    q = torch.ones(k_, 1, HD)
    k = torch.zeros(k_, 1, C_, HD)
    v = torch.stack([torch.full((1, C_, HD), float(s + 1)) for s in range(k_)])
    anc = torch.zeros(1, k_, k_, C_, dtype=torch.bool)
    anc[0, 0, 1, :4] = True  # beam 0 reads slot 1, beam 1 reads slot 0
    anc[0, 1, 0, :4] = True
    out = beam_attention(q, k, v, anc, k_, scale=1.0)
    np.testing.assert_allclose(out[0].numpy(), 2.0, atol=1e-6)
    np.testing.assert_allclose(out[1].numpy(), 1.0, atol=1e-6)


def test_c_valid_reads_equal_full_reads():
    q, k, v, anc = self_case(7, C=256, pos=100)
    args = [torch.from_numpy(x) for x in (q, k, v, anc)]
    full = beam_attention(*args, K, scale=SCALE)
    for c_valid in (101, 128, 200):
        cut = beam_attention(*args, K, scale=SCALE, c_valid=c_valid)
        np.testing.assert_allclose(cut.numpy(), full.numpy(), atol=1e-6)
    pallas = ref_beam(*(jnp.asarray(x) for x in (q, k, v, anc)), beam_size=K, scale=SCALE,
                      c_valid=128, interpret=True)
    np.testing.assert_allclose(full.numpy(), np.asarray(pallas), atol=FP32)


def cross_case(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, K, HD)).astype(np.float32)
    k = rng.standard_normal((B, H, HD, F)).astype(np.float32)
    v = rng.standard_normal((B, H, HD, F)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_plain_matches_pallas(dtype):
    q, k, v = cross_case(2)
    qt, kt, vt = (to_dtype(torch.from_numpy(x), dtype) for x in (q, k, v))
    got = beam_cross_attention(qt, kt, vt, scale=SCALE)
    assert got.dtype == qt.dtype and got.shape == (B, H, K, HD)
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    want = ref_cross(*(jnp.asarray(x, jd) for x in (q, k, v)), scale=SCALE, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=FP32 if dtype == "fp32" else BF16)


def test_cross_int8_matches_attend_xa_and_pallas():
    q, k, v = cross_case(3)
    k_q, k_s = ref_quant.quantize_weight(jnp.asarray(k), axis=-2)  # per position
    v_q, v_s = ref_quant.quantize_weight(jnp.asarray(v), axis=-2)
    got = beam_cross_attention(torch.from_numpy(q), t(k_q), t(v_q), t(k_s), t(v_s),
                               scale=SCALE)
    want, _ = ref_attend_xa(jnp.asarray(q), {"k_q": k_q, "v_q": v_q, "k_scale": k_s,
                                             "v_scale": v_s}, HD**-0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32)
    pallas = ref_cross(jnp.asarray(q), k_q, v_q, k_s, v_s, scale=SCALE, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=BF16)


def test_cross_int4_carrier_matches_attend_xa():
    q, k, v = cross_case(4)
    packed = ref_quant.quantize_xa_kv({"k": jnp.asarray(k), "v": jnp.asarray(v)}, bits=4)
    got = beam_cross_attention_i4(torch.from_numpy(q), t(packed["k_p"]), t(packed["v_p"]),
                                  t(packed["k_scale"]), t(packed["v_scale"]), scale=SCALE)
    want, _ = ref_attend_xa(jnp.asarray(q), packed, HD**-0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32)


LOG2E = 1.4426950408889634


def k6_cluster(q, k, v, k_scale, v_scale, scale, blocks=4):
    """K6's arithmetic in fp32 on an int8 slab, or on the packed int4
    carrier (``k.shape[-1]`` = F/2, unpacked as the kernel does: byte j's low
    nibble is position j, its sign-extended high nibble position j + F/2).
    Block r of ``blocks`` owns a quarter of d and a quarter of the positions:
    the partial scores over the d quarters are summed in a fixed order and
    scaled by scale × k_scale; each position quarter takes its row max (log2
    units) and its sum of exponentials, which the blocks merge into weights
    (v_scale folded in); each block's output rows come from its own V rows."""
    F = k_scale.shape[-1]
    if k.shape[-1] != F:
        k, v = (torch.cat([((x & 15) ^ 8) - 8, x >> 4], dim=-1) for x in (k, v))
    q, k, v = q.float(), k.float(), v.float()
    dq, per = q.shape[-1] // blocks, -(-F // (4 * blocks)) * 4  # quarters of whole float4s
    d_quarters = [slice(r * dq, (r + 1) * dq) for r in range(blocks)]
    s = sum(q[..., d] @ k[:, :, d] for d in d_quarters)  # left to right, as the kernel
    s = s * (k_scale * scale)[:, :, None]
    mb = [s[..., f:f + per].amax(-1, keepdim=True) * LOG2E for f in range(0, F, per)]
    e = [torch.exp2(s[..., f:f + per] * LOG2E - m) for f, m in zip(range(0, F, per), mb)]
    big = torch.stack(mb).amax(0)
    z = sum(x.sum(-1, keepdim=True) * torch.exp2(m - big) for x, m in zip(e, mb))
    w = torch.cat([x * (torch.exp2(m - big) / z) for x, m in zip(e, mb)], dim=-1)
    w = w * v_scale[:, :, None]
    return torch.cat([w @ v[:, :, d].transpose(-1, -2) for d in d_quarters], dim=-1)


@pytest.mark.parametrize("form", ["int8", "int4"])
@pytest.mark.parametrize("F_", [1500, 22])  # F/2 = 750 and 11: both odd
def test_k6_cluster_arithmetic_matches_pallas(form, F_):
    rng = np.random.default_rng(F_)
    K_ = 5
    q = rng.standard_normal((B, H, K_, HD)).astype(np.float32)
    k = rng.standard_normal((B, H, HD, F_)).astype(np.float32)
    v = rng.standard_normal((B, H, HD, F_)).astype(np.float32)
    if form == "int8":
        k_q, k_s = ref_quant.quantize_weight(jnp.asarray(k), axis=-2)
        v_q, v_s = ref_quant.quantize_weight(jnp.asarray(v), axis=-2)
        slab = {"k_q": k_q, "v_q": v_q, "k_scale": k_s, "v_scale": v_s}
        got = k6_cluster(torch.from_numpy(q), t(k_q), t(v_q), t(k_s), t(v_s), SCALE)
    else:
        slab = ref_quant.quantize_xa_kv({"k": jnp.asarray(k), "v": jnp.asarray(v)}, bits=4)
        got = k6_cluster(torch.from_numpy(q), t(slab["k_p"]), t(slab["v_p"]),
                         t(slab["k_scale"]), t(slab["v_scale"]), SCALE)
        k_q, v_q = (jnp.asarray(unpack_nibbles_i8(t(slab[n])).numpy()) for n in ("k_p", "v_p"))
    assert got.shape == (B, H, K_, HD)
    want, _ = ref_attend_xa(jnp.asarray(q), slab, HD**-0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32)
    pallas = ref_cross(jnp.asarray(q), k_q, v_q, slab["k_scale"], slab["v_scale"], scale=SCALE,
                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=BF16)


NEG = -1e30


def k5_cluster(q, k, v, anc, K_, scale, c_valid=0, k_scale=None, v_scale=None, blocks=4,
               chunk=256, group=None):
    """K5's split of the rows over its cluster and the merge of the blocks'
    softmax partials (csrc/beam_attention.cu), in fp32 (the kernel forms its
    products on the tensor cores; their rounding is what the card tests'
    tolerance covers). A cluster serves ``group`` query beams (default: as
    the wrapper groups them, ``beam_attention_groups``), every slot of the
    item. A beam with no entry below ``c_valid`` is "full": every row counts
    for it, with score 0.
    The live (position, slot) rows (some beam of the group reads them, or
    one of them is full) are numbered position-major; block r of ``blocks`` takes the rows
    numbered [T r / blocks, T (r + 1) / blocks) of T. Each block runs an
    online softmax per destination beam over its rows, ``chunk`` rows at a
    time, in log2 units (log2(e) folded into the query scale), masked
    entries at -1e30; the blocks' (m, l, o) merge as
    out = sum_p o_p 2^(m_p - M) / sum_p l_p 2^(m_p - M)."""
    BK, H_, C_, hd = k.shape
    B_ = BK // K_
    cv = c_valid if 0 < c_valid < C_ else C_
    group = group or beam_attention_groups(K_, C_, cv, 1 if k.dtype == torch.int8 else 2)[0]
    qs = q.float() * (scale * LOG2E)
    k, v = k.float(), v.float()
    out = torch.empty(BK, H_, hd)
    for b, k0 in itertools.product(range(B_), range(0, K_, group)):
        kn = min(group, K_ - k0)
        a = anc[b, k0:k0 + kn, :, :cv]  # [Kd of the group, Ks, cv]
        full = ~a.reshape(kn, -1).any(-1)
        c_all, s_all = (x.reshape(-1) for x in torch.meshgrid(
            torch.arange(cv), torch.arange(K_), indexing="ij"))  # position-major
        live = full.any() | a[:, s_all, c_all].any(0)
        c_all, s_all = c_all[live], s_all[live]
        T = len(c_all)
        for h in range(H_):
            parts = []
            for r in range(blocks):
                lo, hi = T * r // blocks, T * (r + 1) // blocks
                s_i, c_i = s_all[lo:hi], c_all[lo:hi]
                m = torch.full((kn,), NEG)
                l_ = torch.zeros(kn)
                o = torch.zeros(kn, hd)
                for i0 in range(0, len(s_i), chunk):
                    s_c, c_c = s_i[i0:i0 + chunk], c_i[i0:i0 + chunk]
                    rows = b * K_ + s_c
                    sc = qs[b * K_ + k0:b * K_ + k0 + kn, h] @ k[rows, h, c_c].T  # [Kd, rows]
                    if k_scale is not None:
                        sc = sc * k_scale[rows, h, c_c]
                    sc = torch.where(a[:, s_c, c_c], sc, torch.tensor(NEG))
                    sc = torch.where(full[:, None], torch.tensor(0.0), sc)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    e = torch.exp2(sc - m_new[:, None])
                    l_ = l_ * alpha + e.sum(-1)
                    if v_scale is not None:
                        e = e * v_scale[rows, h, c_c]
                    o = o * alpha[:, None] + e @ v[rows, h, c_c]
                    m = m_new
                parts.append((m, l_, o))
            big = torch.stack([p[0] for p in parts]).amax(0)
            f = [torch.exp2(p[0] - big) for p in parts]
            den = sum(p[1] * fp for p, fp in zip(parts, f))
            num = sum(p[2] * fp[:, None] for p, fp in zip(parts, f))
            out[b * K_ + k0:b * K_ + k0 + kn, h] = num / den[:, None]
    return out


def k5_case(seed, K_, C_, c_valid):
    """2 items x 2 heads; ancestry live only below a third of the read
    bound, and one beam with no entry at all (the uniform average over every
    row read). At c_valid = 1 the single position has at most K live rows,
    so with K < 4 some blocks of the split hold no live row."""
    rng = np.random.default_rng(seed)
    B_, H_ = 2, 2
    q = rng.standard_normal((B_ * K_, H_, HD)).astype(np.float32)
    k = (rng.standard_normal((B_ * K_, H_, C_, HD)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B_ * K_, H_, C_, HD)) * 0.3).astype(np.float32)
    src = rng.integers(0, K_, size=(B_, K_, C_))
    anc = np.zeros((B_, K_, K_, C_), bool)
    b, kd, c = np.meshgrid(np.arange(B_), np.arange(K_), np.arange(C_), indexing="ij")
    anc[b, kd, src, c] = True
    anc[:, :, :, max(1, c_valid // 3):] = False
    if K_ > 1:
        anc[0, K_ - 1] = False  # beam K-1 of item 0 reads nothing
    else:
        anc[1, 0] = False  # the only beam of item 1 reads nothing
    return q, k, v, anc


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("K_", [1, 2, 5, 8])
@pytest.mark.parametrize("c_valid", [1, 37, 128, 129, 160])
def test_k5_cluster_arithmetic_matches_pallas(form, K_, c_valid):
    _k5_cluster_case(form, K_, c_valid)


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("K_,c_valid", [(9, 129), (16, 37)])
def test_k5_cluster_groups_match_pallas(form, K_, c_valid):
    """Above 8 beams: two clusters per (item, head), each serving a group of
    the query beams over all K slots."""
    _k5_cluster_case(form, K_, c_valid)


def _k5_cluster_case(form, K_, c_valid):
    C_ = 160
    q, k, v, anc = k5_case(K_ * 1000 + c_valid, K_, C_, c_valid)
    if form == "bf16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v))
        got = k5_cluster(*(torch.from_numpy(x) for x in (q, k, v, anc)), K_, SCALE, c_valid)
        # the JAX package's plain version and its Pallas kernel on the rows
        # below c_valid (its kernel takes read bounds in multiples of 128 only)
        cut = [jnp.asarray(x[:, :, :c_valid]) for x in (k, v)]
        plain = ref_beam_plain(jnp.asarray(q), *cut, jnp.asarray(anc[..., :c_valid]), K_,
                               scale=SCALE)
        pallas = ref_beam(jnp.asarray(q, jnp.bfloat16),
                          *(x.astype(jnp.bfloat16) for x in cut),
                          jnp.asarray(anc[..., :c_valid]), beam_size=K_, scale=SCALE,
                          interpret=True)
    else:
        k_q, k_s = ref_quant.quantize_weight(jnp.asarray(k), axis=-1)  # per row
        v_q, v_s = ref_quant.quantize_weight(jnp.asarray(v), axis=-1)
        got = k5_cluster(torch.from_numpy(q), t(k_q), t(v_q), torch.from_numpy(anc), K_,
                         SCALE, c_valid, t(k_s), t(v_s))
        cut = lambda x: x[:, :, :c_valid]  # noqa: E731
        plain = ref_beam_plain(jnp.asarray(q), cut(k_q.astype(jnp.float32) * k_s[..., None]),
                               cut(v_q.astype(jnp.float32) * v_s[..., None]),
                               jnp.asarray(anc[..., :c_valid]), K_, scale=SCALE)
        pallas = ref_beam(jnp.asarray(q), cut(k_q), cut(v_q), jnp.asarray(anc[..., :c_valid]),
                          beam_size=K_, scale=SCALE, interpret=True, k_scale=cut(k_s),
                          v_scale=cut(v_s))
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32), atol=BF16)
    if form == "bf16":  # and the port's plain version, the CPU path of the same wrapper
        mine = beam_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(anc), K_, scale=SCALE, c_valid=c_valid)
        np.testing.assert_allclose(got.numpy(), mine.numpy(), atol=FP32)


@pytest.mark.parametrize("chunk", [1, 7, 40])
def test_k5_chunks_carry_the_online_softmax(chunk):
    """Blocks with more live rows than fit at once stage them in chunks; the
    running (m, l, o) carried across chunks gives the same output."""
    K_, C_, c_valid = 5, 160, 160
    q, k, v, anc = k5_case(chunk, K_, C_, c_valid)
    anc[1] = True  # item 1: every beam reads every row, 200 live rows a block
    args = [torch.from_numpy(x) for x in (q, k, v, anc)]
    got = k5_cluster(*args, K_, SCALE, c_valid, chunk=chunk)
    want = k5_cluster(*args, K_, SCALE, c_valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FP32)
    plain = ref_beam_plain(*(jnp.asarray(x) for x in (q, k, v, anc)), K_, scale=SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=FP32)


@pytest.mark.parametrize("K_", [9, 16])
def test_k5_groups_of_query_beams_change_nothing(K_):
    """Above 8 beams a cluster serves a group of them, numbering only the
    rows its own beams read: each beam's output equals that of one cluster
    serving every beam."""
    q, k, v, anc = k5_case(K_, K_, 160, 160)
    args = [torch.from_numpy(x) for x in (q, k, v, anc)]
    grouped = k5_cluster(*args, K_, SCALE, 160)
    whole = k5_cluster(*args, K_, SCALE, 160, group=K_)
    np.testing.assert_allclose(grouped.numpy(), whole.numpy(), atol=FP32)


@pytest.mark.parametrize("itemsize", [1, 2])
def test_beam_groups_fit_shared_memory(itemsize):
    """Every beam size the kernels take, over the longest self cache (448
    rows, read whole or in a 128-row bucket): K5's group of query beams
    fits its 200 KB of shared memory, K6's is at most 8, and up to 8 beams
    both are one group of all the beams, the launch they had before."""
    for K_, cv in itertools.product(range(1, MAX_BEAMS + 1), (128, 448)):
        kg, smem = beam_attention_groups(K_, 448, cv, itemsize)
        assert kg <= GROUP_BEAMS and smem <= 200 * 1024, (K_, cv, kg, smem)
        assert beam_groups(K_) <= GROUP_BEAMS
        if K_ <= GROUP_BEAMS:
            assert kg == beam_groups(K_) == K_
