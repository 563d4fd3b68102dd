"""The port's engine over a device mesh, against ``tests/test_engine_mesh.py``:
``SttEngine(Settings(mesh_shape=...))``, one process per device over gloo
(``tests/_torch_mesh_worker.py``, task ``engine``; it imports no JAX), rank 0
serving and the other ranks replaying its device operations
(``parallel/replay.py``).

The fp32 ``test-8h`` model (8 heads, so 4 a tp rank) from the JAX package's
weights, the gates relaxed, ``parallel_requests=2`` with the fused idle path
off (greedy windows ride the continuous batcher, beam windows the gang),
32 tokens a window. At the meshes "2x2" (dp x tp, four processes) and
"1x2x2" (tp x sp), one worker launch each runs every case at two forms,
fp32 weights and int4 compute (int8 weights, the int4 cross slab), and rank
0's outputs are held against the port's single-device engine at the same
form and, at fp32, against the JAX engine at the same mesh on the virtual
8-device CPU mesh (``tests/conftest.py``):

  * a greedy request with the language detected and token times: equal
    segments (text, language, times, token pieces and token times),
    probabilities within 1e-4, the language probability within 1e-5;
  * the batcher's raw tokens for one window: equal, log-probabilities
    within 5e-3 (the JAX test's tolerance);
  * two requests at once: each equal to the request alone;
  * the language probabilities alone: the language equal, its probability
    within 1e-5;
  * beam 5 through the gang: equal segments;
  * a streaming session (fp32): partials and finals equal to the same
    stream on the single-device engine;
  * with a speculative draft (the target's weights as a ``test-8h`` model
    of its own, sharded like the target: most proposals kept, some
    corrected): a greedy request equal to the port's single-device engine
    with the same draft and, at fp32 on "2x2", to the JAX engine with it at
    that mesh; ``PerformanceMetrics.spec`` on rank 0 with rounds > 0, and
    every rank's speculative ops running the same rounds, the followers
    with no request's counts; a request aborted at the speculative op's
    poll (once its window is encoded) ends that op on every rank, and the
    request after it is served in step; a streaming session's ticks and
    final decode speculatively, equal to the single-device stream.

Also: every rank's model and draft hold 4 heads; a draft of one head,
which tp = 2 does not divide, is refused on every rank; a follower keeps
no cross K/V after rank 0 closes the channel; on the sp mesh each rank's encoder attention reaches
K2's route with its 750 query rows against all 1500 keys; a tp shard's
cross-attention weights (reduced and stacked), language probabilities and
alignment scores equal the unsharded model's; K2's wrapper with fewer query
rows than keys, forward and gradient, against a numpy and an autograd
reference; ``mha`` routes on the global length; rank 0 raising inside an
op ends every rank within the channel's timeout; and a rank 0 idle past the
channel's timeout keeps its follower (the keep-alive).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.config import Settings as RefSettings
from sentiric_stt_whisper_service_tpu.models import whisper as ref_whisper
from sentiric_stt_whisper_service_tpu.runtime import engine as ref_engine
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import sampling, timestamps, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import (
    FlashAttention,
    attention_reference,
    flash_attention,
)
from sentiric_stt_whisper_service_tpu_torch.parallel.replay import TIMEOUT_S
from sentiric_stt_whisper_service_tpu_torch.runtime import engine
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer
from _torch_mesh_worker import (
    BATCHER_TOKENS,
    DRAFT_SETTINGS,
    ENGINE_FORMS,
    ENGINE_SETTINGS,
    ENGINE_TOKENS,
    IDLE_S,
    IDLE_TIMEOUT_S,
    draft_requests,
    engine_requests,
    finish,
    run,
    segments,
    start,
)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref_whisper.config_for("test-8h", dtype=jnp.float32)
CFG = whisper.config_for("test-8h", dtype=torch.float32)
MESHES = ("2x2", "1x2x2")
CASES = ("segments", "concurrent", "beam", "spec_segments", "spec_metrics", "spec_outcomes",
         "spec_stream")


def path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def speechlike(seconds: float = 2.0, sr: int = 16000) -> np.ndarray:
    """tests/test_engine_mesh.py's clip."""
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    carrier = np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 450 * t)
    envelope = 0.5 * (1 + np.sin(2 * np.pi * 3 * t - np.pi / 2))
    return (0.2 * carrier * envelope + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return ref_whisper.init_params(CFG_R, jax.random.key(0))


@pytest.fixture(scope="module")
def inputs(params):
    tok = fallback_tokenizer(CFG.n_vocab)
    base = {f"p/{path_str(p)}": np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    base.update(cfg=np.array("test-8h"), clip=speechlike(),
                mel=np.random.default_rng(0).standard_normal((1, 200, 80)).astype(np.float32),
                tokens=np.array([list(tok.sot_sequence("en")) + list(range(100, 120))],
                                np.int64))
    return base


def jax_requests(eng, clip) -> dict:
    """``engine_requests``' cases on the JAX engine."""
    opts = ref_engine.RequestOptions
    cap = dict(max_decode_tokens=ENGINE_TOKENS)
    out = {"segments": segments(eng.transcribe(clip, 16000, opts(**cap)))}
    window = np.zeros(30 * 16000, np.float32)
    window[: clip.shape[0]] = clip
    got = eng._get_batcher(None).submit(window, list(eng.tokenizer.sot_sequence("en")), 0,
                                        max_tokens=BATCHER_TOKENS).result(timeout=600)
    out["batcher_tokens"] = np.asarray(got["tokens"])
    out["batcher_lps"] = np.asarray(got["token_logprobs"])
    # Two requests at once equal the request alone (tests/test_engine_mesh.py).
    out["concurrent"] = [segments(eng.transcribe(clip, 16000, opts(language="en", **cap)))] * 2
    lang, prob, _, _ = eng._resolve_language(clip, opts())
    out["lang"], out["lang_prob"] = lang, prob
    out["beam"] = segments(eng.transcribe(clip, 16000, opts(language="en", beam_size=5, **cap)))
    return out


def unpack(raw: dict, form: str) -> dict:
    out = {}
    for key, value in raw.items():
        if key.startswith(form + "/"):
            name = key[len(form) + 1:]
            out[name] = (json.loads(str(value)) if name in CASES + ("stream",)
                         else value.item() if value.ndim == 0 else value)
    return out


@pytest.fixture(scope="module")
def results(params, inputs, tmp_path_factory):
    """Both meshes' workers started together; meanwhile the port's
    single-device engine at each form (with and without the draft) and the
    JAX engine at each mesh (fp32; with the draft at "2x2") run the same
    cases here."""
    launched = {}
    for shape in MESHES:
        tmp = tmp_path_factory.mktemp(f"engine_{shape}")
        launched[shape] = (start("engine", inputs | {"mesh": np.array(shape)}, tmp, world=4),
                           tmp)
    def carry(tree):
        return from_jax_numpy(jax.tree.map(np.asarray, tree), CFG, "cpu")

    try:
        single = {}
        for form, compute in ENGINE_FORMS.items():
            eng = engine.SttEngine(Settings(device="cpu", compute_type=compute,
                                            **ENGINE_SETTINGS), model_name="test-8h",
                                   params=carry(params))
            raw: dict = {}
            engine_requests(eng, inputs, form, raw, stream=form == "fp32")
            eng.shutdown()
            eng = engine.SttEngine(Settings(device="cpu", compute_type=compute,
                                            **DRAFT_SETTINGS), model_name="test-8h",
                                   params=carry(params), draft_params=carry(params))
            draft_requests(eng, inputs, form, raw, stream=form == "fp32")
            eng.shutdown()
            single[form] = unpack(raw, form)
        theirs = {}
        for shape in MESHES:
            eng = ref_engine.SttEngine(RefSettings(**ENGINE_SETTINGS, compute_type="float32",
                                                   mesh_shape=shape),
                                       model_name="test-8h", params=params)
            eng.cfg = CFG_R  # the reference engine takes its dtype from its config
            theirs[shape] = jax_requests(eng, speechlike())
            eng.shutdown()
        # The JAX engine with the draft at "2x2": its own random draft
        # replaced by the test's, sharded as the engine shards it.
        from sentiric_stt_whisper_service_tpu.parallel import shard_params as ref_shard

        eng = ref_engine.SttEngine(RefSettings(**DRAFT_SETTINGS, compute_type="float32",
                                               mesh_shape="2x2"),
                                   model_name="test-8h", params=params, random_init=True)
        eng.cfg, eng.draft_cfg, eng.draft_params = CFG_R, CFG_R, ref_shard(eng.mesh, params)
        theirs["2x2"]["spec_segments"] = segments(eng.transcribe(
            speechlike(), 16000, ref_engine.RequestOptions(language="en",
                                                           max_decode_tokens=ENGINE_TOKENS)))
        eng.shutdown()
    finally:
        outs = {}
        for shape, (procs, tmp) in launched.items():
            logs = finish(procs, timeout=300)
            assert all(p.returncode == 0 for p in procs), "\n---\n".join(x[-3000:] for x in logs)
            outs[shape] = [dict(np.load(tmp / f"out.{rank}.npz")) for rank in range(4)]
    return single, theirs, outs


def assert_same_segments(got, want):
    assert len(got) == len(want) and got, (got, want)
    for g, w in zip(got, want):
        for name in ("text", "language", "t0", "t1", "token_count", "speaker_id"):
            assert g[name] == w[name], name
        assert g["language_probability"] == pytest.approx(w["language_probability"], abs=1e-5)
        assert g["prob"] == pytest.approx(w["prob"], abs=1e-4)
        assert [(t[0], t[2], t[3]) for t in g["tokens"]] == [(t[0], t[2], t[3])
                                                             for t in w["tokens"]]
        np.testing.assert_allclose([t[1] for t in g["tokens"]], [t[1] for t in w["tokens"]],
                                   atol=1e-4)


def references(results, shape, form) -> list:
    single, theirs, _ = results
    return [single[form]] + ([theirs[shape]] if form == "fp32" else [])


def rank0(results, shape, form) -> dict:
    return unpack(results[2][shape][0], form)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_segments_match(results, shape, form):
    got = rank0(results, shape, form)
    for want in references(results, shape, form):
        assert_same_segments(got["segments"], want["segments"])


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_batcher_tokens_match(results, shape, form):
    got = rank0(results, shape, form)
    assert len(got["batcher_tokens"]) > 0
    for want in references(results, shape, form):
        np.testing.assert_array_equal(got["batcher_tokens"], want["batcher_tokens"])
        np.testing.assert_allclose(got["batcher_lps"], want["batcher_lps"], atol=5e-3)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_concurrent_requests_match(results, shape, form):
    got = rank0(results, shape, form)
    for want in references(results, shape, form):
        for mine, theirs in zip(got["concurrent"], want["concurrent"]):
            assert_same_segments(mine, theirs)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_auto_language_matches(results, shape, form):
    got = rank0(results, shape, form)
    for want in references(results, shape, form):
        assert got["lang"] == want["lang"]
        assert got["lang_prob"] == pytest.approx(want["lang_prob"], abs=1e-5)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_beam_through_the_gang_matches(results, shape, form):
    got = rank0(results, shape, form)
    for want in references(results, shape, form):
        assert_same_segments(got["beam"], want["beam"])


@pytest.mark.parametrize("shape", MESHES)
def test_stream_matches_one_device(results, shape):
    got, want = rank0(results, shape, "fp32")["stream"], results[0]["fp32"]["stream"]
    assert any(final for final, *_ in got)
    assert got == want


@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_holds_its_heads_and_followers_keep_nothing(results, shape):
    outs = results[2][shape]
    assert not any(bool(o["imported_jax"]) for o in outs)
    for rank, o in enumerate(outs):
        for form in ENGINE_FORMS:
            assert int(o[f"{form}/heads"]) == CFG.n_text_head // 2
            ops, decisions, _ = o[f"{form}/channel"]
            assert ops > 0 and decisions > 0, (rank, form)
            if rank:
                assert int(o[f"{form}/kept_at_stop"]) == 0, (rank, form)


@pytest.mark.parametrize("shape", MESHES)
def test_encoder_attention_takes_the_k2_route(results, shape):
    """Each rank's encodes reach K2's route (its plain version on the CPU):
    on the sp mesh with its T/sp query rows against all T keys."""
    sp = 2 if shape == "1x2x2" else 1
    for o in results[2][shape]:
        routes = o["routes"]
        assert len(routes) > 0
        assert {tuple(r) for r in routes} == {(CFG.n_audio_ctx // sp, CFG.n_audio_ctx)}


@pytest.mark.parametrize("shape", MESHES)
def test_shard_model_functions_match_unsharded(params, inputs, results, shape):
    """A tp shard's cross-attention weights (reduced: the mean over every
    head; stacked: every head gathered), language probabilities and
    alignment scores equal the unsharded model's."""
    model = from_jax_numpy(jax.tree.map(np.asarray, params), CFG, "cpu")
    sp = fallback_tokenizer(CFG.n_vocab).special
    with torch.inference_mode():
        xa = whisper.precompute_xa_kv(CFG, model, whisper.encoder_apply(
            CFG, model, torch.from_numpy(inputs["mel"])))
        tokens = torch.from_numpy(inputs["tokens"])
        want = {}
        for name, begin in (("reduced", CFG.n_text_layer // 2), ("stacked", None)):
            kv = whisper.init_kv_cache(CFG, 1, 64)
            want[name] = whisper.decoder_apply(CFG, model, tokens, 0, kv, xa,
                                               collect_cross_attn=True,
                                               cross_attn_layer_begin=begin)[2].numpy()
        want["detect"] = sampling.detect_language(CFG, model, xa, sp.sot, sp.language_begin,
                                                  sp.num_languages).numpy()
        want["scores"] = timestamps.alignment_scores(CFG, model, xa, tokens).numpy()
    for o in results[2][shape]:
        for name, w in want.items():
            np.testing.assert_allclose(o[f"shard/{name}"], w, atol=1e-5, err_msg=name)


def test_k2_wrapper_takes_fewer_query_rows_than_keys():
    """``flash_attention`` with q [B, H, Lq, 64] against k, v [B, H, Lk, 64]
    (a rank's rows of an sp mesh) on the CPU against softmax attention in
    numpy, and ``FlashAttention``'s gradient against autograd through
    ``attention_reference``, at Lq = 750, Lk = 1500 and a ragged pair."""
    rng = np.random.default_rng(0)
    for lq, lk in ((750, 1500), (37, 101)):
        q, k, v = (rng.standard_normal((1, 2, n, 64)).astype(np.float32) * 0.3
                   for n in (lq, lk, lk))
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64))
        w = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)
        got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
        assert got.shape == (1, 2, lq, 64)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        leaves = [torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v)]
        ref_leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
        dout = torch.from_numpy(rng.standard_normal((1, 2, lq, 64)))
        FlashAttention.apply(*leaves).backward(dout)
        attention_reference(*ref_leaves).backward(dout)
        for a, b in zip(leaves, ref_leaves):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-10)


def test_mha_routes_on_the_global_length(monkeypatch):
    """K2 takes the encoder's attention where the global length (the keys)
    is at least 512, as the JAX package's ``mha`` tests its global T: on one
    device at 1500 and at the 768 bucket, on a rank of sp = 2 at 750 query
    rows against 1500 keys and at 384 against 768, and not at 384 keys
    (192 query rows under sp = 2). Both routes give the same output."""
    calls = []

    def recording(q, k, v):
        calls.append((q.shape[2], k.shape[2]))
        return flash_attention(q, k, v)

    monkeypatch.setattr(whisper, "flash_attention", recording)
    g = torch.Generator().manual_seed(0)
    d, h = 128, 2
    for lq, lk, routed in ((1500, 1500, True), (750, 1500, True), (768, 768, True),
                           (384, 768, True), (384, 384, False), (192, 384, False)):
        q = torch.randn((1, lq, d), generator=g)
        k, v = (torch.randn((1, lk, d), generator=g) for _ in range(2))
        calls.clear()
        with torch.inference_mode():
            got = whisper.mha(q, k, v, h)
        assert calls == ([(lq, lk)] if routed else []), (lq, lk)
        scale = (d // h) ** -0.25
        heads = [x.reshape(1, x.shape[1], h, d // h).transpose(1, 2) for x in (q, k, v)]
        want = whisper._attend(heads[0] * scale, heads[1] * scale, heads[2])
        np.testing.assert_allclose(got.numpy(), want.transpose(1, 2).reshape(1, lq, d).numpy(),
                                   atol=1e-5)


def test_a_failing_rank_zero_op_ends_every_rank(inputs, tmp_path):
    """Rank 0 raises inside an op while its follower waits on a collective
    that rank 0 never joins: both processes exit, with errors, well within
    the channel's timeout (no hang)."""
    t0 = time.perf_counter()
    procs = start("engine_fault", inputs, tmp_path, world=2)
    logs = finish(procs, timeout=2 * TIMEOUT_S)
    elapsed = time.perf_counter() - t0
    assert [p.returncode != 0 for p in procs] == [True, True], logs
    assert "planted fault on rank 0" in logs[0]
    assert elapsed < TIMEOUT_S / 2, elapsed


def test_an_idle_rank_zero_keeps_its_follower(inputs, tmp_path):
    """Rank 0 idles for more than twice the channel's timeout (set short in
    the workers) before its first request: the keep-alive ops hold the
    follower, which then replays the request, and both exit cleanly."""
    outs = run("engine_idle", inputs, tmp_path, world=2)
    assert IDLE_S > 2 * IDLE_TIMEOUT_S
    assert json.loads(str(outs[0]["segments"]))
    # Each rank counts the keep-alives beside the request's ops.
    assert int(outs[1]["ops"]) == int(outs[0]["ops"]) >= IDLE_S // IDLE_TIMEOUT_S


def test_engine_over_a_mesh_is_refused_without_its_processes():
    """One process cannot hold a mesh of four devices: the mesh raises, as
    the JAX package's ``make_mesh`` does; the engine's ranks come from the
    processes joined by ``parallel.maybe_initialize_distributed``."""
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        engine.SttEngine(Settings(device="cpu", mesh_shape="2x2", **ENGINE_SETTINGS),
                         model_name="test-8h", random_init=True)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_spec_segments_match(results, shape, form):
    """A greedy request through the engine with a draft (served after an
    aborted one) equals the port's single-device engine with the same draft
    and, at fp32 on "2x2", the JAX engine with it at that mesh."""
    got = rank0(results, shape, form)
    wants = [results[0][form]["spec_segments"]]
    if form == "fp32" and shape == "2x2":
        wants.append(results[1][shape]["spec_segments"])
    for want in wants:
        assert_same_segments(got["spec_segments"], want)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_spec_counts_on_rank_zero_and_rounds_on_every_rank(results, shape, form):
    """Rank 0's ``PerformanceMetrics.spec`` shows the speculative route
    (rounds > 0, drafts kept); every rank runs the same rounds in each
    speculative op, and a follower's ops see no request's counts."""
    got = rank0(results, shape, form)
    spec = got["spec_metrics"]
    assert spec["rounds"] > 0 and spec["emitted"] > spec["rounds"] and spec["accepted"] > 0
    outcomes = [unpack(o, form)["spec_outcomes"] for o in results[2][shape]]
    rounds = [[r for r, _ in mine] for mine in outcomes]
    assert all(r == rounds[0] for r in rounds), rounds
    assert rounds[0][-1] > 0
    for follower in outcomes[1:]:
        assert all(request is None for _, request in follower)


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
@pytest.mark.parametrize("shape", MESHES)
def test_spec_abort_ends_the_op_on_every_rank(results, shape, form):
    """Rank 0's abort, first true once the window is encoded, is polled
    inside the speculative op: the request returns no segment and the op
    ends with no round on every rank (-1); the next request's window runs
    its rounds on every rank."""
    assert int(results[2][shape][0][f"{form}/spec_aborted"]) == 0
    for o in results[2][shape]:
        rounds = [r for r, _ in unpack(o, form)["spec_outcomes"]]
        assert rounds[0] == -1 and all(r > 0 for r in rounds[1:]), rounds


@pytest.mark.parametrize("shape", MESHES)
def test_spec_stream_matches_one_device(results, shape):
    """A streaming session on the engine with a draft (fp32, 1 s chunks):
    each tick and the final decode speculatively, one op each on every
    rank, and the events equal the same stream on the single-device engine
    with the draft."""
    got = rank0(results, shape, "fp32")
    assert any(final for final, *_ in got["spec_stream"])
    assert got["spec_stream"] == results[0]["fp32"]["spec_stream"]
    for o in results[2][shape]:
        assert len(unpack(o, "fp32")["spec_outcomes"]) > 2  # the stream's decodes


@pytest.mark.parametrize("shape", MESHES)
def test_draft_is_sharded_and_followers_keep_nothing(results, shape):
    """Every rank's draft holds n_text_head / tp heads; a one-head draft is
    refused on every rank with the target's ``ValueError``; a follower of
    the engine with a draft keeps no cross K/V after rank 0 closes."""
    for rank, o in enumerate(results[2][shape]):
        assert "does not divide the heads" in str(o["draft_refused"]), rank
        for form in ENGINE_FORMS:
            assert int(o[f"{form}/draft_heads"]) == CFG.n_text_head // 2
            if rank:
                assert int(o[f"{form}/draft_kept_at_stop"]) == 0, (rank, form)
