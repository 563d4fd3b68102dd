"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``,
``test_torch_training.py``, ``test_torch_multihost.py``,
``test_torch_engine_mesh.py``), joined over gloo.

It imports numpy, torch and the port, never JAX: the test that starts it
writes its inputs (the JAX package's weights as numpy, the batch) to an
``.npz`` and reads its outputs from another, ``<out>.<rank>.npz``.

    python tests/_torch_mesh_worker.py TASK INPUTS.npz OUT RANK WORLD INIT_FILE
    python tests/_torch_mesh_worker.py multihost INPUTS.npz OUT

``multihost`` takes its rank and world from the service's env surface
(``STT_WHISPER_SERVICE_COORDINATOR_ADDRESS``, ``..._NUM_PROCESSES``,
``..._PROCESS_ID``) through ``parallel.maybe_initialize_distributed``.
The tests start the workers with ``run`` (``start`` when a worker is meant
to fail).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sentiric_stt_whisper_service_tpu_torch import parallel  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.config import Settings  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.models import sampling, whisper  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.ops.quant import quantize_params  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.runtime import engine as engine_mod  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.runtime import training  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer  # noqa: E402

ENCODER_MESHES = ("2x2", "1x4", "1x1x4")
TRAINING_MESHES = ("2x2", "1x2x2")
# The engine over a mesh: the gates relaxed (random weights keep their
# segments), two requests at a time (greedy windows ride the batcher, beam
# windows the gang), the fused idle path off (as tests/test_engine_mesh.py).
ENGINE_SETTINGS = dict(enable_vad=False, parallel_requests=2, fused_idle_fastpath=False,
                       beam_size=1, best_of=1, quality_gate="off", logprob_threshold=-1e9,
                       no_speech_threshold=1.0, min_segment_avg_prob=0.0)
ENGINE_FORMS = {"fp32": "float32", "int4": "int4"}
ENGINE_TOKENS = 32  # RequestOptions.max_decode_tokens of every request
BATCHER_TOKENS = 24
# The engine with a speculative draft (the target's own weights, a model of
# its own: most proposals kept, some corrected): a lone greedy request takes
# the speculative route (the batcher idle).
DRAFT_SETTINGS = dict(ENGINE_SETTINGS, draft_model="test-8h", spec_gamma=3)


def tree_of(inp) -> dict:
    """The ``p/<path>`` arrays of the inputs → the JAX package's nested
    parameter tree."""
    tree: dict = {}
    for key in inp.files:
        if key.startswith("p/"):
            *parents, leaf = key[2:].split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = inp[key]
    return tree


def model_of(inp, cfg, int8: bool = False):
    model = from_jax_numpy(tree_of(inp), cfg, "cpu")
    return quantize_params(model) if int8 else model


def coords(mesh) -> np.ndarray:
    return np.array([mesh.index(a) for a in ("dp", "tp", "sp")])


def greedy(cfg, model, mesh, inp, int8: bool):
    """decode_window over this rank's dp rows (the JAX test's prompt and
    budget): tokens, lengths and avg log-probabilities."""
    ids = sampling.TokenIds.from_tokenizer(fallback_tokenizer(cfg.n_vocab))
    sup = torch.from_numpy(sampling.build_suppress_mask(cfg.n_vocab, ids, ()))
    rows = parallel.data_sharding(mesh, 3)
    with torch.inference_mode():
        mel = parallel.make_global_array(inp["mel"], rows)
        xa = whisper.precompute_xa_kv(cfg, model, whisper.encoder_apply(cfg, model, mel),
                                      bits=8 if int8 else 0)
        tinit = parallel.make_global_array(inp["tinit"].astype(np.int64),
                                           parallel.data_sharding(mesh, 2))
        sb = int(inp["sample_begin"])
        res = sampling.decode_window(cfg, model, xa, tinit, sb, 0, ids, sup, 0.0,
                                     max_len=int(inp["max_len"]))
    return res


def task_parallel(inp, cfg, out: dict) -> None:
    full = model_of(inp, cfg)
    with torch.inference_mode():
        mel_all = torch.from_numpy(inp["mel"])
        xa_all = whisper.precompute_xa_kv(cfg, full, whisper.encoder_apply(cfg, full, mel_all))
    for shape in ENCODER_MESHES:
        mesh = parallel.make_mesh(shape, device="cpu")
        model = parallel.shard_params(mesh, full)
        with torch.inference_mode():
            mel = parallel.make_global_array(inp["mel"], parallel.data_sharding(mesh, 3))
            enc = whisper.encoder_apply(cfg, model, mel)
            xa = whisper.precompute_xa_kv(cfg, model, enc)
        want = parallel.xa_kv_shardings(mesh, xa_all)
        out[f"enc/{shape}"] = enc.numpy()
        out[f"coords/{shape}"] = coords(mesh)
        out[f"xa_err/{shape}"] = max(
            float((xa[k] - want[k].local(xa_all[k])).abs().max()) for k in xa)
    mesh = parallel.make_mesh("2x2", device="cpu")
    out["coords/decode"] = coords(mesh)
    for form in ("float", "int8"):
        model = parallel.shard_params(mesh, model_of(inp, cfg, int8=form == "int8"))
        res = greedy(cfg, model, mesh, inp, int8=form == "int8")
        out[f"tokens/{form}"] = res.tokens.numpy()
        out[f"lengths/{form}"] = res.lengths.numpy()
        out[f"avg_logprobs/{form}"] = res.avg_logprobs.numpy()


def task_training(inp, cfg, out: dict) -> None:
    """Each mesh's shard made trainable (``training_copy`` of a shard keeps
    its groups), its loss and gradient shards."""
    full = model_of(inp, cfg)
    for shape in TRAINING_MESHES:
        mesh = parallel.make_mesh(shape, device="cpu")
        model = training.training_copy(parallel.shard_params(mesh, full))
        rows2, rows3 = parallel.data_sharding(mesh, 2), parallel.data_sharding(mesh, 3)
        loss, grads = training.loss_and_grads(
            cfg, model, parallel.make_global_array(inp["mel"], rows3),
            parallel.make_global_array(inp["tokens"].astype(np.int64), rows2),
            parallel.make_global_array(inp["loss_mask"], rows2))
        out[f"loss/{shape}"] = loss.numpy()
        out[f"coords/{shape}"] = coords(mesh)
        for name, g in grads.items():
            out[f"grad/{shape}/{name}"] = g.numpy()


def task_multihost(inp, cfg, out: dict) -> None:
    """Two processes joined through the env surface, mesh "2x1": each
    decodes its dp rows; the tokens are gathered as the JAX worker's
    ``process_allgather`` gathers them."""
    mesh = parallel.make_mesh("2x1", device="cpu")
    res = greedy(cfg, parallel.shard_params(mesh, model_of(inp, cfg)), mesh, inp, int8=False)
    for name in ("tokens", "lengths", "avg_logprobs"):
        mine = getattr(res, name).contiguous()
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        out[name] = torch.cat(parts).numpy()


def segments(results) -> list:
    """An engine's ``TranscriptionResult``s as plain values (JSON)."""
    return [dict(text=r.text, language=r.language, language_probability=r.language_probability,
                 prob=r.prob, t0=r.t0, t1=r.t1, token_count=r.token_count,
                 speaker_id=r.speaker_id,
                 tokens=[(t.text, t.p, t.t0, t.t1) for t in r.tokens]) for r in results]


def clip_of(inp) -> np.ndarray:
    return np.asarray(inp["clip"], np.float32)


def engine_requests(eng, inp, prefix: str, out: dict, stream: bool = False) -> None:
    """Rank 0's requests through an engine over the mesh (the cases of
    tests/test_engine_mesh.py): a greedy request with the language detected
    and token times, the batcher's raw tokens for one window, two requests
    at once, the language probabilities alone, beam 5 through the gang, and
    with ``stream`` a ``StreamingSession`` fed the clip in 200 ms chunks
    (its partials' and finals' texts)."""
    clip = clip_of(inp)
    opts = engine_mod.RequestOptions
    cap = dict(max_decode_tokens=ENGINE_TOKENS)
    out[f"{prefix}/segments"] = np.array(json.dumps(segments(
        eng.transcribe(clip, 16000, opts(**cap)))))
    window = np.zeros(30 * 16000, np.float32)
    window[: clip.shape[0]] = clip
    sot = list(eng.tokenizer.sot_sequence("en"))
    got = eng._get_batcher(None).submit(window, sot, 0, max_tokens=BATCHER_TOKENS).result(
        timeout=120)
    out[f"{prefix}/batcher_tokens"] = np.asarray(got["tokens"])
    out[f"{prefix}/batcher_lps"] = np.asarray(got["token_logprobs"])
    del got
    both, errors = [None, None], []

    def go(i):
        try:
            both[i] = segments(eng.transcribe(clip, 16000, opts(language="en", **cap)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    out[f"{prefix}/concurrent"] = np.array(json.dumps(both))
    lang, prob, _, _ = eng._resolve_language(clip, opts())
    out[f"{prefix}/lang"] = np.array(lang)
    out[f"{prefix}/lang_prob"] = np.array(prob)
    out[f"{prefix}/beam"] = np.array(json.dumps(segments(
        eng.transcribe(clip, 16000, opts(language="en", beam_size=5, **cap)))))
    if stream:
        out[f"{prefix}/stream"] = np.array(json.dumps(
            stream_events(eng, clip, opts(language="en", **cap), 6400)))


def stream_events(eng, clip, options, chunk: int) -> list:
    """A ``StreamingSession`` fed the clip as PCM16 in ``chunk``-byte wire
    chunks, then EOS: its events (final, text, t0, t1)."""
    from sentiric_stt_whisper_service_tpu_torch.runtime.streaming import StreamingSession

    raw = (clip * 32767).astype("<i2").tobytes()
    session = StreamingSession(eng, options)
    events = []
    for i in range(0, len(raw), chunk):
        events += session.feed(raw[i:i + chunk])
    events += session.feed(b"")
    return [(e.is_final, e.result.text, e.result.t0, e.result.t1) for e in events]


def draft_requests(eng, inp, prefix: str, out: dict, stream: bool = False) -> None:
    """Rank 0's requests through an engine with a draft: a greedy request
    aborted once its window is encoded (the abort fires at the speculative
    op's poll, inside the op on every rank), then the request served (the
    speculative route), which the followers must replay in step, with its
    ``PerformanceMetrics.spec``; with ``stream`` a ``StreamingSession`` fed
    the clip in 1 s chunks (its ticks decode speculatively)."""
    clip = clip_of(inp)
    opts = engine_mod.RequestOptions
    cap = dict(language="en", max_decode_tokens=ENGINE_TOKENS)
    encoded, decode_spec = threading.Event(), eng._decode_spec

    def entered(*a, **kw):
        encoded.set()
        return decode_spec(*a, **kw)

    eng._decode_spec = entered
    try:
        aborted = eng.transcribe(clip, 16000, opts(should_abort=encoded.is_set, **cap))
    finally:
        del eng._decode_spec
    out[f"{prefix}/spec_aborted"] = np.array(len(aborted))
    metrics = engine_mod.PerformanceMetrics()
    out[f"{prefix}/spec_segments"] = np.array(json.dumps(segments(
        eng.transcribe(clip, 16000, opts(**cap), metrics))))
    out[f"{prefix}/spec_metrics"] = np.array(json.dumps(metrics.spec))
    if stream:
        out[f"{prefix}/spec_stream"] = np.array(json.dumps(
            stream_events(eng, clip, opts(**cap), 32000)))



def spec_outcomes(eng) -> list:
    """Wrap the engine's speculative op: the list it returns gets, per op
    this rank runs, the window's rounds (-1 where it aborted) and the
    speculative counts of a request on this rank's thread (None on a
    follower, which serves no request)."""
    outcomes, op = [], eng._replay._ops["decode_spec"]

    def counted(*args, own=None):
        got = op(*args, own=own)
        request = getattr(eng._request, "spec", None)
        outcomes.append([-1 if got is None else got[1].rounds,
                         None if request is None else dict(request)])
        return got

    eng._replay.register("decode_spec", counted)
    return outcomes


def shard_checks(inp, cfg, mesh, out: dict) -> None:
    """The model functions that read a shard's head count, on every rank in
    step: the cross-attention weights of a teacher-forced pass in the
    reduced and the stacked form, language detection and the alignment
    scores."""
    model = parallel.shard_params(mesh, model_of(inp, cfg))
    with torch.inference_mode():
        mel = torch.from_numpy(inp["mel"][:1])
        xa = whisper.precompute_xa_kv(cfg, model, whisper.encoder_apply(cfg, model, mel))
        tokens = torch.from_numpy(inp["tokens"].astype(np.int64))
        kv = whisper.init_kv_cache(cfg, 1, 64, n_head=whisper.text_heads(cfg, model))
        _, _, reduced = whisper.decoder_apply(cfg, model, tokens, 0, kv, xa,
                                              collect_cross_attn=True,
                                              cross_attn_layer_begin=cfg.n_text_layer // 2)
        kv = whisper.init_kv_cache(cfg, 1, 64, n_head=whisper.text_heads(cfg, model))
        _, _, stacked = whisper.decoder_apply(cfg, model, tokens, 0, kv, xa,
                                              collect_cross_attn=True)
        sp = fallback_tokenizer(cfg.n_vocab).special
        probs = sampling.detect_language(cfg, model, xa, sp.sot, sp.language_begin,
                                         sp.num_languages)
        from sentiric_stt_whisper_service_tpu_torch.models import timestamps

        scores = timestamps.alignment_scores(cfg, model, xa, tokens)
    out["shard/reduced"] = reduced.numpy()
    out["shard/stacked"] = stacked.numpy()
    out["shard/detect"] = probs.numpy()
    out["shard/scores"] = scores.numpy()


def task_engine(inp, cfg, out: dict) -> None:
    """``SttEngine`` over the mesh ``inp["mesh"]`` at each form: rank 0 runs
    the requests (``engine_requests``) and closes the channel; the other
    ranks follow. Every rank records the (query rows, key rows) of each K2
    route call of its encodes, and its channel's counts; a follower the
    values it still kept when rank 0 closed. Then the same form with a
    draft (``draft_requests``): every rank records its draft's heads and
    its speculative ops' outcomes (``spec_outcomes``). First, every rank
    builds an engine whose draft has one head, which tp = 2 does not
    divide: the refusal's message."""
    shape = str(inp["mesh"])
    mesh = parallel.make_mesh(shape, device="cpu")
    if mesh.shape["tp"] > 1:
        shard_checks(inp, cfg, mesh, out)
        one_head = dataclasses.replace(cfg, n_audio_head=1, n_text_head=1)
        try:
            engine_mod.SttEngine(
                Settings(device="cpu", mesh_shape=shape, compute_type="float32",
                         **DRAFT_SETTINGS),
                model_name="test-8h", params=model_of(inp, cfg),
                draft_params=whisper.init_params(one_head, torch.Generator().manual_seed(1)))
            out["draft_refused"] = np.array("")
        except ValueError as e:
            out["draft_refused"] = np.array(str(e))
    routes = []
    k2 = whisper.flash_attention

    def recording(q, k, v):
        routes.append((q.shape[2], k.shape[2]))
        return k2(q, k, v)

    whisper.flash_attention = recording
    try:
        for form, compute in ENGINE_FORMS.items():
            settings = Settings(device="cpu", mesh_shape=shape, compute_type=compute,
                                **ENGINE_SETTINGS)
            eng = engine_mod.SttEngine(settings, model_name="test-8h", params=model_of(inp, cfg))
            out[f"{form}/heads"] = np.array(whisper.text_heads(cfg, eng.params))
            if eng.is_leader:
                t0 = time.perf_counter()
                engine_requests(eng, inp, form, out, stream=form == "fp32")
                out[f"{form}/seconds"] = np.array(time.perf_counter() - t0)
                eng.shutdown()
                gc.collect()
                eng._replay.flush()
                eng.close()
            else:
                eng.follow()
                out[f"{form}/kept_at_stop"] = np.array(eng._replay.kept_at_stop)
            stats = eng._replay.stats
            out[f"{form}/channel"] = np.array([stats.ops, stats.decisions,
                                               stats.op_seconds + stats.decision_seconds])
            del eng
            # The same form with a draft, sharded like the target.
            settings = Settings(device="cpu", mesh_shape=shape, compute_type=compute,
                                **DRAFT_SETTINGS)
            eng = engine_mod.SttEngine(settings, model_name="test-8h", params=model_of(inp, cfg),
                                       draft_params=model_of(inp, cfg))
            out[f"{form}/draft_heads"] = np.array(whisper.text_heads(cfg, eng.draft_params))
            outcomes = spec_outcomes(eng)
            if eng.is_leader:
                draft_requests(eng, inp, form, out, stream=form == "fp32")
                eng.shutdown()
                gc.collect()
                eng._replay.flush()
                eng.close()
            else:
                eng.follow()
                out[f"{form}/draft_kept_at_stop"] = np.array(eng._replay.kept_at_stop)
            out[f"{form}/spec_outcomes"] = np.array(json.dumps(outcomes))
            del eng
    finally:
        whisper.flash_attention = k2
    out["routes"] = np.array(routes, np.int64).reshape(-1, 2)


def task_engine_fault(inp, cfg, out: dict) -> None:
    """Rank 0 raises inside an op whose followers wait on a collective that
    rank 0 never joins: every rank must exit (none hangs) within the
    channel's timeout."""
    mesh = parallel.make_mesh("1x2", device="cpu")
    settings = Settings(device="cpu", mesh_shape="1x2", compute_type="float32",
                        **ENGINE_SETTINGS)
    eng = engine_mod.SttEngine(settings, model_name="test-8h", params=model_of(inp, cfg))

    def planted(own=None):
        eng._replay.decide(lambda: True)
        if eng.is_leader:
            raise RuntimeError("planted fault on rank 0")
        dist.all_reduce(torch.zeros(1), group=mesh.group("tp"))

    eng._replay.register("planted", planted)
    if eng.is_leader:
        eng._replay.call("planted")
    else:
        eng.follow()


IDLE_TIMEOUT_S = 4.0  # task engine_idle: the channel's timeout
IDLE_S = 10.0  # ... and how long rank 0 idles before its request


def task_engine_idle(inp, cfg, out: dict) -> None:
    """Rank 0 idles for more than twice the channel's timeout before its
    first request: the keep-alive holds the follower, and the request is
    served."""
    from sentiric_stt_whisper_service_tpu_torch.parallel import replay

    replay.TIMEOUT_S = IDLE_TIMEOUT_S
    settings = Settings(device="cpu", mesh_shape="1x2", compute_type="float32",
                        **ENGINE_SETTINGS)
    eng = engine_mod.SttEngine(settings, model_name="test-8h", params=model_of(inp, cfg))
    if eng.is_leader:
        time.sleep(IDLE_S)
        res = eng.transcribe(clip_of(inp), 16000, engine_mod.RequestOptions(
            language="en", max_decode_tokens=8))
        out["segments"] = np.array(json.dumps(segments(res)))
        eng.shutdown()
        eng.close()
    else:
        eng.follow()
    out["ops"] = np.array(eng._replay.stats.ops)


def start(task: str, inputs: dict, tmp: Path, world: int = 4, env_of=None):
    """Start ``world`` workers of ``task`` on ``inputs`` (written to
    ``tmp/in.npz``); returns the processes. ``env_of(rank)``: the env each
    worker joins through (``multihost``); else a gloo file store under
    ``tmp``."""
    tmp = Path(tmp)
    np.savez(tmp / "in.npz", **inputs)
    head = [sys.executable, str(Path(__file__).resolve()), task, str(tmp / "in.npz"),
            str(tmp / "out")]
    base = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        head + ([] if env_of else [str(rank), str(world), str(tmp / "store")]),
        env=base | (env_of(rank) if env_of else {}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]


def finish(procs, timeout: float) -> list[str]:
    """Each process's output, once all have exited (killed past
    ``timeout`` seconds)."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()


def run(task: str, inputs: dict, tmp: Path, world: int = 4, env_of=None,
        timeout: float = 240) -> list[dict]:
    """``start`` the workers, wait for them, and return each rank's
    outputs; every worker must exit 0."""
    procs = start(task, inputs, tmp, world, env_of)
    logs = finish(procs, timeout)
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(x[-3000:] for x in logs)
    return [dict(np.load(Path(tmp) / f"out.{rank}.npz")) for rank in range(world)]


TASKS = {"parallel": task_parallel, "training": task_training, "multihost": task_multihost,
         "engine": task_engine, "engine_fault": task_engine_fault,
         "engine_idle": task_engine_idle}


def main(argv) -> int:
    task, inputs, prefix = argv[:3]
    torch.set_num_threads(1)
    if task == "multihost":
        assert parallel.maybe_initialize_distributed(device="cpu")
    else:
        rank, world, init = int(argv[3]), int(argv[4]), argv[5]
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                                world_size=world)
    inp = np.load(inputs)
    cfg = whisper.config_for(str(inp["cfg"]), dtype=torch.float32)
    out: dict = {}
    TASKS[task](inp, cfg, out)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "optax", "sentiric_stt_whisper_service_tpu"))
    out["imported_jax"] = np.array(bool(bad))
    np.savez(f"{prefix}.{dist.get_rank()}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
