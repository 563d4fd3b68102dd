"""One rank of the port's multi-process CPU tests (``test_torch_parallel.py``,
``test_torch_training.py``, ``test_torch_multihost.py``), joined over gloo.

It imports numpy, torch and the port, never JAX: the test that starts it
writes its inputs (the JAX package's weights as numpy, the batch) to an
``.npz`` and reads its outputs from another, ``<out>.<rank>.npz``.

    python tests/_torch_mesh_worker.py TASK INPUTS.npz OUT RANK WORLD INIT_FILE
    python tests/_torch_mesh_worker.py multihost INPUTS.npz OUT

``multihost`` takes its rank and world from the service's env surface
(``STT_WHISPER_SERVICE_COORDINATOR_ADDRESS``, ``..._NUM_PROCESSES``,
``..._PROCESS_ID``) through ``parallel.maybe_initialize_distributed``.
The tests start the workers with ``run``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sentiric_stt_whisper_service_tpu_torch import parallel  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.models import sampling, whisper  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.ops.quant import quantize_params  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.runtime import training  # noqa: E402
from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer  # noqa: E402

ENCODER_MESHES = ("2x2", "1x4", "1x1x4")
TRAINING_MESHES = ("2x2", "1x2x2")


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


def run(task: str, inputs: dict, tmp: Path, world: int = 4, env_of=None,
        timeout: float = 240) -> list[dict]:
    """Start ``world`` workers of ``task`` on ``inputs`` (written to
    ``tmp/in.npz``) and return each rank's outputs. ``env_of(rank)``: the
    env each worker joins through (``multihost``); else a gloo file store
    under ``tmp``."""
    tmp = Path(tmp)
    np.savez(tmp / "in.npz", **inputs)
    head = [sys.executable, str(Path(__file__).resolve()), task, str(tmp / "in.npz"),
            str(tmp / "out")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        head + ([] if env_of else [str(rank), str(world), str(tmp / "store")]),
        env=env | (env_of(rank) if env_of else {}), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(x[-3000:] for x in logs)
    return [dict(np.load(tmp / f"out.{rank}.npz")) for rank in range(world)]


TASKS = {"parallel": task_parallel, "training": task_training, "multihost": task_multihost}


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
