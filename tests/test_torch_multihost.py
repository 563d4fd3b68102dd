"""The port's multi-process leg (``parallel/distributed.py``) against the
JAX package's ``tests/test_multihost.py``: two OS processes joined through
the service's env surface (``STT_WHISPER_SERVICE_COORDINATOR_ADDRESS``,
``..._NUM_PROCESSES``, ``..._PROCESS_ID``) over gloo run the greedy decode
on a "2x1" mesh (dp across the processes); the gathered tokens and lengths
equal the JAX package's single-process decode of the same problem
(``tools/multihost_worker._problem``) exactly, the average log-probabilities
within 1e-4 (the JAX worker's tolerance). Also: no address, no process
group; an address without a world raises; ``serve()`` joins the processes
before it builds the engine, and refuses to serve when joining fails."""

import dataclasses
import socket
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu_torch import parallel
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from _torch_mesh_worker import run
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import multihost_worker  # noqa: E402  (the JAX package's multi-host problem)

ENV = "STT_WHISPER_SERVICE_"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_decode_like_one(tmp_path):
    cfg, params, mel, ids, sup, sot, tinit = multihost_worker._problem()
    assert dataclasses.replace(cfg, dtype=jnp.float32) == ref.config_for("test-8h", jnp.float32)
    want = multihost_worker._decode(cfg, params, mel, ids, sup, sot, tinit)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    inputs = {"p/" + "/".join(str(k.key) for k in path): np.asarray(x) for path, x in leaves}
    inputs.update(cfg=np.array("test-8h"), mel=mel, tinit=tinit, sample_begin=np.array(len(sot)),
                  max_len=np.array(len(sot) + 8))
    port = free_port()
    outs = run("multihost", inputs, tmp_path, world=2, env_of=lambda rank: {
        ENV + "COORDINATOR_ADDRESS": f"127.0.0.1:{port}", ENV + "NUM_PROCESSES": "2",
        ENV + "PROCESS_ID": str(rank)})
    for out in outs:
        assert not bool(out["imported_jax"])
        np.testing.assert_array_equal(out["lengths"], np.asarray(want.lengths))
        for b, n in enumerate(np.asarray(want.lengths)):
            np.testing.assert_array_equal(out["tokens"][b, :n], np.asarray(want.tokens)[b, :n])
        np.testing.assert_allclose(out["avg_logprobs"], np.asarray(want.avg_logprobs),
                                   atol=1e-4, rtol=1e-4)


def test_no_address_no_process_group(monkeypatch):
    monkeypatch.delenv(ENV + "COORDINATOR_ADDRESS", raising=False)
    assert parallel.maybe_initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_an_address_without_a_world_raises(monkeypatch):
    monkeypatch.setenv(ENV + "COORDINATOR_ADDRESS", "127.0.0.1:1")
    for name in (ENV + "NUM_PROCESSES", ENV + "PROCESS_ID", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="NUM_PROCESSES"):
        parallel.maybe_initialize_distributed(device="cpu")
    assert not dist.is_initialized()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("joins", [True, False])
def test_serve_joins_before_the_engine(monkeypatch, joins):
    import importlib

    main = importlib.import_module("sentiric_stt_whisper_service_tpu_torch.serving.main")
    calls, events = [], []

    def join(device=None):
        calls.append(("join", device))
        if not joins:
            raise RuntimeError("store unreachable")
        return False

    def engine(*a, **kw):
        calls.append(("engine",))
        raise _Stop

    monkeypatch.setattr(main, "maybe_initialize_distributed", join)
    monkeypatch.setattr(main, "SttEngine", engine)
    monkeypatch.setattr(main, "suts_error", lambda event, *a: events.append(event))
    with pytest.raises(_Stop if joins else RuntimeError):
        main.serve(Settings(device="cpu"), random_init=True, block=False)
    assert calls == ([("join", "cpu"), ("engine",)] if joins else [("join", "cpu")])
    assert events == ([] if joins else ["DISTRIBUTED_INIT_FAILED"])
