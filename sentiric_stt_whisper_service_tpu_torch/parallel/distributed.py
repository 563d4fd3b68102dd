"""Joining the processes: the JAX package's ``jax.distributed`` leg in
``torch.distributed``.

The JAX package scales across hosts by configuration: each host runs the
same service, ``jax.distributed.initialize`` connects the processes and
``MESH_SHAPE`` builds one mesh over the global device list. Here each
process drives one device, so joining the processes is
``torch.distributed.init_process_group`` and the mesh is a ``DeviceMesh``
over the ranks (``parallel/mesh.py``).

Env surface (the ``STT_WHISPER_SERVICE_`` prefix of every other knob):

  * ``COORDINATOR_ADDRESS``: ``host:port`` of rank 0's store. Setting it is
    the opt-in; unset, the service is one process (the default).
  * ``NUM_PROCESSES`` / ``PROCESS_ID``: the world size and this process's
    rank. Where both are unset, torchrun's ``WORLD_SIZE`` / ``RANK`` stand
    in (JAX reads a TPU pod's from its metadata service).

``serving/main.py`` calls :func:`maybe_initialize_distributed` before any
device touch.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

_PREFIX = "STT_WHISPER_SERVICE_"
log = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device: Optional[str] = None,
    backend: Optional[str] = None,
) -> torch.device:
    """``init_process_group`` over ``tcp://<coordinator_address>``: NCCL for
    a process on the card (the default), gloo for one on the CPU
    (``device="cpu"``); ``backend`` names one outright (gloo also carries
    CUDA tensors: two ranks sharing one card). A CUDA process takes device
    ``LOCAL_RANK`` (default: its rank) modulo the cards it sees, and raises
    where there is none. Call once, before any device touch. Returns this
    process's device."""
    on_cpu = device == "cpu"
    local = torch.device("cpu")
    if not on_cpu:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("initialize_distributed: no CUDA device (device='cpu' runs "
                               "on the CPU over gloo)")
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id)) % n_cards)
        torch.cuda.set_device(local)
    addr = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(
        backend or ("gloo" if on_cpu else "nccl"), init_method=f"tcp://{addr}",
        world_size=int(num_processes), rank=int(process_id),
    )
    return local


def maybe_initialize_distributed(device: Optional[str] = None) -> bool:
    """Env-gated join of the processes. Returns True when it initialized
    the process group, False for the single-process default (no
    ``COORDINATOR_ADDRESS``). Raises when the address is set but neither
    ``NUM_PROCESSES`` / ``PROCESS_ID`` nor torchrun's ``WORLD_SIZE`` /
    ``RANK`` give the world. ``device`` as in ``initialize_distributed``."""
    addr = os.environ.get(_PREFIX + "COORDINATOR_ADDRESS", "").strip()
    if not addr:
        return False
    nproc = os.environ.get(_PREFIX + "NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
    pid = os.environ.get(_PREFIX + "PROCESS_ID") or os.environ.get("RANK")
    if nproc is None or pid is None:
        raise RuntimeError(
            f"{_PREFIX}COORDINATOR_ADDRESS={addr!r} but the world is not given: set "
            f"{_PREFIX}NUM_PROCESSES and {_PREFIX}PROCESS_ID (or torchrun's WORLD_SIZE and RANK)")
    local = initialize_distributed(addr, int(nproc), int(pid), device=device)
    log.info("torch.distributed initialized: process %d/%d (%s), local device %s",
             dist.get_rank(), dist.get_world_size(), dist.get_backend(), local)
    return True


def make_global_array(value, placement) -> torch.Tensor:
    """This rank's block of a host-identical numpy ``value`` under
    ``placement`` (``parallel/mesh.Placement``, e.g. ``data_sharding``), on
    the mesh's device. Every process passes the same value."""
    return placement.local(value)


def shard_params_global(mesh, model):
    """``shard_params``: with one process per device every process holds
    only its own blocks, so placing a host-identical model across processes
    is what ``shard_params`` already does."""
    from .mesh import shard_params

    return shard_params(mesh, model)
