"""Device mesh and the Megatron shard plan: the JAX package's
``parallel/mesh.py`` in PyTorch's one-process-per-device world.

The JAX package is one controller over every device: ``make_mesh`` reshapes
``jax.devices()`` and GSPMD places each array by its ``NamedSharding``. Here
each process drives one device (``torch.distributed``, joined by
``parallel/distributed.py``), so the mesh is a ``DeviceMesh`` over the
ranks, laid out as the JAX package lays out its devices (rank r sits at
dp = r // (tp·sp), tp = r // sp mod tp, sp = r mod sp), and a placement is
this rank's slice of a host-identical value.

Axes, as in the JAX package:
  * ``dp``: the batch of windows. Each rank holds its rows
    (``data_sharding``); training sums the gradients over dp.
  * ``tp``: attention heads and the MLP's hidden width. The q/k/v and
    ``mlp_1`` weights are column-parallel (their outputs split), ``o`` and
    ``mlp_2`` row-parallel (their inputs split), so each attention and each
    MLP ends in one all-reduce: ``models/whisper.dense`` runs the two
    Megatron operators from each ``Dense``'s ``tp_group`` and ``tp_role``,
    which ``shard_params`` sets. A shard holds ``n_head / tp`` heads.
  * ``sp``: the encoder's residual stream along time. Each rank holds T/sp
    rows (``seq_constraint``) and the attention all-gathers K and V
    (``gather_seq``).

The self cache ``[L, B, H, C, hd]``, the cross slab ``[L, B, H, hd, F]`` and
their scales ``[L, B, H, F]`` shard as (None, dp, tp, None, …)
(``kv_cache_shardings``). Mesh "1" has no process group and leaves a model
as it is: no collective, no copy.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def mesh_dims(shape: str, n_devices: int) -> dict:
    """The axis sizes of a mesh ``shape`` over ``n_devices``: "1" (one
    device), "4" (tp 4), "2x4" (dp x tp), "2x2x2" (dp x tp x sp) or "auto"
    (every device on dp), as the JAX package's ``make_mesh`` reads them.
    Raises ``ValueError`` when the mesh needs more devices than there are."""
    sp = None
    if shape in ("1", "", None):
        dp, tp = 1, 1
    elif shape == "auto":
        dp, tp = n_devices, 1
    elif "x" in shape:
        dims = [int(x) for x in shape.split("x")]
        if len(dims) == 3:
            dp, tp, sp = dims
        elif len(dims) == 2:
            dp, tp = dims
        else:
            raise ValueError(f"mesh {shape}: expected dp x tp or dp x tp x sp")
    else:
        dp, tp = 1, int(shape)
    total = dp * tp * (sp or 1)
    if total > n_devices:
        raise ValueError(f"mesh {shape} needs {total} devices, have {n_devices}")
    return {"dp": dp, "tp": tp} | ({"sp": sp} if sp else {})


@dataclasses.dataclass(eq=False)
class Mesh:
    """The mesh's axis sizes (``shape``, the JAX ``Mesh.shape``), the device
    this rank drives, and the ``DeviceMesh`` over the ranks (None on a mesh
    of one device)."""

    shape: dict
    device: torch.device
    device_mesh: Any = None

    def group(self, axis: str):
        """The process group of ``axis`` through this rank, or None where
        the axis has one device (nothing to reduce or gather)."""
        if self.device_mesh is None or self.shape.get(axis, 1) == 1:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.device_mesh is None or axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)


def make_mesh(shape: str = "1", device="cuda") -> Mesh:
    """A (dp, tp) or (dp, tp, sp) mesh over the processes of the default
    process group (``mesh_dims`` reads ``shape``). Every process must take a
    place in a mesh of more than one device. ``device``: the device each
    process drives, the card unless the caller asks for the CPU."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    dims = mesh_dims(shape, n)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    total = math.prod(dims.values())
    if total == 1:
        return Mesh(dims, dev)
    if total != n:
        raise ValueError(f"mesh {shape} takes {total} of {n} processes: each process must "
                         "hold one place of the mesh")
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(n).reshape(tuple(dims.values()))
    return Mesh(dims, dev, DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(dims)))


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """How a global array lies on the mesh: ``spec`` names, per dimension,
    the axis it is split over or None (the JAX ``PartitionSpec``'s terms; an
    empty spec is replicated)."""

    mesh: Mesh
    spec: tuple

    def local(self, value) -> torch.Tensor:
        """This rank's block of a host-identical ``value`` (numpy or a
        tensor), on the mesh's device."""
        x = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
        for dim, axis in enumerate(self.spec):
            n = self.mesh.shape.get(axis, 1) if axis else 1
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                                 f"{axis} = {n}")
            size = x.shape[dim] // n
            x = x.narrow(dim, self.mesh.index(axis) * size, size)
        return x.to(self.mesh.device).clone(memory_format=torch.contiguous_format)


def data_sharding(mesh: Mesh, ndim: int) -> Placement:
    """Batch-major arrays: dim 0 over dp."""
    return Placement(mesh, ("dp",) + (None,) * (ndim - 1))


def kv_cache_shardings(mesh: Mesh, cache: dict) -> dict:
    """KV slabs [L, B, H, C, hd] → (None, dp, tp, None, None); int8/int4
    per-position scales [L, B, H, C] → (None, dp, tp, None)."""
    return {name: Placement(mesh, (None, "dp", "tp") + (None,) * (t.ndim - 3))
            for name, t in cache.items()}


def xa_kv_shardings(mesh: Mesh, xa_kv: dict) -> dict:
    return kv_cache_shardings(mesh, xa_kv)


_CONV = re.compile(r"^(conv\d)_([wb])$")


def jax_path(name: str) -> tuple[str, Optional[int]]:
    """A parameter's name in a ``Whisper`` module → (its path in the JAX
    package's parameter tree, its layer or None): "encoder.blocks.3.attn.q.w"
    → ("encoder/blocks/attn/q/w", 3), "encoder.conv1_w" → ("encoder/conv1/w",
    None)."""
    parts = name.split(".")
    layer = None
    if len(parts) > 2 and parts[1] == "blocks":
        layer = int(parts.pop(2))
    parts = [p for part in parts for p in (_CONV.match(part).groups()
                                            if _CONV.match(part) else (part,))]
    return "/".join(parts), layer


def spec_for_path(path: str, ndim: int) -> tuple:
    """The JAX package's ``_spec_for_path`` (its regexes, its order): the
    partition spec of a leaf from its tree path and rank."""
    # Column-parallel: q/k/v projections and the first MLP matmul (int8 w_q
    # and its per-output-channel scale too) split their outputs.
    if re.search(r"(attn|cross_attn)/(q|k|v)/w(_q)?$", path) or re.search(
        r"mlp_1/w(_q)?$", path
    ):
        return (None,) * (ndim - 1) + ("tp",)
    if re.search(r"(attn|cross_attn)/(q|k|v)/scale$", path) or path.endswith("mlp_1/scale"):
        return (None,) * (ndim - 1) + ("tp",)
    if re.search(r"(attn|cross_attn)/(q|v)/b$", path) or path.endswith("mlp_1/b"):
        return (None,) * (ndim - 1) + ("tp",)
    # Row-parallel: o and the second MLP matmul split their inputs; their
    # biases and per-output-channel scales are replicated.
    if re.search(r"(attn|cross_attn)/o/w(_q)?$", path) or re.search(r"mlp_2/w(_q)?$", path):
        return (None,) * (ndim - 2) + ("tp", None)
    # Everything else (layer norms, convs, embeddings, pos) is replicated.
    return ()


def _tensors(model):
    yield from model.named_parameters()
    yield from model.named_buffers()


def param_shardings(mesh: Mesh, model) -> dict:
    """{name: Placement} for every parameter and buffer of a ``Whisper``
    module: the Megatron plan of ``spec_for_path``, per layer (the JAX
    package's specs without their leading layer axis)."""
    return {name: Placement(mesh, spec_for_path(jax_path(name)[0], t.ndim))
            for name, t in _tensors(model)}


def shard_params(mesh: Mesh, model):
    """This rank's ``Whisper``: each tensor its block of the plan
    (``param_shardings``), the attentions ``n_head / tp`` local heads, each
    split ``Dense`` its tp group and role, the module the mesh (its dp and
    sp groups). The model given is left as it is. On mesh "1" it is returned
    itself. Decoder q/k/v stay unfused, as the JAX engine keeps them under
    tp: a fused model is refused."""
    if mesh.device_mesh is None:
        return model
    if model.mesh is not None:
        raise ValueError("shard_params: the model is sharded already")
    if any(b.attn.qkv is not None for b in model.decoder.blocks):
        raise ValueError("shard_params: decoder q/k/v are fused (ops/quant.fuse_decoder_qkv); "
                         "a tensor-parallel model keeps them apart")
    cfg, tp = model.cfg, mesh.shape["tp"]
    if cfg.n_audio_head % tp or cfg.n_text_head % tp:
        raise ValueError(f"tp = {tp} does not divide the heads ({cfg.n_audio_head}, "
                         f"{cfg.n_text_head})")
    plan = param_shardings(mesh, model)
    memo = {}
    for name, t in _tensors(model):
        local = plan[name].local(t.detach())
        memo[id(t)] = (torch.nn.Parameter(local, requires_grad=t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else local)
    sharded = copy.deepcopy(model, memo)
    sharded.mesh = mesh
    from ..models.whisper import Dense

    group = mesh.group("tp")
    roles = {(None, "tp"): "column", ("tp", None): "row"}
    for name, m in sharded.named_modules():
        if isinstance(m, Dense):
            m.tp_role = roles.get(plan[f"{name}.{'w' if m.w is not None else 'w_q'}"].spec)
            m.tp_group = group if m.tp_role else None
    return sharded


class _GatherSeq(torch.autograd.Function):
    """All-gather along time (dim 1) over a group; backward: the summed
    gradient's rows of this rank (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return grad.chunk(n, dim=1)[dist.get_rank(ctx.group)].contiguous(), None


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, T/sp, ...] rows of every sp rank → [B, T, ...]; identity without
    a group."""
    return x if group is None else _GatherSeq.apply(x, group)


def seq_constraint(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's T/sp rows of a [B, T, ...] activation on a mesh with an
    "sp" axis; the identity otherwise (the JAX package's constraint of the
    encoder's residual stream to (dp, sp))."""
    group = None if mesh is None else mesh.group("sp")
    if group is None:
        return x
    n = mesh.shape["sp"]
    if x.shape[1] % n:
        raise ValueError(f"sp = {n} does not divide the encoder's {x.shape[1]} positions")
    size = x.shape[1] // n
    return x.narrow(1, mesh.index("sp") * size, size)
