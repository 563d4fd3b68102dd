"""Fine-tuning: the teacher-forced training step, the JAX package's
``runtime/training.py``.

The step is the canonical seq2seq one: the encoder, the cross K/V and the
decoder over the teacher's tokens (``decoder_apply`` without a cache, so
that autograd never sees a view written after it was saved), the masked
cross-entropy, its gradient and one AdamW update. The encoder's attention
over its 1500 positions runs K2 forward through
``ops/flash_attention.FlashAttention``, whose backward is plain PyTorch (the
JAX package has no backward kernel either).

On a mesh (``parallel/mesh.shard_params``) each rank holds its dp rows of
the batch and its tp shard of the weights. The JAX loss divides by the
global batch's ``sum(loss_mask)``: each rank divides its masked sum by that
all-reduced count, and the gradients are summed over dp (and over sp,
whose ranks repeat the decoder: each counts 1/sp of the loss). tp ranks
compute the replicated parameters' gradients whole (Megatron's f and g in
``models/whisper.dense``), so nothing is reduced over tp.

Weights train in their own dtype, as optax trains the JAX package's: there
are no fp32 master weights.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..models.whisper import (
    Dense,
    Whisper,
    WhisperConfig,
    decoder_apply,
    encoder_apply,
    precompute_xa_kv,
)


class TrainState(NamedTuple):
    params: Whisper  # the trained module: its parameters require grad
    opt_state: dict  # the optimizer's ``state``: per parameter exp_avg, exp_avg_sq, step
    step: int


def make_optimizer(model: Whisper, lr: float = 1e-5,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """``optax.adamw`` over ``model``'s trainable parameters, with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8, decoupled decay of every
    parameter): its moments are the optax state's mu and nu."""
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("make_optimizer: no parameter requires grad (use training_copy)")
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def training_copy(model: Whisper) -> Whisper:
    """A copy of ``model`` whose parameters require grad (models are built
    without). A model with int8 weights is refused: they do not train."""
    if model.decoder.tok_emb_q is not None or any(
            m.w_q is not None for m in model.modules() if isinstance(m, Dense)):
        raise ValueError("training_copy: the model has int8 weights (ops/quant.py)")
    memo = {id(m.tp_group): m.tp_group for m in model.modules()
            if isinstance(m, Dense) and m.tp_group is not None}
    if model.mesh is not None:
        memo[id(model.mesh)] = model.mesh
    train = copy.deepcopy(model, memo)
    for p in train.parameters():
        p.requires_grad_(True)
    return train


def _replica_groups(model: Whisper) -> list:
    """The groups whose ranks hold the same weights: dp, then sp."""
    mesh = model.mesh
    return [] if mesh is None else [g for g in (mesh.group("dp"), mesh.group("sp")) if g]


def loss_fn(cfg: WhisperConfig, model: Whisper, mel, tokens, loss_mask) -> torch.Tensor:
    """Teacher-forced CE. tokens [B, T] (inputs tokens[:, :-1], targets
    tokens[:, 1:]); loss_mask [B, T-1] masks prompt and pad positions. On a
    mesh: this rank's share of the global loss (its masked sum over the
    global count, over sp when sp repeats it), whose sum over the dp and sp
    ranks is the JAX loss."""
    tokens = tokens.long()
    xa = encoder_apply(cfg, model, mel)
    xa_kv = precompute_xa_kv(cfg, model, xa)
    logits, _ = decoder_apply(cfg, model, tokens[:, :-1], 0, None, xa_kv)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = logp.gather(-1, tokens[:, 1:, None])[..., 0]
    mask = loss_mask.to(tgt.dtype)
    denom = mask.sum()
    mesh = model.mesh
    if mesh is not None and mesh.group("dp") is not None:
        dist.all_reduce(denom, group=mesh.group("dp"))
    loss = -(tgt * mask).sum() / denom.clamp(min=1.0)
    if mesh is not None and mesh.group("sp") is not None:
        loss = loss / mesh.shape["sp"]
    return loss


def loss_and_grads(cfg: WhisperConfig, model: Whisper, mel, tokens, loss_mask):
    """The loss and its gradient: returns (the global loss, a 0-d fp32
    tensor; {name: grad} of every parameter that requires grad, left in
    each ``.grad``). On a mesh each grad is this rank's shard of the global
    gradient: summed over the ranks that hold the same weights."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    for p in params.values():
        p.grad = None
    loss = loss_fn(cfg, model, mel, tokens, loss_mask)
    loss.backward()
    loss = loss.detach().float()
    for group in _replica_groups(model):
        dist.all_reduce(loss, group=group)
        for p in params.values():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=group)
    return loss, {n: p.grad for n, p in params.items()}


def train_step(cfg: WhisperConfig, optimizer: torch.optim.AdamW, state: TrainState, mel,
               tokens, loss_mask):
    """One ``optimizer`` step (``make_optimizer(state.params)``) on the
    loss's gradient, which it then frees (optax's ``update`` and
    ``apply_updates``). Returns (the new state, the loss before the step);
    the parameters are updated in place."""
    loss, _ = loss_and_grads(cfg, state.params, mel, tokens, loss_mask)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return TrainState(state.params, state.opt_state, state.step + 1), loss
