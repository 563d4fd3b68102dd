"""Training (``runtime/training.py``) and K2's gradient
(``ops/flash_attention.FlashAttention``) against the JAX package, on the CPU.

  * ``loss_fn`` and every parameter's gradient against ``jax.value_and_grad``
    of the JAX ``loss_fn``, fp32 ``test`` model, prompt positions masked and
    a random mask elsewhere, at T_mel 96 (48 encoder positions, the dry
    run's) and 3000 (1500 positions: t >= 512, through ``FlashAttention``):
    the loss within rtol 1e-5, each gradient within 1e-4 of its leaf's
    largest |g| (fp32 sums in another order);
  * two ``train_step``s at the default lr 1e-5 against the JAX
    ``train_step`` (``optax.adamw``): each step's loss (rtol 1e-5), both
    moments (mu, nu) within 1e-4 of their leaf's largest value, the step
    counts, and every weight's move within 5 % of lr (see the test); and
    AdamW fed the same gradients as optax.adamw (1e-6 of each leaf);
  * ``FlashAttention``'s backward against autograd through
    ``attention_reference`` (fp32, 1e-5 of the largest |g|), and
    ``torch.autograd.gradcheck`` in float64;
  * in four gloo processes (``tests/_torch_mesh_worker.py``, no JAX), the
    fp32 ``test-8h`` model sharded dp 2 x tp 2 and tp 2 x sp 2, a loss mask
    that differs between the dp shards: the global loss (rtol 1e-5) and each
    rank's gradient shards against the matching blocks of the JAX
    single-device gradients (1e-4 of each leaf's largest |g|). A mean of
    per-shard means, or a gradient reduced once too often over tp (the
    all-reduce of ``torch.distributed.nn``), fails it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.runtime import training as ref_training
from sentiric_stt_whisper_service_tpu_torch.models import whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import (
    FlashAttention,
    attention_reference,
)
from sentiric_stt_whisper_service_tpu_torch.ops.quant import quantize_params
from sentiric_stt_whisper_service_tpu_torch.parallel import mesh as port_mesh
from sentiric_stt_whisper_service_tpu_torch.runtime import training
from _torch_mesh_worker import TRAINING_MESHES, run
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4  # of each leaf's largest |value|
PROMPT = 3  # masked prompt positions


def path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def flat(tree) -> dict:
    return {path_str(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batch(cfg, B, T_mel, T=12, seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, T_mel, cfg.n_mels)).astype(np.float32)
    tokens = rng.integers(0, 1000, (B, T)).astype(np.int32)
    mask = (rng.random((B, T - 1)) > 0.25).astype(np.float32)
    mask[:, :PROMPT] = 0.0
    return mel, tokens, mask


def close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def by_jax_path(named: dict, want: dict, slicer=None):
    """Hold {port name: tensor} against the JAX leaves, layer by layer;
    every leaf of ``want`` is covered."""
    assert {port_mesh.jax_path(n)[0] for n in named} == set(want) - {"encoder/pos"}
    for name, t in named.items():
        path, layer = port_mesh.jax_path(name)
        w = want[path] if layer is None else want[path][layer]
        got = t.detach().numpy() if isinstance(t, torch.Tensor) else t
        close(got, w if slicer is None else slicer(name, w), name)


def port_model(cfg, params):
    return training.training_copy(from_jax_numpy(jax.tree.map(np.asarray, params), cfg, "cpu"))


@pytest.mark.parametrize("t_mel", [96, 3000])
def test_loss_and_grads_match_jax(t_mel):
    cfg_r, cfg = ref.config_for("test", jnp.float32), whisper.config_for("test", torch.float32)
    params = ref.init_params(cfg_r, jax.random.key(0))
    mel, tokens, mask = batch(cfg, 2, t_mel)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: ref_training.loss_fn(
        cfg_r, p, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(mask))))(params)
    model = port_model(cfg, params)
    calls = []
    apply = FlashAttention.apply
    FlashAttention.apply = lambda *a: calls.append(1) or apply(*a)
    try:
        loss, grads = training.loss_and_grads(cfg, model, torch.from_numpy(mel),
                                              torch.from_numpy(tokens), torch.from_numpy(mask))
    finally:
        FlashAttention.apply = apply
    assert len(calls) == (cfg.n_audio_layer if t_mel == 3000 else 0)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    by_jax_path(grads, flat(want))


def test_two_train_steps_match_jax():
    """Each step's loss, both moments, and every weight's move over the two
    steps, at the default lr 1e-5: within 5 % of lr where 0 < |g| < 1e-6 at
    neither step (the second step's m / sqrt(v) turns on the packages'
    ~1e-8 fp32 gradient difference by up to 2 % where its two gradients
    nearly cancel). Where |g| is near eps, Adam's g / (|g| + 1e-8) turns on
    that difference wholly: those weights (the output embedding's rare rows) within
    the 3 lr that two steps can move a weight. (At lr 1e-3 they would
    perturb the second step's gradients by 1e-3.) ``test_adamw_update_is_optax``
    holds the update itself to 1e-6."""
    cfg_r, cfg = ref.config_for("test", jnp.float32), whisper.config_for("test", torch.float32)
    params = ref.init_params(cfg_r, jax.random.key(1))
    start = flat(params)
    mel, tokens, mask = batch(cfg, 2, 96, seed=1)
    opt_r = ref_training.make_optimizer()
    model = port_model(cfg, params)
    opt = training.make_optimizer(model)
    lr = opt.param_groups[0]["lr"]
    state_r = ref_training.TrainState(params, opt_r.init(params), jnp.int32(0))
    state = training.TrainState(model, opt.state, 0)
    args = [torch.from_numpy(x) for x in (mel, tokens, mask)]
    grad_r = jax.jit(jax.grad(lambda p: ref_training.loss_fn(
        cfg_r, p, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(mask))))
    ill = {}
    for _ in range(2):
        for k, g in flat(grad_r(state_r.params)).items():
            ill[k] = ill.get(k, False) | ((np.abs(g) < 1e-6) & (g != 0))
        state_r, loss_r = ref_training.train_step(cfg_r, opt_r, state_r, jnp.asarray(mel),
                                                  jnp.asarray(tokens), jnp.asarray(mask))
        state, loss = training.train_step(cfg, opt, state, *args)
        np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    assert state.step == int(state_r.step) == 2
    named = dict(model.named_parameters())
    adam = state_r.opt_state[0]
    moments = {n: state.opt_state[p] for n, p in named.items()}
    by_jax_path({n: m["exp_avg"] for n, m in moments.items()}, flat(adam.mu))
    by_jax_path({n: m["exp_avg_sq"] for n, m in moments.items()}, flat(adam.nu))
    assert all(int(m["step"]) == int(adam.count) == 2 for m in moments.values())
    want = flat(state_r.params)
    for name, p in named.items():
        path, layer = port_mesh.jax_path(name)
        pick = (lambda d: d[path]) if layer is None else (lambda d: d[path][layer])
        move_r, bad = pick(want) - pick(start), pick(ill)
        diff = np.abs(p.detach().numpy() - pick(start) - move_r)
        assert np.abs(move_r).max() > 0.5 * lr, name  # every leaf moved
        assert diff[~bad].max() <= 0.05 * lr, (name, diff[~bad].max())
        assert diff[bad].max(initial=0) <= 3 * lr, name


def test_adamw_update_is_optax():
    """``make_optimizer``'s AdamW fed the JAX gradients takes optax.adamw's
    steps: two steps' moments within 1e-6 of each leaf's largest value (fp32
    elementwise arithmetic in another order), the parameters within that
    plus 4e-5 lr: optax takes the bias corrections 1 - b^t in fp32, where
    1 - fp32(0.999) is 1.3e-5 off, torch in double."""
    import optax

    cfg_r, cfg = ref.config_for("test", jnp.float32), whisper.config_for("test", torch.float32)
    params = ref.init_params(cfg_r, jax.random.key(2))
    model = port_model(cfg, params)
    adamw = training.make_optimizer(model, 1e-3)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    opt_state = tx.init(params)
    rng = np.random.default_rng(3)
    named = dict(model.named_parameters())
    for _ in range(2):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype) *
                             10.0 ** rng.integers(-7, -1), params)
        flat_g = flat(grads)
        for name, p in named.items():
            path, layer = port_mesh.jax_path(name)
            p.grad = torch.from_numpy(np.array(flat_g[path] if layer is None
                                               else flat_g[path][layer]))
        adamw.step()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    for got, want, extra in (
            (named, params, 4e-5 * 1e-3),
            ({n: adamw.state[p]["exp_avg"] for n, p in named.items()}, opt_state[0].mu, 0.0),
            ({n: adamw.state[p]["exp_avg_sq"] for n, p in named.items()}, opt_state[0].nu, 0.0)):
        want = flat(want)
        for name, t in got.items():
            path, layer = port_mesh.jax_path(name)
            w = want[path] if layer is None else want[path][layer]
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max() + extra, err_msg=name)


def test_optimizer_is_optax_adamw():
    model = training.training_copy(whisper.init_params(whisper.config_for("test", torch.float32),
                                                       torch.Generator().manual_seed(0)))
    adamw = training.make_optimizer(model)
    assert isinstance(adamw, torch.optim.AdamW)
    group, = adamw.param_groups
    assert ((group["lr"], group["weight_decay"], group["betas"], group["eps"])
            == (1e-5, 0.01, (0.9, 0.999), 1e-8))
    assert not group["amsgrad"] and not group["maximize"]
    assert len(group["params"]) == len(list(model.parameters()))


def test_training_copy_turns_grads_on_and_refuses_int8():
    model = whisper.init_params(whisper.config_for("test", torch.float32),
                                torch.Generator().manual_seed(0))
    train = training.training_copy(model)
    assert all(p.requires_grad for p in train.parameters())
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="int8"):
        training.training_copy(quantize_params(model))
    with pytest.raises(ValueError, match="training_copy"):
        training.make_optimizer(model)


def test_decoder_without_cache_is_a_fresh_cache():
    """``decoder_apply(kv_cache=None)`` gives the logits of a fresh cache at
    position 0, and backward runs through it (through the in-place cache it
    raises: a later layer's write bumps the version of a saved view)."""
    cfg = whisper.config_for("test", torch.float32)
    model = training.training_copy(whisper.init_params(cfg, torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    xa = torch.randn(2, 16, cfg.n_audio_state, generator=g)
    tokens = torch.randint(0, 1000, (2, 8), generator=g)
    xa_kv = whisper.precompute_xa_kv(cfg, model, xa)
    got, cache = whisper.decoder_apply(cfg, model, tokens, 0, None, xa_kv)
    with torch.no_grad():
        want, _ = whisper.decoder_apply(cfg, model, tokens, 0,
                                        whisper.init_kv_cache(cfg, 2, 32), xa_kv)
    assert cache is None
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert model.decoder.blocks[0].attn.k.w.grad.abs().max() > 0
    logits, _ = whisper.decoder_apply(cfg, model, tokens, 0, whisper.init_kv_cache(cfg, 2, 32),
                                      whisper.precompute_xa_kv(cfg, model, xa))
    with pytest.raises(RuntimeError, match="inplace operation"):
        logits.sum().backward()


def test_flash_attention_function_backward():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 40, 16, generator=g, requires_grad=True) for _ in range(3))
    dout = torch.randn(2, 3, 40, 16, generator=g)
    got = torch.autograd.grad(FlashAttention.apply(q, k, v), (q, k, v), dout)
    want = torch.autograd.grad(attention_reference(q, k, v), (q, k, v), dout)
    for a, b in zip(got, want):
        close(a.numpy(), b.numpy(), "FlashAttention backward")
    q64, k64, v64 = (torch.randn(1, 2, 6, 4, generator=g, dtype=torch.float64,
                                 requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(FlashAttention.apply, (q64, k64, v64))


def test_mha_routes_grad_through_the_function():
    """With grad enabled the long attention goes through ``FlashAttention``;
    under ``inference_mode`` through ``flash_attention`` as before."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 512, 128, generator=g, requires_grad=True)
    out = whisper.mha(x, x, x, 2)
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in seen:
            seen.add(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
    assert "FlashAttentionBackward" in seen
    with torch.inference_mode():
        torch.testing.assert_close(whisper.mha(x.detach(), x.detach(), x.detach(), 2),
                                   out.detach())


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    cfg_r = ref.config_for("test-8h", jnp.float32)
    params = ref.init_params(cfg_r, jax.random.key(0))
    mel, tokens, mask = batch(cfg_r, 4, 96, seed=2)
    mask[:2, PROMPT:] = 1.0  # dp shard 0: every target counts
    mask[2:, PROMPT + 4:] = 0.0  # dp shard 1: four of them
    loss, grads = jax.jit(jax.value_and_grad(lambda p: ref_training.loss_fn(
        cfg_r, p, jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(mask))))(params)
    inputs = {f"p/{k}": v for k, v in flat(params).items()}
    inputs.update(cfg=np.array("test-8h"), mel=mel, tokens=tokens, loss_mask=mask)
    return float(loss), flat(grads), run("training", inputs, tmp_path_factory.mktemp("train"))


@pytest.mark.parametrize("shape", TRAINING_MESHES)
def test_sharded_grads_match_jax(sharded, shape):
    loss, want, workers = sharded
    dims = port_mesh.mesh_dims(shape, 4)
    assert not any(bool(w["imported_jax"]) for w in workers)
    for w in workers:
        np.testing.assert_allclose(float(w[f"loss/{shape}"]), loss, rtol=1e-5)
        tp = int(w[f"coords/{shape}"][1])

        def block(name, g):
            spec = port_mesh.spec_for_path(port_mesh.jax_path(name)[0], g.ndim)
            for dim, axis in enumerate(spec):
                if axis == "tp":
                    n = g.shape[dim] // dims["tp"]
                    g = np.take(g, np.arange(tp * n, (tp + 1) * n), axis=dim)
            return g

        prefix = f"grad/{shape}/"
        grads = {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}
        by_jax_path(grads, want, block)
