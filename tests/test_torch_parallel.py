"""The port's device mesh and shard plan (``parallel/``) against the JAX
package's ``parallel/``, on the CPU:

  * the mesh grammar (``parallel/mesh.mesh_dims``) against the JAX
    ``make_mesh(...).shape`` on the virtual 8-device mesh, "4x4" raising in
    both;
  * the shard plan against the JAX ``param_shardings``, path by path (the
    JAX specs without their leading layer axis), at float and int8 weights,
    and the KV placements against ``kv_cache_shardings``;
  * in four gloo processes (``tests/_torch_mesh_worker.py``, which imports no
    JAX), the fp32 ``test-8h`` model: the sharded ``encoder_apply`` on the
    meshes 2x2, 1x4 and 1x1x4 (sp) held to the JAX single-device
    ``encoder_apply`` at atol 2e-5 / rtol 1e-5 (``tests/test_parallel.py``'s
    tolerances); each rank's cross K/V equal to its block of the unsharded
    model's within 1e-5; the greedy ``decode_window`` over dp 2 x tp 2
    token-equal with the JAX package's single-device decode at float
    weights and at int8 weights with an int8 cross slab (average
    log-probabilities within 1e-4, as ``tests/test_parallel.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu import parallel as ref_parallel
from sentiric_stt_whisper_service_tpu.models import sampling as ref_sampling
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.ops import quant as ref_quant
from sentiric_stt_whisper_service_tpu.tokenizer import fallback_tokenizer as ref_tokenizer
from sentiric_stt_whisper_service_tpu_torch import parallel
from sentiric_stt_whisper_service_tpu_torch.models import whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy
from sentiric_stt_whisper_service_tpu_torch.ops import quant
from sentiric_stt_whisper_service_tpu_torch.parallel import mesh as port_mesh
from _torch_mesh_worker import ENCODER_MESHES, run
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test-8h", dtype=jnp.float32)
CFG = whisper.config_for("test-8h", dtype=torch.float32)
B, T_MEL = 4, 200  # tests/test_parallel.py's batch: 100 encoder positions, 25 per sp rank


def path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def flat(tree) -> dict:
    return {path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def params():
    return ref.init_params(CFG_R, jax.random.key(0))


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(0).standard_normal((B, T_MEL, CFG.n_mels)).astype(np.float32)


@pytest.fixture(scope="module")
def prompt():
    tok = ref_tokenizer(CFG.n_vocab)
    ids = ref_sampling.TokenIds.from_tokenizer(tok)
    sot = tok.sot_sequence("en")
    tinit = np.full((B, CFG.n_text_ctx), ids.eot, np.int32)
    tinit[:, : len(sot)] = sot
    return ids, tinit, len(sot), len(sot) + 12


@pytest.fixture(scope="module")
def workers(params, mel, prompt, tmp_path_factory):
    _, tinit, sb, max_len = prompt
    inputs = {f"p/{k}": np.asarray(v) for k, v in flat(params).items()}
    inputs.update(cfg=np.array("test-8h"), mel=mel, tinit=tinit, sample_begin=np.array(sb),
                  max_len=np.array(max_len))
    return run("parallel", inputs, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("shape", ["1", "4", "2x4", "auto", "2x2x2", "1x8", "4x4", "2x2x4"])
def test_mesh_shapes_match_jax(shape):
    try:
        want = dict(ref_parallel.make_mesh(shape).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match="needs .* devices, have 8"):
            port_mesh.mesh_dims(shape, 8)
        assert "have 8" in str(e)
        return
    assert port_mesh.mesh_dims(shape, 8) == want


def test_mesh_one_needs_no_process_group():
    mesh = parallel.make_mesh("1", device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.device_mesh is None
    assert mesh.group("tp") is None and mesh.index("dp") == 0
    model = whisper.init_params(CFG, torch.Generator().manual_seed(0))
    assert parallel.shard_params(mesh, model) is model  # no copy, no group
    assert model.mesh is None and all(m.tp_group is None for m in model.modules()
                                      if isinstance(m, whisper.Dense))


@pytest.mark.parametrize("form", ["float", "int8"])
def test_shard_plan_matches_jax(params, form):
    tree = ref_quant.quantize_params(params) if form == "int8" else params
    want = {p: tuple(s.spec) for p, s in flat(
        ref_parallel.param_shardings(ref_parallel.make_mesh("2x4"), tree)).items()}
    model = from_jax_numpy(jax.tree.map(np.asarray, tree), CFG, "cpu")
    got = parallel.param_shardings(parallel.make_mesh("1", device="cpu"), model)
    seen = set()
    for name, placement in got.items():
        path, layer = port_mesh.jax_path(name)
        spec = want[path][1:] if layer is not None and want[path] else want[path]
        assert placement.spec == spec, (name, placement.spec, want[path])
        seen.add(path)
    assert seen == set(want)
    split = {n for n, p in got.items() if p.spec}
    w = "w_q" if form == "int8" else "w"
    assert {f"encoder.blocks.0.attn.q.{w}", f"decoder.blocks.1.mlp_2.{w}"} <= split
    assert ("decoder.blocks.0.attn.q.scale" in split) == (form == "int8")


def test_kv_placements_match_jax():
    cache = {"k": torch.zeros(2, 4, 8, 32, 16), "k_scale": torch.zeros(2, 4, 8, 32)}
    jmesh = ref_parallel.make_mesh("2x4")
    want = ref_parallel.kv_cache_shardings(jmesh, {k: jnp.zeros(v.shape) for k, v in cache.items()})
    got = parallel.kv_cache_shardings(parallel.make_mesh("1", device="cpu"), cache)
    assert {k: p.spec for k, p in got.items()} == {k: tuple(s.spec) for k, s in want.items()}
    assert parallel.data_sharding(parallel.make_mesh("1", device="cpu"), 3).spec == tuple(
        ref_parallel.data_sharding(jmesh, 3).spec)


def test_a_shard_refuses_fusing_and_quantizing():
    model = whisper.init_params(CFG, torch.Generator().manual_seed(0))
    model.mesh = parallel.make_mesh("1", device="cpu")  # stands for a shard's mesh
    with pytest.raises(ValueError, match="tensor-parallel shard"):
        quant.fuse_decoder_qkv(model)
    with pytest.raises(ValueError, match="tensor-parallel shard"):
        quant.quantize_params(model)


def test_workers_import_no_jax(workers):
    assert not any(bool(w["imported_jax"]) for w in workers)


@pytest.mark.parametrize("shape", ENCODER_MESHES)
def test_sharded_encoder_matches_jax(params, mel, workers, shape):
    want = np.asarray(ref.encoder_apply(CFG_R, params, jnp.asarray(mel)))
    dims = port_mesh.mesh_dims(shape, 4)
    rows = B // dims["dp"]
    for w in workers:
        dp = int(w[f"coords/{shape}"][0])
        np.testing.assert_allclose(w[f"enc/{shape}"], want[dp * rows:(dp + 1) * rows],
                                   atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", ENCODER_MESHES)
def test_sharded_cross_kv_is_each_ranks_block(workers, shape):
    assert max(float(w[f"xa_err/{shape}"]) for w in workers) <= 1e-5


@pytest.mark.parametrize("form", ["float", "int8"])
def test_sharded_decode_matches_jax(params, mel, prompt, workers, form):
    ids, tinit, sb, max_len = prompt
    p = ref_quant.quantize_params(params) if form == "int8" else params
    xa = ref.precompute_xa_kv(CFG_R, p, ref.encoder_apply(CFG_R, p, jnp.asarray(mel)))
    if form == "int8":
        xa = ref_quant.quantize_xa_kv(xa)
    sup = jnp.asarray(ref_sampling.build_suppress_mask(CFG.n_vocab, ids, ()))
    want = ref_sampling.decode_window(CFG_R, p, xa, jnp.asarray(tinit), sb, 0, ids, sup,
                                      jnp.float32(0.0), jax.random.key(1), max_len=max_len)
    rows = B // 2
    for w in workers:
        dp = int(w["coords/decode"][0])
        sl = slice(dp * rows, (dp + 1) * rows)
        np.testing.assert_array_equal(w[f"lengths/{form}"], np.asarray(want.lengths)[sl])
        for r, n in enumerate(np.asarray(want.lengths)[sl]):
            np.testing.assert_array_equal(w[f"tokens/{form}"][r, :n],
                                          np.asarray(want.tokens)[sl][r, :n])
        np.testing.assert_allclose(w[f"avg_logprobs/{form}"],
                                   np.asarray(want.avg_logprobs)[sl], atol=1e-4)
