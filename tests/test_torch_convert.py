"""Checkpoint writing: the port's converter (``cli/convert.py``), its
safetensors writer (``checkpoint/safetensors_io.write_safetensors``) and
``checkpoint.save_params`` / ``restore_params``, against the JAX package's
converter and loaders on the fp32 ``test`` config.

HF safetensors → GGML writes the JAX package's converter's bytes, in f32
and f16, and both packages' loaders read it back to the same tree. GGML →
safetensors gives the JAX package's converter's tensors (its file is
written by the ``safetensors`` package), read by the port's reader, by
that package and by ``restore_params``. The writer's files load equal in
the port's reader and the ``safetensors`` package for every dtype the
reader takes; ``save_params`` / ``restore_params`` round-trip a module in
fp32 and bf16 (values, dtypes) and a dict of tensors, and a failed save
leaves the old file as it was."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.checkpoint import ggml as ref_ggml
from sentiric_stt_whisper_service_tpu.cli import convert as ref_convert
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu_torch import checkpoint
from sentiric_stt_whisper_service_tpu_torch.checkpoint import ggml, safetensors_io
from sentiric_stt_whisper_service_tpu_torch.cli import convert
from sentiric_stt_whisper_service_tpu_torch.models import whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import from_jax_numpy, to_numpy_tree
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_checkpoint import VOCAB, assert_same_tree, hf_state

CFG_R = ref.config_for("test", dtype=jnp.float32)
CFG = whisper.config_for("test", dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, ref.init_params(CFG_R, jax.random.key(5)))


@pytest.fixture
def hf_file(params, tmp_path):
    path = tmp_path / "model.safetensors"
    safetensors_io.write_safetensors(path, hf_state(params))
    return path


@pytest.mark.parametrize("ftype", ["f32", "f16"])
def test_hf_to_ggml_matches_reference(params, hf_file, tmp_path, ftype):
    mine, theirs = tmp_path / "mine.bin", tmp_path / "theirs.bin"
    assert convert.main([str(hf_file), str(mine), "--ftype", ftype]) == 0
    assert ref_convert.main([str(hf_file), str(theirs), "--ftype", ftype]) == 0
    assert mine.read_bytes() == theirs.read_bytes()
    atol = 1e-6 if ftype == "f32" else 2e-3  # f16 rounding of the 2-D weights
    _, model, _, _ = ggml.load_ggml(str(mine), torch.float32)
    _, tree_r, _, _ = ref_ggml.load_ggml(str(mine), jnp.float32)
    assert_same_tree(to_numpy_tree(model), params, atol=atol)
    assert_same_tree(to_numpy_tree(model), tree_r)


def test_ggml_to_safetensors_matches_reference(params, tmp_path):
    from safetensors.numpy import load_file

    src = tmp_path / "model.bin"
    with open(src, "wb") as f:
        ref_ggml.write_ggml(f, CFG_R, params, VOCAB, ftype=0)
    mine, theirs = tmp_path / "mine.safetensors", tmp_path / "theirs.safetensors"
    assert convert.main([str(src), str(mine)]) == 0
    assert ref_convert.main([str(src), str(theirs)]) == 0
    got, want = safetensors_io.read_safetensors(str(mine)), load_file(str(theirs))
    assert sorted(got) == sorted(want)
    library = load_file(str(mine))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        np.testing.assert_array_equal(library[name], want[name], err_msg=name)
    assert_same_tree(checkpoint.restore_params(str(mine)), params)
    model = checkpoint.restore_params(str(mine), like=from_jax_numpy(params, CFG, "cpu"))
    assert_same_tree(to_numpy_tree(model), params)


@pytest.mark.parametrize("pair", [("a.bin", "b.bin"), ("a.safetensors", "b.pt")])
def test_other_pairs_exit_2(tmp_path, pair):
    src, dst = (str(tmp_path / p) for p in pair)
    assert convert.main([src, dst]) == ref_convert.main([src, dst]) == 2


def test_writer_loads_in_both_readers(tmp_path):
    """Every dtype the port's reader takes, bf16 from a torch tensor, and
    metadata: equal in the port's reader and the safetensors package; the
    data starts 8-byte aligned and the tensors leave no gap."""
    from safetensors.torch import load_file

    rng = np.random.default_rng(0)
    tensors = {
        "f64": rng.standard_normal((2, 3)), "f32": rng.standard_normal(5).astype(np.float32),
        "f16": rng.standard_normal((3, 1)).astype(np.float16),
        "bf16": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16(),
        "i64": np.arange(3, dtype=np.int64), "i32": np.arange(-2, 5, dtype=np.int32),
        "i16": np.array([-7, 9], np.int16), "i8": np.array([-128, 0, 127], np.int8),
        "u8": np.array([0, 255, 3], np.uint8), "bool": np.array([True, False, True]),
        "nested.name.w": np.zeros((0, 4), np.float32),
    }
    path = tmp_path / "t.safetensors"
    safetensors_io.write_safetensors(path, tensors, metadata={"format": "test"})
    ours, theirs = safetensors_io.read_safetensors(str(path)), load_file(str(path))
    assert sorted(ours) == sorted(theirs) == sorted(tensors)
    for name, value in tensors.items():
        want = value.float().numpy() if name == "bf16" else value
        np.testing.assert_array_equal(ours[name], want, err_msg=name)
        lib = theirs[name].float() if name == "bf16" else theirs[name]
        np.testing.assert_array_equal(lib.numpy(), want, err_msg=name)
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8: 8 + n])
    assert n % 8 == 0 and header["__metadata__"] == {"format": "test"}
    spans = sorted(v["data_offsets"] for k, v in header.items() if k != "__metadata__")
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == len(raw) - 8 - n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_save_restore_params(params, tmp_path, dtype):
    cfg = whisper.config_for("test", dtype=dtype)
    model = from_jax_numpy(params, cfg, "cpu", dtype)
    path = tmp_path / "params.safetensors"
    checkpoint.save_params(str(path), model)
    back = checkpoint.restore_params(str(path), like=model)
    mine = dict(model.named_parameters()) | dict(model.named_buffers())
    got = dict(back.named_parameters()) | dict(back.named_buffers())
    assert mine.keys() == got.keys()
    for name, t in mine.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
    assert [p.name for p in tmp_path.iterdir()] == ["params.safetensors"]  # no temporary left
    assert_same_tree(checkpoint.restore_params(str(path)), to_numpy_tree(model), atol=0)


def test_save_restore_dict_and_failed_save(tmp_path):
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3).bfloat16(), "n": np.arange(4)},
            "b": torch.tensor([1, 2], dtype=torch.int32)}
    path = tmp_path / "tree.safetensors"
    checkpoint.save_params(str(path), tree)
    back = checkpoint.restore_params(str(path), like=tree)
    assert back["a"]["w"].dtype == torch.bfloat16 and torch.equal(back["a"]["w"], tree["a"]["w"])
    assert back["b"].dtype == torch.int32 and torch.equal(back["b"], tree["b"])
    np.testing.assert_array_equal(back["a"]["n"], tree["a"]["n"])
    before = path.read_bytes()
    with pytest.raises(ValueError, match="no dtype code"):
        checkpoint.save_params(str(path), {"z": np.zeros(2, np.complex64)})
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["tree.safetensors"]
