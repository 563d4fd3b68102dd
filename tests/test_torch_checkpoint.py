"""The port's checkpoint loaders against the JAX package's on files written
to ``tmp_path`` by the JAX package's writer (the oracle of
``tests/test_checkpoint.py``): GGML in f32 and f16, GGML with the 2-D
tensors in each quantized format (q4_0, q4_1, q5_0, q5_1, q8_0, q4_K, q5_K,
q6_K: seeded random blocks), and HF safetensors (f32, f16, and bf16 against
torch's rounding). Both loaders must give equal parameter trees (atol 1e-6,
fp32 loads of the same dequantized values), the port's writer must write
the same bytes, the three tokenizer constructors must give the JAX
package's ids, ``load_checkpoint`` must give the same model and tokenizer,
and the port's loaded model must decode token for token as the reference's
on the fp32 ``test`` config."""

import io
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu import checkpoint as ref_ckpt
from sentiric_stt_whisper_service_tpu.checkpoint import ggml as ref_ggml
from sentiric_stt_whisper_service_tpu.config import Settings as RefSettings
from sentiric_stt_whisper_service_tpu.models import sampling as ref_sampling
from sentiric_stt_whisper_service_tpu.models import whisper as ref
from sentiric_stt_whisper_service_tpu.tokenizer import WhisperTokenizer as RefTokenizer
from sentiric_stt_whisper_service_tpu_torch import checkpoint
from sentiric_stt_whisper_service_tpu_torch.checkpoint import ggml, safetensors_io
from sentiric_stt_whisper_service_tpu_torch.config import Settings
from sentiric_stt_whisper_service_tpu_torch.models import sampling, whisper
from sentiric_stt_whisper_service_tpu_torch.models.params import to_numpy_tree
from sentiric_stt_whisper_service_tpu_torch.tokenizer import WhisperTokenizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

CFG_R = ref.config_for("test", dtype=jnp.float32)
VOCAB = [f"tok{i}".encode() for i in range(300)]
# (ggml type, byte offsets of the fp16 scale fields in a block)
QUANT = {"q4_0": (2, (0,)), "q4_1": (3, (0, 2)), "q5_0": (6, (0,)), "q5_1": (7, (0, 2)),
         "q8_0": (8, (0,)), "q4_K": (12, (0, 2)), "q5_K": (13, (0, 2)), "q6_K": (14, (208,))}


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, ref.init_params(CFG_R, jax.random.key(3)))


def assert_same_tree(got: dict, want, atol=1e-6):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, atol=atol, err_msg=str(path))


def write_f32(path, params, ftype=0):
    with open(path, "wb") as f:
        ref_ggml.write_ggml(f, CFG_R, params, VOCAB, ftype=ftype)


def quantize_file(src, dst, ttype, scale_offsets, rng):
    """Rewrite ``src`` (an f32 GGML file) with every 2-D tensor whose size
    fills whole blocks in ``ttype``: seeded random blocks with sane fp16
    scales. Other tensors stay f32."""
    data = open(src, "rb").read()
    raw = ref_ggml.read_ggml(io.BytesIO(data))
    blk_elems, blk_bytes = ref_ggml._QUANT_BLOCKS[ttype]
    # the header ends where the first tensor record starts
    n_mel, n_fft = raw["mel_filters"].shape
    head = 4 + 44 + 8 + 4 * n_mel * n_fft + 4 + sum(4 + len(t) for t in raw["vocab_tokens"])
    out = bytearray(data[:head])
    for name, arr in raw["tensors"].items():
        ne = tuple(reversed(arr.shape))
        quant = arr.ndim == 2 and arr.size % blk_elems == 0
        if quant:
            blocks = rng.integers(0, 256, (arr.size // blk_elems, blk_bytes), dtype=np.uint8)
            for off in scale_offsets:
                d = rng.uniform(0.001, 0.02, blocks.shape[0]).astype("<f2")
                blocks[:, off:off + 2] = d.view(np.uint8).reshape(-1, 2)
            payload = blocks.tobytes()
        else:
            payload = np.asarray(arr, "<f4").tobytes()
        out += struct.pack("<3i", arr.ndim, len(name.encode()), ttype if quant else 0)
        out += struct.pack(f"<{arr.ndim}i", *ne) + name.encode() + payload
    open(dst, "wb").write(bytes(out))


@pytest.mark.parametrize("ftype", [0, 1], ids=["f32", "f16"])
def test_ggml_float_files_load_equal(params, tmp_path, ftype):
    path = tmp_path / "ggml-test.bin"
    write_f32(path, params, ftype)
    cfg_r, tree_r, vocab_r, n_r = ref_ggml.load_ggml(str(path), dtype=jnp.float32)
    cfg, model, vocab, n = ggml.load_ggml(str(path), dtype=torch.float32)
    assert (vocab, n) == (vocab_r, n_r)
    for field in ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
                  "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer"):
        assert getattr(cfg, field) == getattr(cfg_r, field)
    assert cfg.dtype == torch.float32 and model.cfg == cfg
    assert_same_tree(to_numpy_tree(model), tree_r)
    # the port's writer, given the loaded module, writes the same bytes
    buf = io.BytesIO()
    ggml.write_ggml(buf, cfg, model, VOCAB, ftype=ftype)
    assert buf.getvalue() == open(path, "rb").read()


@pytest.mark.parametrize("qname", list(QUANT))
def test_ggml_quantized_files_load_equal(params, tmp_path, qname):
    ttype, offsets = QUANT[qname]
    src, dst = tmp_path / "f32.bin", tmp_path / f"ggml-{qname}.bin"
    write_f32(src, params)
    quantize_file(src, dst, ttype, offsets, np.random.default_rng(ttype))
    _, tree_r, _, _ = ref_ggml.load_ggml(str(dst), dtype=jnp.float32)
    _, model, _, _ = ggml.load_ggml(str(dst), dtype=torch.float32)
    assert_same_tree(to_numpy_tree(model), tree_r)
    raw = ggml.read_ggml(open(dst, "rb"))
    assert any(not np.allclose(raw["tensors"][k], v) for k, v in
               ref_ggml.read_ggml(open(src, "rb"))["tensors"].items())  # really quantized


def hf_state(params) -> dict:
    """The HF naming of a parameter tree (the inverse mapping of
    ``tests/test_checkpoint.py::test_hf_safetensors_mapping``)."""
    state = {}
    enc, dec = params["encoder"], params["decoder"]

    def lin(name, p, bias=True):
        state[name + ".weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
        if bias:
            state[name + ".bias"] = np.asarray(p["b"])

    def ln(name, p):
        state[name + ".weight"], state[name + ".bias"] = np.asarray(p["g"]), np.asarray(p["b"])

    for c in ("conv1", "conv2"):
        state[f"model.encoder.{c}.weight"] = np.ascontiguousarray(
            np.asarray(enc[c]["w"]).transpose(2, 1, 0))
        state[f"model.encoder.{c}.bias"] = np.asarray(enc[c]["b"])
    state["model.encoder.embed_positions.weight"] = np.asarray(enc["pos"])
    state["model.decoder.embed_tokens.weight"] = np.asarray(dec["tok_emb"])
    state["model.decoder.embed_positions.weight"] = np.asarray(dec["pos_emb"])
    ln("model.encoder.layer_norm", enc["ln_post"])
    ln("model.decoder.layer_norm", dec["ln"])
    for side, blocks, n in (("encoder", enc["blocks"], CFG_R.n_audio_layer),
                            ("decoder", dec["blocks"], CFG_R.n_text_layer)):
        for i in range(n):
            blk = jax.tree.map(lambda x, i=i: np.asarray(x[i]), blocks)
            p = f"model.{side}.layers.{i}"
            groups = [("self_attn", "attn")] + (
                [("encoder_attn", "cross_attn")] if side == "decoder" else [])
            ln(p + ".self_attn_layer_norm", blk["attn_ln"])
            if side == "decoder":
                ln(p + ".encoder_attn_layer_norm", blk["cross_attn_ln"])
            for hf, ours in groups:
                lin(f"{p}.{hf}.q_proj", blk[ours]["q"])
                lin(f"{p}.{hf}.k_proj", blk[ours]["k"], bias=False)
                lin(f"{p}.{hf}.v_proj", blk[ours]["v"])
                lin(f"{p}.{hf}.out_proj", blk[ours]["o"])
            ln(p + ".final_layer_norm", blk["mlp_ln"])
            lin(p + ".fc1", blk["mlp_1"])
            lin(p + ".fc2", blk["mlp_2"])
    return state


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_safetensors_load_equal(params, tmp_path, dtype):
    from safetensors.numpy import save_file

    state = hf_state(params)
    path = tmp_path / "model.safetensors"
    if dtype == "bf16":
        from safetensors.torch import save_file as save_torch

        tensors = {k: torch.from_numpy(v.copy()).bfloat16() for k, v in state.items()}
        save_torch(tensors, str(path))
        want = {k: v.float().numpy() for k, v in tensors.items()}
        got = safetensors_io.read_safetensors(str(path))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        return
    save_file({k: v.astype(np.float16 if dtype == "f16" else np.float32)
               for k, v in state.items()}, str(path))
    cfg_r, tree_r = ref_ckpt.load_safetensors(str(path), jnp.float32)
    cfg, model = safetensors_io.load_safetensors(str(path), torch.float32)
    assert cfg.n_audio_state == cfg_r.n_audio_state and cfg.n_text_layer == cfg_r.n_text_layer
    assert_same_tree(to_numpy_tree(model), tree_r)


def write_vocab_files(tmp_path):
    """One rank table as a GGML vocab, an HF vocab.json and a *.tiktoken
    file: the 256 bytes, a few merges, then fillers up to the
    multilingual base vocab."""
    import base64

    from sentiric_stt_whisper_service_tpu_torch.tokenizer.bpe import _gpt2_byte_encoder

    ranks = [bytes([i]) for i in range(256)]
    ranks += [b"th", b"he", b" t", b"the", b" the", b"in", b"er", b" a", b"an", b"ing", b"\xc3\xbc"]
    i = len(ranks)
    while len(ranks) < 50257:
        ranks.append(b"\x00" + i.to_bytes(3, "big"))
        i += 1
    enc = _gpt2_byte_encoder()
    (tmp_path / "vocab.json").write_text(json.dumps(
        {"".join(enc[b] for b in tok): r for r, tok in enumerate(ranks)} | {"<|endoftext|>": 50256}))
    (tmp_path / "w.tiktoken").write_bytes(b"".join(
        base64.b64encode(tok) + b" " + str(r).encode() + b"\n" for r, tok in enumerate(ranks)))
    return ranks


def test_tokenizer_constructors_match(tmp_path):
    ranks = write_vocab_files(tmp_path)
    texts = ["the thing in the garden", " Über anthem", "interesting", "x" * 40, " the the"]
    pairs = [
        (WhisperTokenizer.from_ggml_vocab(ranks, 51865), RefTokenizer.from_ggml_vocab(ranks, 51865)),
        (WhisperTokenizer.from_hf_files(str(tmp_path / "vocab.json")),
         RefTokenizer.from_hf_files(str(tmp_path / "vocab.json"))),
        (WhisperTokenizer.from_tiktoken_file(str(tmp_path / "w.tiktoken")),
         RefTokenizer.from_tiktoken_file(str(tmp_path / "w.tiktoken"))),
    ]
    for mine, theirs in pairs:
        assert mine.n_vocab == theirs.n_vocab == 51865
        for text in texts:
            ids = theirs.encode(text)
            assert mine.encode(text) == ids, text
            assert mine.decode(ids) == theirs.decode(ids)
        assert mine.sot_sequence("en") == theirs.sot_sequence("en")
    with pytest.raises(ValueError, match="duplicate"):
        WhisperTokenizer.from_ggml_vocab([b"a"] * 50257, 51865)


def test_load_checkpoint_and_token_exact_decode(params, tmp_path):
    write_f32(tmp_path / "ggml-test.bin", params)
    model, tok = checkpoint.load_checkpoint(
        Settings(model_dir=str(tmp_path), model_filename="ggml-test.bin", dtype="float32"))
    tree_r, tok_r = ref_ckpt.load_checkpoint(
        RefSettings(model_dir=str(tmp_path), model_filename="ggml-test.bin", dtype="float32"))
    assert_same_tree(to_numpy_tree(model), tree_r)
    assert tok.encode(" tok7 tok12") == tok_r.encode(" tok7 tok12")
    assert tok.n_vocab == tok_r.n_vocab

    # decode token for token from the same mel (fp32 test config)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((1, 3000, CFG_R.n_mels)).astype(np.float32) * 0.5
    ids_r = ref_sampling.TokenIds.from_tokenizer(tok_r)
    sup_r = jnp.asarray(ref_sampling.build_suppress_mask(CFG_R.n_vocab, ids_r))
    sot = tok_r.sot_sequence("en")
    tinit = np.full((1, CFG_R.n_text_ctx), ids_r.eot, np.int32)
    tinit[:, :len(sot)] = sot
    want = ref_sampling.decode_window(
        CFG_R, tree_r, ref.encode_xa_kv(CFG_R, tree_r, jnp.asarray(mel)), jnp.asarray(tinit),
        len(sot), 0, ids_r, sup_r, jnp.float32(0.0), jax.random.key(0), max_len=len(sot) + 24)
    cfg = model.cfg
    ids = sampling.TokenIds.from_tokenizer(tok)
    assert vars(ids) == vars(ids_r)
    with torch.inference_mode():
        xa = whisper.encode_xa_kv(cfg, model, torch.from_numpy(mel))
        got = sampling.decode_window(
            cfg, model, xa, torch.from_numpy(tinit).long(), len(sot), 0, ids,
            torch.from_numpy(sampling.build_suppress_mask(cfg.n_vocab, ids)),
            max_len=len(sot) + 24)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def test_model_manager(tmp_path):
    from sentiric_stt_whisper_service_tpu.checkpoint.manager import ModelManager as RefManager
    from sentiric_stt_whisper_service_tpu_torch.checkpoint.manager import (
        MIN_VALID_SIZE,
        ModelManager,
    )

    for name in ("ggml-medium.bin", "ggml-large-v3.bin", "custom.bin", "ggml-x"):
        assert ModelManager.model_name_from_filename(name) == \
            RefManager.model_name_from_filename(name)
    present = tmp_path / "ggml-present.bin"
    present.write_bytes(b"\0" * MIN_VALID_SIZE)
    s = Settings(model_dir=str(tmp_path), model_filename="ggml-present.bin")
    assert ModelManager.ensure_model(s) == str(present)  # present and large enough: no download
