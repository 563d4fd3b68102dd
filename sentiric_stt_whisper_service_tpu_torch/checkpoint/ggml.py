"""GGML whisper.cpp checkpoint (.bin) loader and writer.

A copy of the JAX package's ``checkpoint/ggml.py``: the parsing and every
dequantizer are the same numpy; only the last step differs. Instead of a
JAX pytree, ``params_from_ggml`` builds the JAX package's parameter layout
with numpy leaves and hands it to ``models/params.from_jax_numpy``, which
fills a ``Whisper`` module on the requested device.

Format (whisper.cpp model loader):
  magic i32 0x67676d6c ("lmgg" on disk, little-endian)
  hparams: 11 × i32 (n_vocab, n_audio_ctx, n_audio_state, n_audio_head,
           n_audio_layer, n_text_ctx, n_text_state, n_text_head,
           n_text_layer, n_mels, ftype)
  mel filters: i32 n_mel, i32 n_fft, then n_mel*n_fft f32
  vocab: i32 n_vocab, then per token {i32 len, bytes}
  tensors until EOF: {i32 n_dims, i32 name_len, i32 ttype,
                      i32 ne[n_dims] (fastest-varying first),
                      name bytes, raw data}

Tensor dtypes: 0=f32, 1=f16, 2=q4_0, 3=q4_1, 6=q5_0, 7=q5_1, 8=q8_0,
plus the 256-element super-block k-quants 12=q4_K, 13=q5_K, 14=q6_K
(whisper.cpp's quantize tool emits these for the _S/_M presets).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np
import torch

from ..models.params import from_jax_numpy, stack_layers, to_numpy_tree
from ..models.whisper import Whisper, WhisperConfig

GGML_MAGIC = 0x67676D6C

# ggml type id → (block_elems, block_bytes)
_QUANT_BLOCKS = {
    0: (1, 4),  # f32
    1: (1, 2),  # f16
    2: (32, 18),  # q4_0: fp16 d + 16B
    3: (32, 20),  # q4_1: fp16 d, m + 16B
    6: (32, 22),  # q5_0: fp16 d + 4B qh + 16B
    7: (32, 24),  # q5_1: fp16 d, m + 4B qh + 16B
    8: (32, 34),  # q8_0: fp16 d + 32B
    12: (256, 144),  # q4_K: fp16 d, dmin + 12B packed scales + 128B qs
    13: (256, 176),  # q5_K: q4_K + 32B qh (5th bits)
    14: (256, 210),  # q6_K: 128B ql + 64B qh + 16 int8 scales + fp16 d
}


def _scale_min_k4(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack q4_K/q5_K's 12-byte scale block → (scales, mins) [N, 8],
    6-bit each (ggml get_scale_min_k4 semantics)."""
    sc = sc.astype(np.uint8)
    scales = np.empty(sc.shape[:-1] + (8,), np.float32)
    mins = np.empty_like(scales)
    for j in range(4):
        scales[..., j] = (sc[..., j] & 63).astype(np.float32)
        mins[..., j] = (sc[..., j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        scales[..., j] = (
            (sc[..., j + 4] & 0x0F) | ((sc[..., j - 4] >> 6) << 4)
        ).astype(np.float32)
        mins[..., j] = (
            (sc[..., j + 4] >> 4) | ((sc[..., j] >> 6) << 4)
        ).astype(np.float32)
    return scales, mins


def _dequantize_k(b: np.ndarray, ttype: int) -> np.ndarray:
    """Dequantize k-quant super-blocks. b: [N, block_bytes] uint8 →
    [N, 256] f32. Vectorized ports of ggml's dequantize_row_q{4,5,6}_K."""
    N = b.shape[0]
    if ttype in (12, 13):  # q4_K / q5_K
        d = b[:, :2].copy().view("<f2").astype(np.float32)  # [N,1]
        dmin = b[:, 2:4].copy().view("<f2").astype(np.float32)
        scales, mins = _scale_min_k4(b[:, 4:16])  # [N,8] each
        qs_off = 16 + (32 if ttype == 13 else 0)
        qs = b[:, qs_off : qs_off + 128]  # [N,128]
        # Element order: for each 64-chunk j (4 of them): 32 low nibbles
        # (scale group 2j), then 32 high nibbles (group 2j+1).
        q = qs.reshape(N, 4, 32)
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        vals = np.stack([lo, hi], axis=2)  # [N,4,2,32]
        if ttype == 13:
            qh = b[:, 16:48].reshape(N, 1, 32)  # [N,1,32], shared per block
            # 5th bit: u1 = 1 << (2j) for low nibbles, 1 << (2j+1) for high.
            shifts = np.arange(8, dtype=np.uint8).reshape(1, 4, 2, 1)
            fifth = ((qh[:, :, None, :] >> shifts) & 1).astype(np.float32)
            vals = vals + 16.0 * fifth
        sc = scales.reshape(N, 4, 2, 1)
        mn = mins.reshape(N, 4, 2, 1)
        y = d[:, :, None, None] * sc * vals - dmin[:, :, None, None] * mn
        return y.reshape(N, 256)
    if ttype == 14:  # q6_K
        ql = b[:, :128]
        qh = b[:, 128:192]
        sc = b[:, 192:208].view(np.int8).astype(np.float32)  # [N,16]
        d = b[:, 208:210].copy().view("<f2").astype(np.float32)  # [N,1]
        y = np.empty((N, 256), np.float32)
        # Two 128-element halves; within each: 4 interleaved 32-groups.
        for half in range(2):
            qlh = ql[:, half * 64 : (half + 1) * 64]
            qhh = qh[:, half * 32 : (half + 1) * 32]
            sch = sc[:, half * 8 : (half + 1) * 8]
            l = np.arange(32)
            q1 = (qlh[:, :32] & 0x0F) | (((qhh >> 0) & 3) << 4)
            q2 = (qlh[:, 32:] & 0x0F) | (((qhh >> 2) & 3) << 4)
            q3 = (qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)
            q4 = (qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)
            grp = l // 16  # scale index within [0,2): is = l/16
            base = half * 128
            for k, qv in enumerate((q1, q2, q3, q4)):
                scale = sch[:, grp + 2 * k]  # [N,32]
                y[:, base + 32 * k : base + 32 * (k + 1)] = (
                    d * scale * (qv.astype(np.float32) - 32.0)
                )
        return y
    raise ValueError(f"unsupported k-quant type {ttype}")


def _dequantize(raw: bytes, ttype: int, n_elems: int) -> np.ndarray:
    if ttype == 0:
        return np.frombuffer(raw, "<f4", count=n_elems).astype(np.float32)
    if ttype == 1:
        return np.frombuffer(raw, "<f2", count=n_elems).astype(np.float32)
    blk_elems, blk_bytes = _QUANT_BLOCKS[ttype]
    n_blocks = n_elems // blk_elems
    b = np.frombuffer(raw, np.uint8, count=n_blocks * blk_bytes).reshape(
        n_blocks, blk_bytes
    )
    if ttype == 2:  # q4_0
        d = b[:, :2].copy().view("<f2").astype(np.float32)  # [N,1]
        q = b[:, 2:18]
        lo = (q & 0x0F).astype(np.int8)
        hi = (q >> 4).astype(np.int8)
        x = np.concatenate([lo, hi], axis=1).astype(np.float32) - 8.0
        return (x * d).reshape(-1)
    if ttype == 3:  # q4_1
        d = b[:, :2].copy().view("<f2").astype(np.float32)
        m = b[:, 2:4].copy().view("<f2").astype(np.float32)
        q = b[:, 4:20]
        lo = (q & 0x0F).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        x = np.concatenate([lo, hi], axis=1)
        return (x * d + m).reshape(-1)
    if ttype in (6, 7):  # q5_0 / q5_1
        off = 2 if ttype == 6 else 4
        d = b[:, :2].copy().view("<f2").astype(np.float32)
        m = (
            b[:, 2:4].copy().view("<f2").astype(np.float32)
            if ttype == 7
            else None
        )
        qh = b[:, off : off + 4].copy().view("<u4").reshape(-1)  # [N]
        q = b[:, off + 4 : off + 20]
        lo = (q & 0x0F).astype(np.uint8)
        hi = (q >> 4).astype(np.uint8)
        bits = (qh[:, None] >> np.arange(32)[None, :]) & 1  # [N, 32]
        nibs = np.concatenate([lo, hi], axis=1)  # [N, 32]
        x = (nibs | (bits << 4).astype(np.uint8)).astype(np.float32)
        if ttype == 6:
            return ((x - 16.0) * d).reshape(-1)
        return (x * d + m).reshape(-1)
    if ttype == 8:  # q8_0
        d = b[:, :2].copy().view("<f2").astype(np.float32)
        q = b[:, 2:34].view(np.int8).astype(np.float32)
        return (q * d).reshape(-1)
    if ttype in (12, 13, 14):  # k-quants
        return _dequantize_k(b, ttype).reshape(-1)
    raise ValueError(f"unsupported ggml tensor type {ttype}")


def read_ggml(f: BinaryIO) -> dict[str, Any]:
    """Parse a whisper.cpp GGML file → raw dict {hparams, mel_filters,
    vocab_tokens, tensors{name: np.ndarray}}."""
    magic = struct.unpack("<i", f.read(4))[0]
    if magic != GGML_MAGIC:
        raise ValueError(f"bad GGML magic: {magic:#x}")
    keys = (
        "n_vocab n_audio_ctx n_audio_state n_audio_head n_audio_layer "
        "n_text_ctx n_text_state n_text_head n_text_layer n_mels ftype"
    ).split()
    hparams = dict(zip(keys, struct.unpack("<11i", f.read(44))))

    n_mel, n_fft = struct.unpack("<2i", f.read(8))
    mel_filters = np.frombuffer(f.read(4 * n_mel * n_fft), "<f4").reshape(
        n_mel, n_fft
    )

    n_vocab_file = struct.unpack("<i", f.read(4))[0]
    vocab = []
    for _ in range(n_vocab_file):
        ln = struct.unpack("<i", f.read(4))[0]
        vocab.append(f.read(ln))

    tensors: dict[str, np.ndarray] = {}
    while True:
        head = f.read(12)
        if len(head) < 12:
            break
        n_dims, name_len, ttype = struct.unpack("<3i", head)
        ne = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
        name = f.read(name_len).decode("utf-8")
        n_elems = int(np.prod(ne))
        blk_elems, blk_bytes = _QUANT_BLOCKS[ttype]
        nbytes = (n_elems // blk_elems) * blk_bytes
        data = _dequantize(f.read(nbytes), ttype, n_elems)
        # ggml ne is fastest-first → numpy shape is reversed.
        tensors[name] = data.reshape(tuple(reversed(ne)))
    return {
        "hparams": hparams,
        "mel_filters": mel_filters,
        "vocab_tokens": vocab,
        "tensors": tensors,
    }


def config_from_hparams(hp: dict, dtype=torch.bfloat16) -> WhisperConfig:
    return WhisperConfig(
        n_mels=hp["n_mels"],
        n_vocab=hp["n_vocab"],
        n_audio_ctx=hp["n_audio_ctx"],
        n_audio_state=hp["n_audio_state"],
        n_audio_head=hp["n_audio_head"],
        n_audio_layer=hp["n_audio_layer"],
        n_text_ctx=hp["n_text_ctx"],
        n_text_state=hp["n_text_state"],
        n_text_head=hp["n_text_head"],
        n_text_layer=hp["n_text_layer"],
        dtype=dtype,
    )


def tree_from_ggml(raw: dict) -> dict:
    """Map whisper.cpp tensor names into the JAX package's parameter layout,
    with fp32 numpy leaves."""
    hp = raw["hparams"]
    t = raw["tensors"]
    f32 = np.float32

    def lin(prefix, bias=True):
        # torch Linear [out, in] → dense w [in, out]
        p = {"w": np.asarray(t[prefix + ".weight"].T, f32)}
        if bias:
            p["b"] = np.asarray(t[prefix + ".bias"], f32)
        return p

    def ln(prefix):
        return {
            "g": np.asarray(t[prefix + ".weight"], f32),
            "b": np.asarray(t[prefix + ".bias"], f32),
        }

    def attn(prefix):
        return {
            "q": lin(prefix + ".query"),
            "k": lin(prefix + ".key", bias=False),
            "v": lin(prefix + ".value"),
            "o": lin(prefix + ".out"),
        }

    enc_blocks = []
    for i in range(hp["n_audio_layer"]):
        p = f"encoder.blocks.{i}"
        enc_blocks.append(
            {
                "attn_ln": ln(p + ".attn_ln"),
                "attn": attn(p + ".attn"),
                "mlp_ln": ln(p + ".mlp_ln"),
                "mlp_1": lin(p + ".mlp.0"),
                "mlp_2": lin(p + ".mlp.2"),
            }
        )
    dec_blocks = []
    for i in range(hp["n_text_layer"]):
        p = f"decoder.blocks.{i}"
        dec_blocks.append(
            {
                "attn_ln": ln(p + ".attn_ln"),
                "attn": attn(p + ".attn"),
                "cross_attn_ln": ln(p + ".cross_attn_ln"),
                "cross_attn": attn(p + ".cross_attn"),
                "mlp_ln": ln(p + ".mlp_ln"),
                "mlp_1": lin(p + ".mlp.0"),
                "mlp_2": lin(p + ".mlp.2"),
            }
        )

    # torch conv1d weight [out, in, k] → TIO [k, in, out]
    def conv(prefix):
        return {
            "w": np.asarray(t[prefix + ".weight"].transpose(2, 1, 0), f32),
            "b": np.asarray(t[prefix + ".bias"], f32),
        }

    params = {
        "encoder": {
            "conv1": conv("encoder.conv1"),
            "conv2": conv("encoder.conv2"),
            "pos": np.asarray(t["encoder.positional_embedding"], f32),
            "blocks": stack_layers(enc_blocks),
            "ln_post": ln("encoder.ln_post"),
        },
        "decoder": {
            "tok_emb": np.asarray(t["decoder.token_embedding.weight"], f32),
            "pos_emb": np.asarray(t["decoder.positional_embedding"], f32),
            "blocks": stack_layers(dec_blocks),
            "ln": ln("decoder.ln"),
        },
    }
    return params


def params_from_ggml(raw: dict, dtype=torch.bfloat16, device="cpu") -> tuple[WhisperConfig, Whisper]:
    """A parsed GGML file → (config, ``Whisper`` on ``device`` in ``dtype``)."""
    cfg = config_from_hparams(raw["hparams"], dtype)
    return cfg, from_jax_numpy(tree_from_ggml(raw), cfg, device, dtype)


def load_ggml(path: str, dtype=torch.bfloat16, device="cpu"):
    """Load a whisper.cpp .bin → (config, model, vocab_tokens, n_vocab)."""
    with open(path, "rb") as f:
        raw = read_ggml(f)
    cfg, model = params_from_ggml(raw, dtype, device)
    return cfg, model, raw["vocab_tokens"], raw["hparams"]["n_vocab"]


# ---------------------------------------------------------------------------
# Writer (tests + conversion tooling)
# ---------------------------------------------------------------------------


def write_ggml(
    f: BinaryIO,
    cfg: WhisperConfig,
    model: Whisper,
    vocab_tokens: list[bytes],
    mel_filters: np.ndarray | None = None,
    ftype: int = 0,
):
    """Write a whisper.cpp-compatible GGML file (f32 or f16 tensors) from
    an unquantized, unfused ``Whisper`` module."""
    params = to_numpy_tree(model)
    f.write(struct.pack("<i", GGML_MAGIC))
    f.write(
        struct.pack(
            "<11i",
            cfg.n_vocab, cfg.n_audio_ctx, cfg.n_audio_state, cfg.n_audio_head,
            cfg.n_audio_layer, cfg.n_text_ctx, cfg.n_text_state,
            cfg.n_text_head, cfg.n_text_layer, cfg.n_mels, ftype,
        )
    )
    if mel_filters is None:
        from ..ops.mel import mel_filterbank

        mel_filters = mel_filterbank(cfg.n_mels)
    f.write(struct.pack("<2i", mel_filters.shape[0], mel_filters.shape[1]))
    f.write(np.asarray(mel_filters, "<f4").tobytes())
    f.write(struct.pack("<i", len(vocab_tokens)))
    for tok in vocab_tokens:
        f.write(struct.pack("<i", len(tok)))
        f.write(tok)

    def emit(name: str, arr: np.ndarray):
        arr = np.asarray(arr, np.float32)
        ttype = ftype
        data = arr.astype("<f2" if ftype == 1 else "<f4")
        ne = tuple(reversed(arr.shape))
        f.write(struct.pack("<3i", arr.ndim, len(name.encode()), ttype))
        f.write(struct.pack(f"<{arr.ndim}i", *ne))
        f.write(name.encode())
        f.write(data.tobytes())

    enc, dec = params["encoder"], params["decoder"]
    for cname in ("conv1", "conv2"):
        emit(f"encoder.{cname}.weight", np.asarray(enc[cname]["w"]).transpose(2, 1, 0))
        emit(f"encoder.{cname}.bias", enc[cname]["b"])
    emit("encoder.positional_embedding", enc["pos"])
    emit("decoder.token_embedding.weight", dec["tok_emb"])
    emit("decoder.positional_embedding", dec["pos_emb"])

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else np.asarray(v[i])
                for k, v in tree.items()}

    def emit_blocks(side: str, blocks: dict, n_layers: int, cross: bool):
        unstacked = [layer(blocks, i) for i in range(n_layers)]
        for i, blk in enumerate(unstacked):
            p = f"{side}.blocks.{i}"
            groups = [("attn", "attn", "attn_ln")]
            if cross:
                groups.append(("cross_attn", "cross_attn", "cross_attn_ln"))
            for gname, gkey, lnkey in groups:
                emit(f"{p}.{lnkey}.weight", blk[lnkey]["g"])
                emit(f"{p}.{lnkey}.bias", blk[lnkey]["b"])
                a = blk[gkey]
                emit(f"{p}.{gname}.query.weight", np.asarray(a["q"]["w"]).T)
                emit(f"{p}.{gname}.query.bias", a["q"]["b"])
                emit(f"{p}.{gname}.key.weight", np.asarray(a["k"]["w"]).T)
                emit(f"{p}.{gname}.value.weight", np.asarray(a["v"]["w"]).T)
                emit(f"{p}.{gname}.value.bias", a["v"]["b"])
                emit(f"{p}.{gname}.out.weight", np.asarray(a["o"]["w"]).T)
                emit(f"{p}.{gname}.out.bias", a["o"]["b"])
            emit(f"{p}.mlp_ln.weight", blk["mlp_ln"]["g"])
            emit(f"{p}.mlp_ln.bias", blk["mlp_ln"]["b"])
            emit(f"{p}.mlp.0.weight", np.asarray(blk["mlp_1"]["w"]).T)
            emit(f"{p}.mlp.0.bias", blk["mlp_1"]["b"])
            emit(f"{p}.mlp.2.weight", np.asarray(blk["mlp_2"]["w"]).T)
            emit(f"{p}.mlp.2.bias", blk["mlp_2"]["b"])

    emit_blocks("encoder", enc["blocks"], cfg.n_audio_layer, cross=False)
    emit_blocks("decoder", dec["blocks"], cfg.n_text_layer, cross=True)
    emit("encoder.ln_post.weight", enc["ln_post"]["g"])
    emit("encoder.ln_post.bias", enc["ln_post"]["b"])
    emit("decoder.ln.weight", dec["ln"]["g"])
    emit("decoder.ln.bias", dec["ln"]["b"])
