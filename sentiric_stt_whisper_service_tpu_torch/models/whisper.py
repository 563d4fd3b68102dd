"""Whisper encoder–decoder in PyTorch, held against the JAX package's
``models/whisper.py``.

Parameters live in ``nn.Module``s (``Whisper`` → ``WhisperEncoder`` /
``WhisperDecoder`` → one block per layer in an ``nn.ModuleList``); the
forward passes are plain functions on tensors, named as in the JAX package.
Weights are built ``requires_grad=False`` and the serving callers run under
``torch.inference_mode()``; training (``runtime/training.py``) turns the
gradients on for a copy and runs ``encoder_apply``, ``precompute_xa_kv`` and
``decoder_apply`` without a cache (``kv_cache=None``) under autograd.

Tensor parallelism (``parallel/mesh.shard_params``): a shard holds
``n_head / tp`` heads of each attention, and the forward passes read the
head count from its width. Each split ``Dense`` carries its tp group:
a column-parallel layer's input passes Megatron's f (identity forward,
all-reduce backward), a row-parallel layer's partial product g (all-reduce
forward, identity backward) before its bias. On an "sp" mesh the encoder
holds T/sp rows of its residual stream and all-gathers K and V. A model
without a mesh runs no collective.

Layouts follow the JAX package so the tests compare like with like: dense
weights ``[d_in, d_out]``, conv weights ``[K, C_in, C_out]``, the self-KV
cache position-major ``[L, B, H, C, hd]`` and the cross slab "KF"
``[L, B, H, hd, 1500]``. The self cache is updated in place (the JAX
package returns a new one); the head-paired cache layout of the JAX package
is a TPU lane workaround and is not ported.

Kernels on this path, on CUDA tensors: the encoder's unmasked attention
(``ops/flash_attention``, K2), the greedy decode step's cross read
(``ops/decode_attention``: K4 on the int4 carrier, K3 on int8 or bf16
slabs) and the beam decode step's self and cross reads
(``ops/beam_attention``: K5 over the ancestry-masked slot caches, K6 over
the shared cross slab in its three forms), and the int8 dense products and
tied logits of at most ``dense_w8.M_MAX`` rows (``ops/dense_w8``, W8). The
convolutions and the other dense products are plain ``conv1d`` and
``matmul``, as the JAX package leaves them to XLA. With an fp32 model on
CUDA set ``torch.backends.cudnn.allow_tf32 = False`` (cuDNN's default is
True) and keep ``torch.backends.cuda.matmul.allow_tf32`` False (the
default), or the products round to TF32.

Numerics: fp32 layer-norm statistics and softmax. An int8 product of at
most ``dense_w8.M_MAX`` rows keeps its sum in fp32 through the per-channel
scale and rounds once, as the JAX package does; a larger one (the encoder,
the cross K/V) is rounded to bf16 before its scale. The tied logits are
computed in fp32 as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..ops import dense_w8
from ..ops.beam_attention import (
    beam_attention,
    beam_cross_attention,
    beam_cross_attention_i4,
    beam_cross_attention_reference,
)
from ..ops.decode_attention import decode_attention, decode_attention_i4
from ..ops.flash_attention import FlashAttention, flash_attention
from ..ops.quant import unpack_xa_kv
from ..parallel.mesh import gather_seq, seq_constraint

NEG = -1e30  # the JAX package's mask value


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return 100 if self.n_vocab == 51866 else 99


# Official whisper model family dims.
_PRESETS = {
    "tiny": dict(n_audio_state=384, n_audio_head=6, n_audio_layer=4,
                 n_text_state=384, n_text_head=6, n_text_layer=4),
    "base": dict(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                 n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": dict(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                  n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": dict(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                   n_text_state=1024, n_text_head=16, n_text_layer=24),
    "large": dict(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                  n_text_state=1280, n_text_head=20, n_text_layer=32),
}


def config_for(name: str, dtype=torch.bfloat16) -> WhisperConfig:
    """Config by model name: tiny(.en), base(.en), small(.en), medium(.en),
    large-v1/v2/v3, large-v3-turbo, the distil-whisper family
    (distil-large-v2/v3, distil-medium.en, distil-small.en — full-size
    encoder, shallow decoder), plus 'test' and 'test-8h' (mini models for
    CI)."""
    if name.startswith("distil-"):
        base_name = name[len("distil-"):]
        english = base_name.endswith(".en")
        if english:
            base_name = base_name[:-3]
        if base_name.startswith("large"):
            dims = dict(_PRESETS["large"])
            n_mels = 128 if base_name == "large-v3" else 80
            n_vocab = 51866 if base_name == "large-v3" else 51865
        else:
            dims = dict(_PRESETS[base_name])
            n_mels, n_vocab = 80, 51864 if english else 51865
        # distil-small.en keeps 4 decoder layers; the rest distil to 2.
        dims["n_text_layer"] = 4 if base_name == "small" else 2
        return WhisperConfig(n_mels=n_mels, n_vocab=n_vocab, dtype=dtype, **dims)
    if name == "test":
        return WhisperConfig(
            n_mels=80, n_vocab=51865, n_audio_ctx=1500,
            n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2,
            dtype=dtype,
        )
    if name == "test-8h":
        return WhisperConfig(
            n_mels=80, n_vocab=51865, n_audio_ctx=1500,
            n_audio_state=128, n_audio_head=8, n_audio_layer=2,
            n_text_ctx=448, n_text_state=128, n_text_head=8, n_text_layer=2,
            dtype=dtype,
        )
    english = name.endswith(".en")
    base_name = name[:-3] if english else name
    if base_name.startswith("large"):
        dims = dict(_PRESETS["large"])
        if base_name in ("large-v3", "large-v3-turbo", "turbo"):
            n_mels, n_vocab = 128, 51866
        else:
            n_mels, n_vocab = 80, 51865
        if base_name in ("large-v3-turbo", "turbo"):
            dims["n_text_layer"] = 4
        return WhisperConfig(n_mels=n_mels, n_vocab=n_vocab, dtype=dtype, **dims)
    dims = _PRESETS[base_name]
    return WhisperConfig(
        n_mels=80,
        n_vocab=51864 if english else 51865,
        dtype=dtype,
        **dims,
    )


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position embedding for the encoder."""
    if channels % 2:
        raise ValueError(f"sinusoids need an even channel count, got {channels}")
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class _Init:
    """Draws the initial weights: normal(0, std) from ``generator`` in fp32,
    cast to ``dtype``; without a generator, uninitialised storage for a
    caller that fills it (``models/params.from_jax_numpy``)."""

    def __init__(self, dtype, device, generator: Optional[torch.Generator]):
        self.dtype, self.device, self.generator = dtype, device, generator

    def normal(self, shape, std: float) -> torch.Tensor:
        if self.generator is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, device=self.device)
        return (x * std).to(self.dtype)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)


class Dense(nn.Module):
    """``x @ w + b``, or weight-only int8: ``w_q`` int8 [d_in, d_out] with a
    per-output-channel fp32 ``scale`` (ops/quant.py). On a tensor-parallel
    shard ``tp_role`` is "column" or "row" and ``tp_group`` the group its
    partial products are reduced over (``parallel/mesh.shard_params``)."""

    def __init__(self, w=None, b=None, w_q=None, scale=None):
        super().__init__()
        self.assign(w=w, b=b, w_q=w_q, scale=scale)
        self.tp_group = None
        self.tp_role: Optional[str] = None

    @classmethod
    def init(cls, ini: _Init, d_in: int, d_out: int, bias: bool = True) -> "Dense":
        w = ini.normal((d_in, d_out), 1.0 / math.sqrt(d_in))
        return cls(w=w, b=ini.full((d_out,), 0.0) if bias else None)

    def assign(self, w=None, b=None, w_q=None, scale=None) -> None:
        self.register_parameter("w", _param(w))
        self.register_parameter("b", _param(b))
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)

    def set_quantized(self, w_q: torch.Tensor, scale: torch.Tensor) -> None:
        self.assign(w_q=w_q, scale=scale, b=self.b)


class LayerNorm(nn.Module):
    def __init__(self, ini: _Init, d: int):
        super().__init__()
        self.g = _param(ini.full((d,), 1.0))
        self.b = _param(ini.full((d,), 0.0))


class Attention(nn.Module):
    """q/k/v/o projections; after ``ops/quant.fuse_decoder_qkv`` the self
    attention of a decoder block holds ``qkv`` and ``o`` only."""

    def __init__(self, ini: _Init, d: int):
        super().__init__()
        self.q = Dense.init(ini, d, d)
        self.k = Dense.init(ini, d, d, bias=False)
        self.v = Dense.init(ini, d, d)
        self.o = Dense.init(ini, d, d)
        self.qkv: Optional[Dense] = None


class EncoderBlock(nn.Module):
    def __init__(self, ini: _Init, d: int):
        super().__init__()
        self.attn_ln = LayerNorm(ini, d)
        self.attn = Attention(ini, d)
        self.mlp_ln = LayerNorm(ini, d)
        self.mlp_1 = Dense.init(ini, d, 4 * d)
        self.mlp_2 = Dense.init(ini, 4 * d, d)


class DecoderBlock(nn.Module):
    def __init__(self, ini: _Init, d: int):
        super().__init__()
        self.attn_ln = LayerNorm(ini, d)
        self.attn = Attention(ini, d)
        self.cross_attn_ln = LayerNorm(ini, d)
        self.cross_attn = Attention(ini, d)
        self.mlp_ln = LayerNorm(ini, d)
        self.mlp_1 = Dense.init(ini, d, 4 * d)
        self.mlp_2 = Dense.init(ini, 4 * d, d)


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, ini: _Init):
        super().__init__()
        d = cfg.n_audio_state
        self.conv1_w = _param(ini.normal((3, cfg.n_mels, d), 1.0 / math.sqrt(3 * cfg.n_mels)))
        self.conv1_b = _param(ini.full((d,), 0.0))
        self.conv2_w = _param(ini.normal((3, d, d), 1.0 / math.sqrt(3 * d)))
        self.conv2_b = _param(ini.full((d,), 0.0))
        pos = torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)).to(ini.device, cfg.dtype)
        self.register_buffer("pos", pos)
        self.blocks = nn.ModuleList(EncoderBlock(ini, d) for _ in range(cfg.n_audio_layer))
        self.ln_post = LayerNorm(ini, d)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, ini: _Init):
        super().__init__()
        d = cfg.n_text_state
        self.tok_emb = _param(ini.normal((cfg.n_vocab, d), 0.02))
        self.register_buffer("tok_emb_q", None)
        self.register_buffer("tok_emb_scale", None)
        self.pos_emb = _param(ini.normal((cfg.n_text_ctx, d), 0.01))
        self.blocks = nn.ModuleList(DecoderBlock(ini, d) for _ in range(cfg.n_text_layer))
        self.ln = LayerNorm(ini, d)

    def set_quantized_embedding(self, emb_q: torch.Tensor, emb_scale: torch.Tensor) -> None:
        self.tok_emb = None
        self.tok_emb_q = emb_q
        self.tok_emb_scale = emb_scale


class Whisper(nn.Module):
    def __init__(self, cfg: WhisperConfig, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        ini = _Init(cfg.dtype, torch.device(device), generator)
        self.encoder = WhisperEncoder(cfg, ini)
        self.decoder = WhisperDecoder(cfg, ini)
        self.mesh = None  # parallel/mesh.Mesh on a shard


def init_params(cfg: WhisperConfig, generator: torch.Generator) -> Whisper:
    """Random-init parameters with the real Whisper shapes and the JAX
    package's init scales, drawn from ``generator`` on its device."""
    return Whisper(cfg, generator.device, generator)


def param_count(model: Whisper) -> int:
    return sum(t.numel() for t in list(model.parameters()) + list(model.buffers()))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def layer_norm(x, p: LayerNorm, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p.g.float() + p.b.float()).to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    """Megatron's f, at a column-parallel layer's input: identity forward;
    backward, the gradient all-reduced over the tp group (each rank's
    columns give a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g, after a row-parallel layer's product: the partial sums
    all-reduced forward; identity backward (every rank already holds the
    whole gradient). ``torch.distributed.nn.functional.all_reduce`` would
    reduce the gradient as well and multiply it by tp."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def dense(x, p: Dense):
    """Dense layer; dispatches on weight-only int8 (``w_q``). On a
    tensor-parallel shard a column-parallel layer's input passes f, a
    row-parallel layer's product g, and its bias is added once, after.

    An int8 product of at most ``dense_w8.M_MAX`` rows goes to
    ``ops/dense_w8`` (W8 on a CUDA tensor, with the bias in its epilogue
    unless the layer is row-parallel); a larger one (the encoder, the cross
    K/V) casts the weight and runs ``torch.matmul``, counted as
    ``dense.cast``."""
    if p.tp_group is not None and p.tp_role == "column":
        x = _CopyToTP.apply(x, p.tp_group)
    row = p.tp_group is not None and p.tp_role == "row"
    if p.w_q is not None and dense_w8.serves(x) and not row:
        return dense_w8.dense_w8(x, p.w_q, p.scale, p.b)
    if p.w_q is None:
        y = torch.matmul(x, p.w)
    elif dense_w8.serves(x):
        y = dense_w8.dense_w8(x, p.w_q, p.scale)
    else:
        tracing.count("dense.cast", rows=dense_w8.rows(x))
        y = torch.matmul(x, p.w_q.to(x.dtype))
        y = (y.float() * p.scale).to(x.dtype)
    if row:
        y = _ReduceFromTP.apply(y, p.tp_group)
    if p.b is not None:
        y = y + p.b
    return y


def embed_tokens(dec: WhisperDecoder, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather, int8-aware (per-row scales; fp32 out)."""
    if dec.tok_emb_q is not None:
        return dec.tok_emb_q[tokens].float() * dec.tok_emb_scale[tokens][..., None]
    return dec.tok_emb[tokens]


def tied_logits(x: torch.Tensor, dec: WhisperDecoder) -> torch.Tensor:
    """Logits against the (possibly int8) tied token embedding, fp32:
    x [..., T, d] → [..., T, V]. The int8 embedding goes to
    ``ops/dense_w8.logits_w8`` at most ``dense_w8.M_MAX`` rows (W8 on a CUDA
    tensor), else is cast to fp32 (counted as ``dense.cast``)."""
    if dec.tok_emb_q is not None:
        if dense_w8.serves(x):
            return dense_w8.logits_w8(x, dec.tok_emb_q, dec.tok_emb_scale)
        tracing.count("dense.cast", rows=dense_w8.rows(x))
        return torch.matmul(x.float(), dec.tok_emb_q.float().T) * dec.tok_emb_scale
    return torch.matmul(x.float(), dec.tok_emb.float().T)


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def _attend(q, k, v, mask=None):
    """Head-major attention core. q [B,H,T,c]; k,v [B,H,K,c]; fp32 scores
    and softmax. An fp8 KV slab converts to q's dtype first, as in the JAX
    package. Returns out in q's dtype."""
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
    if v.dtype != q.dtype:
        v = v.to(q.dtype)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))  # [B,H,T,K]
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), v.float())  # [B,H,T,c]
    return out.to(v.dtype)


def mha(q, k, v, n_head: int):
    """Unmasked multi-head attention, q [B, T, d], k, v [B, S, d], with
    (d_head)^-0.25 on both q and k.

    Long sequences go to ``ops/flash_attention``: K2 on a CUDA tensor, its
    plain version on a CPU tensor; with grad enabled through
    ``FlashAttention`` (K2 forward, plain backward). The test reads the
    global length S, as the JAX package's ``mha`` reads its global T: the
    encoder's 1500 positions (S = T on one device; T = S / sp query rows on a
    rank of an "sp" mesh, against the S gathered keys)."""
    b, t, d = q.shape
    scale = (d // n_head) ** -0.25

    def to_heads(x):
        return _split_heads(x, n_head).transpose(1, 2)

    qh, kh, vh = to_heads(q) * scale, to_heads(k) * scale, to_heads(v)
    if k.shape[1] >= 512:
        qkv = (qh.contiguous(), kh.contiguous(), vh.contiguous())
        out = FlashAttention.apply(*qkv) if torch.is_grad_enabled() else flash_attention(*qkv)
    else:
        out = _attend(qh, kh, vh)
    return out.transpose(1, 2).reshape(b, t, d)


def attention(x, p: Attention, n_head, seq_group=None):
    """Self-attention block of ``n_head`` heads (a tensor-parallel shard
    runs those of its columns). ``seq_group``: the sp group whose ranks hold
    the other rows of x; K and V are gathered over it."""
    q, k, v = dense(x, p.q), dense(x, p.k), dense(x, p.v)
    h = n_head * q.shape[-1] // x.shape[-1]
    k, v = gather_seq(k, seq_group), gather_seq(v, seq_group)
    return dense(mha(q, k, v, h), p.o)


def mlp(x, p1: Dense, p2: Dense):
    return dense(F.gelu(dense(x, p1), approximate="none"), p2)


def _conv1d(x, w, b, stride: int):
    """x [B, T, Cin], w [K, Cin, Cout] → [B, T//stride, Cout] (SAME pad)."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride, padding=1)
    return y.transpose(1, 2) + b


def encoder_apply(cfg: WhisperConfig, model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, 3000, n_mels] → audio features [B, 1500, d_audio]. On an "sp"
    mesh the blocks run on this rank's T/sp rows and the output is gathered
    whole."""
    enc = model.encoder
    x = mel.to(cfg.dtype)
    x = F.gelu(_conv1d(x, enc.conv1_w, enc.conv1_b, stride=1), approximate="none")
    x = F.gelu(_conv1d(x, enc.conv2_w, enc.conv2_b, stride=2), approximate="none")
    x = x + enc.pos[: x.shape[1]].to(x.dtype)
    x = seq_constraint(x, model.mesh)
    sp = None if model.mesh is None else model.mesh.group("sp")
    for layer in enc.blocks:
        x = x + attention(layer_norm(x, layer.attn_ln), layer.attn, cfg.n_audio_head, sp)
        x = x + mlp(layer_norm(x, layer.mlp_ln), layer.mlp_1, layer.mlp_2)
    return gather_seq(layer_norm(x, enc.ln_post), sp)


# ---------------------------------------------------------------------------
# Decoder with KV cache
# ---------------------------------------------------------------------------


def text_heads(cfg: WhisperConfig, model: Whisper) -> int:
    """The decoder heads ``model`` holds: ``cfg.n_text_head``, or a
    tensor-parallel shard's share, read from its cross-attention q's width."""
    q = model.decoder.blocks[0].cross_attn.q
    width = (q.w if q.w is not None else q.w_q).shape[-1]
    return cfg.n_text_head * width // cfg.n_text_state


def init_kv_cache(
    cfg: WhisperConfig,
    batch: int,
    cache_len: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
    n_head: Optional[int] = None,
) -> dict:
    """Self-attention KV slab, position-major ``[L, B, H, C, hd]``, with
    ``n_head`` heads (default ``cfg.n_text_head``; a shard's ``text_heads``).

    ``dtype`` overrides the storage dtype (default ``cfg.dtype``);
    ``torch.float8_e4m3fn`` halves the slab's bytes, with values converted
    to the compute dtype when read (no scales: K/V activations fit e4m3's
    ±448 range). Beyond it torch's conversion saturates to ±448, where the
    JAX package's gives NaN from |x| ≥ 464 on."""
    hd = cfg.n_text_state // cfg.n_text_head
    shape = (cfg.n_text_layer, batch, n_head or cfg.n_text_head, cache_len or cfg.n_text_ctx, hd)
    dt = cfg.dtype if dtype is None else dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _xa_layer(xa_kv: dict, li: int) -> dict:
    return {name: t[li] for name, t in xa_kv.items()}


def precompute_xa_kv(
    cfg: WhisperConfig, model: Whisper, xa: torch.Tensor, bits: int = 0
) -> dict:
    """Cross-attention K/V from encoder output, once per window.

    xa: [B, 1500, d] → {"k","v"}: [L, B, H, hd, 1500] (KF layout), or with
    ``bits`` = 8 / 4 the int8 / packed-int4 form of ``ops/quant.quantize_xa_kv``.
    Quantization happens inside the per-layer loop into preallocated
    outputs, so the bf16 slab for all layers never exists."""
    from ..ops.quant import _quantize_kv

    if bits not in (0, 4, 8):
        raise ValueError(f"bits must be 0, 4 or 8, got {bits}")
    blocks = model.decoder.blocks
    B, T, _ = xa.shape
    h = text_heads(cfg, model)
    hd = cfg.n_text_state // cfg.n_text_head
    L = len(blocks)
    if bits:
        names = ("k_p", "v_p") if bits == 4 else ("k_q", "v_q")
        tf = T // 2 if bits == 4 else T
        out = {n: torch.empty((L, B, h, hd, tf), dtype=torch.int8, device=xa.device) for n in names}
        out.update({s: torch.empty((L, B, h, T), dtype=torch.float32, device=xa.device)
                    for s in ("k_scale", "v_scale")})
    else:
        names = ("k", "v")
        out = {n: torch.empty((L, B, h, hd, T), dtype=xa.dtype, device=xa.device) for n in names}
    for li, layer in enumerate(blocks):
        ca = layer.cross_attn
        for name, proj, sname in ((names[0], ca.k, "k_scale"), (names[1], ca.v, "v_scale")):
            x = _split_heads(dense(xa, proj), h).permute(0, 2, 3, 1)  # [B,H,hd,F]
            if bits:
                out[name][li], out[sname][li] = _quantize_kv(x, bits)
            else:
                out[name][li] = x
    return out


def _attend_xa(q, xa: dict, scale):
    """Cross-attention against one layer's audio K/V (plain, any T), int8-
    and int4-aware. q [B,H,T,hd]; xa holds {"k","v"} [B,H,hd,F], or int8
    {"k_q","v_q"} / packed {"k_p","v_p"} with "k_scale","v_scale" [B,H,F].
    ``k_scale`` multiplies the scores after the q·k product, ``v_scale``
    the softmax weights (``ops/beam_attention.beam_cross_attention_reference``).
    Returns (out [B,H,T,hd], the fp32 softmax weights [B,H,T,F]), as the
    JAX package's ``_attend_xa``."""
    xa = unpack_xa_kv(xa)
    s2 = scale * scale
    if "k_q" not in xa:
        return beam_cross_attention_reference(q, xa["k"], xa["v"], scale=s2,
                                              return_weights=True)
    return beam_cross_attention_reference(q, xa["k_q"], xa["v_q"], xa["k_scale"],
                                          xa["v_scale"], scale=s2, return_weights=True)


def _attend_xa_step(q1, xa: dict, scale):
    """Single-token cross-attention, q1 [S,H,hd] → [S,H,hd]: K4 on the
    packed int4 carrier, K3's int8 form on an int8 slab, K3's plain form on
    a bf16 slab (each wrapper takes its plain version on a CPU tensor)."""
    s2 = scale * scale
    if "k_p" in xa:
        return decode_attention_i4(q1, xa["k_p"], xa["v_p"], xa["k_scale"], xa["v_scale"], scale=s2)
    if "k_q" in xa:
        return decode_attention(q1, xa["k_q"], xa["v_q"], xa["k_scale"], xa["v_scale"], scale=s2)
    return decode_attention(q1, xa["k"], xa["v"], scale=s2)


def _attend_xa_beam(q, xa: dict, scale):
    """Beam cross-attention, the K beams of an item against its shared
    slab: q [B,H,K,hd] → [B,H,K,hd]. K6 in the slab's form (packed int4,
    int8 or bf16); each wrapper takes its plain version on a CPU tensor."""
    s2 = scale * scale
    if "k_p" in xa:
        return beam_cross_attention_i4(q, xa["k_p"], xa["v_p"], xa["k_scale"], xa["v_scale"],
                                       scale=s2)
    if "k_q" in xa:
        return beam_cross_attention(q, xa["k_q"], xa["v_q"], xa["k_scale"], xa["v_scale"],
                                    scale=s2)
    return beam_cross_attention(q, xa["k"], xa["v"], scale=s2)


def _self_qkv(y, attn: Attention):
    if attn.qkv is not None:  # fused projection (ops/quant.py)
        return torch.chunk(dense(y, attn.qkv), 3, dim=-1)
    return dense(y, attn.q), dense(y, attn.k), dense(y, attn.v)


def decoder_apply(
    cfg: WhisperConfig,
    model: Whisper,
    tokens: torch.Tensor,  # [B, T] int
    pos_offset: int,  # position of tokens[:, 0]
    kv_cache: Optional[dict],
    xa_kv: dict,
    collect_cross_attn: bool = False,
    cross_attn_layer_begin: Optional[int] = None,
):
    """Run the decoder on ``tokens`` (prefill T > 1, or one step T = 1),
    writing the self-attention KV cache in place at
    [pos_offset, pos_offset + T). Returns (logits [B, T, n_vocab] fp32,
    kv_cache).

    ``kv_cache=None`` (training) writes nothing: the self-attention reads
    this call's K/V under the causal mask, which at ``pos_offset`` 0 is
    what a fresh cache gives (its later rows are masked), and no view is
    written after autograd saved it.

    ``collect_cross_attn`` (for DTW token timestamps) also returns the
    cross-attention softmax weights, as a third element: stacked
    [L, B, H, T, F] fp32, or with ``cross_attn_layer_begin`` the reduced
    form the alignment pass reads, the mean over heads and over layers
    ≥ ``cross_attn_layer_begin``, [B, T, F], accumulated layer by layer (the
    JAX package's forms). Both run the plain cross-attention, T = 1 too. A
    tensor-parallel shard returns the same weights as the whole model: the
    reduced form sums its heads and all-reduces the sum over tp before the
    mean over ``n_text_head``, the stacked form all-gathers the heads."""
    dec = model.decoder
    B, T = tokens.shape
    reduced = collect_cross_attn and cross_attn_layer_begin is not None
    if T == 1 and not collect_cross_attn and kv_cache is not None:
        logits, kv_cache = decoder_step(cfg, model, tokens[:, 0], pos_offset, kv_cache, xa_kv)
        return logits[:, None], kv_cache

    x = (embed_tokens(dec, tokens) + dec.pos_emb[pos_offset : pos_offset + T]).to(cfg.dtype)
    dev = x.device
    cache_len = T if kv_cache is None else kv_cache["k"].shape[3]
    kpos = torch.arange(cache_len, device=dev)[None, :] + (pos_offset if kv_cache is None else 0)
    qpos = pos_offset + torch.arange(T, device=dev)[:, None]
    self_mask = (kpos <= qpos)[None, None]  # [1, 1, T, cache_len]

    h = text_heads(cfg, model)
    scale = (cfg.n_text_state // cfg.n_text_head) ** -0.25
    tp = None if model.mesh is None else model.mesh.group("tp")

    def to_heads(y):  # [B,T,d] → head-major [B,H,T,c]
        return _split_heads(y, h).transpose(1, 2)

    weights, acc = [], None
    for li, layer in enumerate(dec.blocks):
        y = layer_norm(x, layer.attn_ln)
        qp, kp, vp = _self_qkv(y, layer.attn)
        if kv_cache is None:
            k_self, v_self = to_heads(kp), to_heads(vp)
        else:
            k_self, v_self = kv_cache["k"][li], kv_cache["v"][li]
            k_self[:, :, pos_offset : pos_offset + T] = to_heads(kp).to(k_self.dtype)
            v_self[:, :, pos_offset : pos_offset + T] = to_heads(vp).to(v_self.dtype)
        sa = _attend(to_heads(qp) * (scale * scale), k_self, v_self, self_mask)
        x = x + dense(sa.transpose(1, 2).reshape(B, T, -1), layer.attn.o)

        y = layer_norm(x, layer.cross_attn_ln)
        q = to_heads(dense(y, layer.cross_attn.q))
        ca, w = _attend_xa(q, _xa_layer(xa_kv, li), scale)
        x = x + dense(ca.transpose(1, 2).reshape(B, T, -1), layer.cross_attn.o)
        if reduced:
            if li >= cross_attn_layer_begin:
                part = w.mean(dim=1) if tp is None else w.sum(dim=1)
                acc = part if acc is None else acc + part
        elif collect_cross_attn:
            weights.append(w)

        x = x + mlp(layer_norm(x, layer.mlp_ln), layer.mlp_1, layer.mlp_2)
    x = layer_norm(x, dec.ln)
    logits = tied_logits(x, dec)
    if not collect_cross_attn:
        return logits, kv_cache
    if reduced:
        n_sel = max(1, cfg.n_text_layer - cross_attn_layer_begin)
        if acc is None:  # no layer at or above the threshold: zeros, as the JAX package
            acc = torch.zeros_like(w[:, 0])
        elif tp is not None:  # every head's sum, then the mean over all of them
            dist.all_reduce(acc, group=tp)
            acc = acc / cfg.n_text_head
        return logits, kv_cache, acc / n_sel
    stacked = torch.stack(weights)  # [L, B, H, T, F]
    if tp is not None:
        parts = [torch.empty_like(stacked) for _ in range(dist.get_world_size(tp))]
        dist.all_gather(parts, stacked.contiguous(), group=tp)
        stacked = torch.cat(parts, dim=2)
    return logits, kv_cache, stacked


def pos_index(pos, device) -> torch.Tensor:
    """Decode positions as an int64 tensor: ``[S]`` per-row positions as
    they are, a shared position (a 0-d or ``[1]`` tensor, e.g. the loop's
    device scalar, or an int) as ``[1]`` on ``device``."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(-1).to(torch.int64)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)  # a fill, no copy


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def int_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as integers of its width: indexed writes
    (``index_copy_``, ``index_put_``) take every storage type through it,
    fp8 too."""
    return t.view(_INT_OF_WIDTH[t.element_size()])


def _write_rows(cache: torch.Tensor, at, rows: torch.Tensor) -> None:
    """``cache[s, :, pos[s]] = rows[s]`` in place for device positions:
    ``at`` a shared ``[1]`` position (``index_copy_`` along the position
    axis) or the pair (arange(S), pos [S]) (``index_put_``); both on the
    storage's ``int_view``. cache [S, H, C, hd]; rows [S, H, hd]."""
    view, new = int_view(cache), int_view(rows.to(cache.dtype))
    if isinstance(at, tuple):
        view.transpose(1, 2).index_put_(at, new)
    else:
        view.index_copy_(2, at, new[:, :, None])


def _read_len(cache_len: int, c_valid: int) -> int:
    return c_valid if 0 < c_valid < cache_len else cache_len


def decoder_step(
    cfg: WhisperConfig,
    model: Whisper,
    tokens: torch.Tensor,  # [S] int: one new token per row
    pos,  # [S] int64 per-row positions, or a shared one: a 0-d or [1] tensor, or an int
    kv_cache: dict,  # [L, S, H, cache_len, hd], written in place at pos
    xa_kv: dict,  # [L, S, H, hd, 1500] KF (+ scales when quantized)
    c_valid: int = 0,  # read self-cache positions [0, c_valid) only; 0 = all
):
    """One decode step, the rows in lockstep at a shared position or each at
    its own (the continuous batcher's slots; the JAX package's ``pos``
    vector without ``ring_row``). ``pos`` is read on the device (embedding
    row, self mask, cache write), so a CUDA graph of the step replays at
    whatever positions the tensor holds. Exact for any ``c_valid`` above
    every row's position (later rows are masked), as the JAX package's
    ``decoder_step(c_valid=)``. Returns (logits [S, V] fp32, kv_cache)."""
    dec = model.decoder
    S = tokens.shape[0]
    h = text_heads(cfg, model)
    hd = cfg.n_text_state // cfg.n_text_head
    scale = hd**-0.25
    pos1 = pos_index(pos, tokens.device)
    at = (torch.arange(S, device=pos1.device), pos1) if pos1.numel() > 1 else pos1

    x = (embed_tokens(dec, tokens) + dec.pos_emb.index_select(0, pos1))[:, None, :].to(cfg.dtype)
    cv = _read_len(kv_cache["k"].shape[3], c_valid)
    self_mask = (torch.arange(cv, device=x.device) <= pos1[:, None])[:, None, None, :]

    for li, layer in enumerate(dec.blocks):
        y = layer_norm(x, layer.attn_ln)
        qp, kp, vp = _self_qkv(y, layer.attn)
        k_cache, v_cache = kv_cache["k"][li], kv_cache["v"][li]
        _write_rows(k_cache, at, kp.reshape(S, h, hd))
        _write_rows(v_cache, at, vp.reshape(S, h, hd))
        q = qp.reshape(S, h, 1, hd)
        sa = _attend(q * (scale * scale), k_cache[:, :, :cv], v_cache[:, :, :cv], self_mask)
        x = x + dense(sa.reshape(S, 1, h * hd).to(x.dtype), layer.attn.o)

        y = layer_norm(x, layer.cross_attn_ln)
        q = dense(y, layer.cross_attn.q).reshape(S, h, hd)
        ca = _attend_xa_step(q, _xa_layer(xa_kv, li), scale)
        x = x + dense(ca.reshape(S, 1, h * hd).to(x.dtype), layer.cross_attn.o)

        x = x + mlp(layer_norm(x, layer.mlp_ln), layer.mlp_1, layer.mlp_2)
    x = layer_norm(x, dec.ln)
    return tied_logits(x, dec)[:, 0], kv_cache


def decoder_verify(
    cfg: WhisperConfig,
    model: Whisper,
    tokens: torch.Tensor,  # [B, T] int
    pos: torch.Tensor,  # [1] int64 on the device: the position of tokens[:, 0]
    kv_cache: dict,  # [L, B, H, cache_len, hd], written in place
    xa_kv: dict,  # [L, B, H, hd, 1500] KF (+ scales when quantized)
) -> torch.Tensor:
    """``decoder_apply`` over T tokens at a device position: speculative
    decoding's verify pass (T = γ + 1), which a CUDA graph replays at
    whatever position ``pos`` holds. Returns logits [B, T, V] fp32.

    Where the window nears the end of the context, the rows land as the JAX
    package's ``dynamic_slice`` / ``dynamic_update_slice`` put them: the
    position embeddings start at ``pos`` clamped to ``n_text_ctx - T``, the
    cache rows at ``pos`` clamped to ``cache_len - T``, while the causal mask
    keeps the unclamped ``pos + i``. Self-attention is plain masked attention
    over the cache (XLA's in the JAX package); the cross read is K6 with the
    T queries as its beams against the item's one slab."""
    dec = model.decoder
    B, T = tokens.shape
    h = text_heads(cfg, model)
    hd = cfg.n_text_state // cfg.n_text_head
    scale = hd**-0.25
    dev = tokens.device
    steps = torch.arange(T, device=dev)
    cache_len = kv_cache["k"].shape[3]
    emb_rows = pos.clamp(0, cfg.n_text_ctx - T) + steps
    cache_rows = pos.clamp(0, cache_len - T) + steps
    x = (embed_tokens(dec, tokens) + dec.pos_emb.index_select(0, emb_rows)).to(cfg.dtype)
    self_mask = (torch.arange(cache_len, device=dev)[None, :] <= (pos + steps)[:, None])[None, None]

    def to_heads(y):  # [B,T,d] → head-major [B,H,T,c]
        return _split_heads(y, h).transpose(1, 2)

    for li, layer in enumerate(dec.blocks):
        y = layer_norm(x, layer.attn_ln)
        qp, kp, vp = _self_qkv(y, layer.attn)
        for cache, new in ((kv_cache["k"][li], kp), (kv_cache["v"][li], vp)):
            int_view(cache).index_copy_(2, cache_rows, int_view(to_heads(new).to(cache.dtype)))
        sa = _attend(to_heads(qp) * (scale * scale), kv_cache["k"][li], kv_cache["v"][li],
                     self_mask)
        x = x + dense(sa.transpose(1, 2).reshape(B, T, h * hd).to(x.dtype), layer.attn.o)

        y = layer_norm(x, layer.cross_attn_ln)
        q = to_heads(dense(y, layer.cross_attn.q)).contiguous()  # [B,H,T,hd]
        ca = _attend_xa_beam(q, _xa_layer(xa_kv, li), scale)
        x = x + dense(ca.transpose(1, 2).reshape(B, T, h * hd).to(x.dtype), layer.cross_attn.o)

        x = x + mlp(layer_norm(x, layer.mlp_ln), layer.mlp_1, layer.mlp_2)
    x = layer_norm(x, dec.ln)
    return tied_logits(x, dec)


def decoder_step_beam(
    cfg: WhisperConfig,
    model: Whisper,
    tokens: torch.Tensor,  # [B*K] int: one new token per beam
    pos,  # shared position (beams decode in lockstep): an int64 tensor or an int
    kv_cache: dict,  # [L, B*K, H, C, hd] slot caches, slot s of item b at row b*K+s
    xa_kv: dict,  # [L, B, H, hd, 1500] KF, shared by the K beams of an item
    anc: torch.Tensor,  # [B, K, K, C] bool: beam kd reads position c from slot ks
    beam_size: int,
    c_valid: int = 0,  # read self-cache positions [0, c_valid) only; 0 = all
):
    """One beam-search decode step with no reordering of the KV cache: each
    beam appends its K/V row into its own slot at ``pos`` (in place, ``pos``
    read on the device as in ``decoder_step``), and parent adoption lives in
    the ancestry mask. Self-attention reads every slot of the item through
    the mask (K5); cross-attention serves the K beams of an item from one
    read of the untiled slab (K6). Exact for any ``c_valid`` > ``pos``
    (later rows are masked). Returns (logits [B*K, V] fp32, kv_cache)."""
    dec = model.decoder
    S = tokens.shape[0]
    K = beam_size
    B = S // K
    h = text_heads(cfg, model)
    hd = cfg.n_text_state // cfg.n_text_head
    scale = hd**-0.25
    pos1 = pos_index(pos, tokens.device)

    x = (embed_tokens(dec, tokens) + dec.pos_emb.index_select(0, pos1))[:, None, :].to(cfg.dtype)
    for li, layer in enumerate(dec.blocks):
        y = layer_norm(x, layer.attn_ln)
        qp, kp, vp = _self_qkv(y, layer.attn)
        k_cache, v_cache = kv_cache["k"][li], kv_cache["v"][li]
        _write_rows(k_cache, pos1, kp.reshape(S, h, hd))
        _write_rows(v_cache, pos1, vp.reshape(S, h, hd))
        sa = beam_attention(qp.reshape(S, h, hd).contiguous(), k_cache, v_cache, anc, K,
                            scale=scale * scale, c_valid=c_valid)
        x = x + dense(sa.reshape(S, 1, h * hd).to(x.dtype), layer.attn.o)

        y = layer_norm(x, layer.cross_attn_ln)
        q = dense(y, layer.cross_attn.q).reshape(B, K, h, hd).transpose(1, 2).contiguous()
        ca = _attend_xa_beam(q, _xa_layer(xa_kv, li), scale)  # [B,H,K,hd]
        x = x + dense(ca.transpose(1, 2).reshape(S, 1, h * hd).to(x.dtype), layer.cross_attn.o)

        x = x + mlp(layer_norm(x, layer.mlp_ln), layer.mlp_1, layer.mlp_2)
    x = layer_norm(x, dec.ln)
    return tied_logits(x, dec)[:, 0], kv_cache


def encode_xa_kv(cfg: WhisperConfig, model: Whisper, mel: torch.Tensor) -> dict:
    """Encoder + bf16 cross-attention K/V."""
    return precompute_xa_kv(cfg, model, encoder_apply(cfg, model, mel))


def encode_xa_kv_q(cfg: WhisperConfig, model: Whisper, mel: torch.Tensor, bits: int = 8) -> dict:
    """Encoder + quantized cross-attention K/V (compute_type=int8 / int4)."""
    return precompute_xa_kv(cfg, model, encoder_apply(cfg, model, mel), bits)
