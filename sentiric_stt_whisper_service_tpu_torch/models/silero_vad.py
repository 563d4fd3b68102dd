"""Silero VAD v5, held against the JAX package's ``models/silero_vad.py``.

The reference service gates requests with Silero through whisper.cpp,
which evaluates the model chunk by chunk on the CPU. Here, as in the JAX
package, the chunks' framing, the STFT and the encoder convs run batched
over every chunk of a clip at once, and only the LSTM recurrence is
sequential. Its input does not depend on its state, so on the card the
recurrence is one cuDNN LSTM call over the whole sequence
(:func:`lstm_sequence`: a handful of launches per clip, where a loop of
cell steps would take about 5,000 for 30 s); on the CPU it is the plain
per-step cell loop (:func:`lstm_cells`), which is also the test oracle.
Silero has no Pallas kernel in the JAX package, so nothing here counts
kernel launches.

Architecture (Silero v5, shapes as in whisper.cpp's ggml-silero dump):

  input: 16 kHz mono in 512-sample chunks, each with the previous chunk's
  last 64 samples as context (576 samples per step)
  stft:    reflect-pad 64, conv1d with the fixed 258x1x256 forward basis
           (hop 128) → 129 real + 129 imaginary → magnitude [129, 4]
  encoder: 4 x (conv1d k=3 pad=1 + ReLU), channels 129→128→64→64→128,
           strides 1,2,2,1 → [128, 1] per chunk
  decoder: LSTM cell (128→128) carried across chunks, then ReLU → conv1d
           k=1 (128→1) → sigmoid: one speech probability per 32 ms chunk

Parameters are a dict of fp32 tensors keyed by the container's names, in
torch's layouts (conv weights OIT, LSTM gates i, f, g, o), the same as the
JAX package's (``models/params.silero_from_numpy`` carries them across).
The ggml container's scanner, loader and writer parse with numpy, as there.
The gate's rules on top of the probabilities live in ``runtime/vad.py``.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .graphs import to_device, to_host

SAMPLE_RATE = 16000
CHUNK = 512  # samples per VAD step (32 ms at 16 kHz)
CONTEXT = 64  # samples of the previous chunk prepended to each chunk
N_FFT = 256
HOP = 128
N_FREQ = 129  # kept magnitude bins
STATE_DIM = 128

# (name suffix, shape) of every tensor in the ggml-silero container.
TENSOR_SHAPES = {
    "stft.forward_basis_buffer": (258, 1, 256),
    "encoder.0.reparam_conv.weight": (128, 129, 3),
    "encoder.0.reparam_conv.bias": (128,),
    "encoder.1.reparam_conv.weight": (64, 128, 3),
    "encoder.1.reparam_conv.bias": (64,),
    "encoder.2.reparam_conv.weight": (64, 64, 3),
    "encoder.2.reparam_conv.bias": (64,),
    "encoder.3.reparam_conv.weight": (128, 64, 3),
    "encoder.3.reparam_conv.bias": (128,),
    "decoder.rnn.weight_ih": (512, 128),
    "decoder.rnn.weight_hh": (512, 128),
    "decoder.rnn.bias_ih": (512,),
    "decoder.rnn.bias_hh": (512,),
    "decoder.decoder.2.weight": (1, 128, 1),
    "decoder.decoder.2.bias": (1,),
}

_ENC_STRIDES = (1, 2, 2, 1)


def _stft_basis() -> np.ndarray:
    """The fixed forward basis: rows are Hann-windowed DFT kernels (a
    loaded file's own basis replaces it)."""
    n = N_FFT
    window = np.hanning(n + 1)[:-1].astype(np.float64)  # periodic Hann
    k = np.arange(n // 2 + 1)[:, None]
    t = np.arange(n)[None, :]
    angle = -2.0 * np.pi * k * t / n
    real = np.cos(angle) * window
    imag = np.sin(angle) * window
    return np.concatenate([real, imag], axis=0)[:, None, :].astype(np.float32)


def init_silero_params(generator: Optional[torch.Generator] = None) -> dict:
    """Silero-v5-shaped parameters on the generator's device: random
    weights (normal / sqrt(fan_in)), zero biases, the fixed STFT basis."""
    dev = generator.device if generator is not None else torch.device("cpu")
    params = {}
    for name, shape in TENSOR_SHAPES.items():
        if name == "stft.forward_basis_buffer":
            params[name] = torch.from_numpy(_stft_basis()).to(dev)
        elif name.endswith("bias"):
            params[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            fan_in = int(np.prod(shape[1:])) or 1
            params[name] = torch.randn(shape, generator=generator, device=dev) / np.sqrt(fan_in)
    return params


def silero_features(params: dict, audio: torch.Tensor) -> torch.Tensor:
    """audio [N] fp32 at 16 kHz → the LSTM's inputs [N // 512, 128]: the
    framing, the STFT and the four encoder convs, batched over every chunk."""
    n_chunks = audio.shape[0] // CHUNK
    x = audio[: n_chunks * CHUNK].reshape(n_chunks, CHUNK)
    ctx = torch.cat([x.new_zeros((1, CONTEXT)), x[:-1, -CONTEXT:]], dim=0)
    frames = torch.cat([ctx, x], dim=1)  # [n_chunks, 576]
    padded = F.pad(frames[:, None, :], (CONTEXT, CONTEXT), mode="reflect")
    spec = F.conv1d(padded, params["stft.forward_basis_buffer"], stride=HOP)  # [n, 258, 4]
    real, imag = spec[:, :N_FREQ], spec[:, N_FREQ : 2 * N_FREQ]
    h = torch.sqrt(real * real + imag * imag + 1e-12)
    for i, stride in enumerate(_ENC_STRIDES):
        h = F.conv1d(h, params[f"encoder.{i}.reparam_conv.weight"],
                     params[f"encoder.{i}.reparam_conv.bias"], stride=stride, padding=1).relu()
    return h[:, :, 0]


def lstm_cells(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """The recurrence as a loop of LSTM cell steps from a zero state: the
    plain version. feats [T, 128] → hidden states [T, 128]. The input
    projection of every step is one product up front (it does not depend
    on the state)."""
    x_proj = feats @ params["decoder.rnn.weight_ih"].T + (
        params["decoder.rnn.bias_ih"] + params["decoder.rnn.bias_hh"])
    w_hh = params["decoder.rnn.weight_hh"].T
    h = feats.new_zeros((STATE_DIM,))
    c = feats.new_zeros((STATE_DIM,))
    out = []
    for xt in x_proj:
        i_g, f_g, g_g, o_g = (xt + h @ w_hh).chunk(4)
        c = torch.sigmoid(f_g) * c + torch.sigmoid(i_g) * torch.tanh(g_g)
        h = torch.sigmoid(o_g) * torch.tanh(c)
        out.append(h)
    return torch.stack(out) if out else feats.new_zeros((0, STATE_DIM))


def sequence_lstm(params: dict) -> torch.nn.LSTM:
    """A one-layer ``nn.LSTM`` holding the decoder's cell weights on their
    device, its weights in one flat buffer (what cuDNN reads)."""
    with torch.inference_mode(False), torch.no_grad():  # parameters, also when called inside
        lstm = torch.nn.LSTM(STATE_DIM, STATE_DIM, device="meta")  # no draws from the global RNG
        lstm = lstm.to_empty(device=params["decoder.rnn.weight_ih"].device).eval()
        for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            getattr(lstm, f"{name}_l0").copy_(params[f"decoder.rnn.{name}"])
        lstm.flatten_parameters()
    return lstm.requires_grad_(False)


def lstm_sequence(lstm: torch.nn.LSTM, feats: torch.Tensor) -> torch.Tensor:
    """The recurrence as one call over the whole sequence (cuDNN on the
    card) from a zero state: feats [T, 128] → hidden states [T, 128]."""
    hs, _ = lstm(feats[:, None, :])
    return hs[:, 0]


def silero_frame_probs(params: dict, audio: torch.Tensor,
                       lstm: Optional[torch.nn.LSTM] = None) -> torch.Tensor:
    """audio [N] fp32 at 16 kHz → [N // 512] speech probabilities, on
    ``audio``'s device: on the card the recurrence is one ``lstm`` call
    (``sequence_lstm(params)`` when none is given), on the CPU the cell
    loop."""
    feats = silero_features(params, audio)
    if audio.device.type == "cuda":
        hs = lstm_sequence(lstm if lstm is not None else sequence_lstm(params), feats)
    else:
        hs = lstm_cells(params, feats)
    out_w = params["decoder.decoder.2.weight"][:, :, 0]  # [1, 128]
    logits = hs.relu() @ out_w.T + params["decoder.decoder.2.bias"]
    return torch.sigmoid(logits)[:, 0]


# ---------------------------------------------------------------------------
# ggml container I/O (ggml-silero-*.bin)
# ---------------------------------------------------------------------------


def _scan_tensor_records(buf: bytes) -> dict[str, np.ndarray]:
    """Locate whisper.cpp-style tensor records by name.

    Each record is ``{i32 n_dims, i32 name_len, i32 ttype, i32 ne[n_dims],
    name bytes, f32/f16 data}``. Anchoring on the known tensor names makes
    the parse independent of the hparams blob before the records (which has
    changed across whisper.cpp releases)."""
    out: dict[str, np.ndarray] = {}
    for suffix, shape in TENSOR_SHAPES.items():
        for name in (f"_model.{suffix}", suffix):
            pos = buf.find(name.encode())
            if pos < 0:
                continue
            nd = len(shape)
            head_at = pos - (12 + 4 * nd)
            if head_at < 0:
                continue
            n_dims, name_len, ttype = struct.unpack_from("<3i", buf, head_at)
            if n_dims != nd or name_len != len(name) or ttype not in (0, 1):
                continue
            ne = struct.unpack_from(f"<{nd}i", buf, head_at + 12)
            if tuple(reversed(ne)) != shape:
                continue
            n_elems = int(np.prod(shape))
            dt = "<f4" if ttype == 0 else "<f2"
            arr = np.frombuffer(buf, dt, count=n_elems, offset=pos + name_len)
            out[suffix] = arr.astype(np.float32).reshape(shape)
            break
    return out


def load_silero_ggml(path: str) -> dict[str, np.ndarray]:
    """Parse a ggml-silero .bin → its tensors as fp32 numpy arrays (on the
    host; ``models/params.silero_from_numpy`` puts them on a device).
    Raises ValueError if an expected tensor is missing, OSError if the
    file cannot be read."""
    with open(path, "rb") as f:
        buf = f.read()
    tensors = _scan_tensor_records(buf)
    missing = set(TENSOR_SHAPES) - set(tensors)
    if missing:
        raise ValueError(f"silero ggml missing tensors: {sorted(missing)}")
    return tensors


def write_silero_ggml(path: str, params: dict) -> None:
    """Write parameters (tensors or arrays) in the whisper.cpp VAD
    container layout, with the ``_model.``-prefixed names of the upstream
    convert script."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 0x67676D6C))  # magic "ggml"
        f.write(struct.pack("<i", 1))  # version tag
        for suffix, shape in TENSOR_SHAPES.items():
            name = f"_model.{suffix}".encode()
            value = params[suffix]
            if isinstance(value, torch.Tensor):
                value = value.detach().float().cpu().numpy()
            arr = np.asarray(value, np.float32)
            if arr.shape != shape:
                raise ValueError(f"{suffix}: shape {arr.shape}, expected {shape}")
            f.write(struct.pack("<3i", arr.ndim, len(name), 0))
            f.write(struct.pack(f"<{arr.ndim}i", *reversed(shape)))
            f.write(name)
            f.write(arr.astype("<f4").tobytes())


class SileroVad:
    """Callable adapter for ``runtime.vad.set_vad_model``: per-chunk (32 ms)
    speech probabilities for a whole clip, computed on ``device``."""

    frame_ms: float = CHUNK * 1000.0 / SAMPLE_RATE  # 32 ms

    def __init__(self, params: dict, device):
        self.device = torch.device(device)
        self.params = {k: torch.as_tensor(v).to(self.device, torch.float32)
                       for k, v in params.items()}
        self.lstm = sequence_lstm(self.params) if self.device.type == "cuda" else None

    @classmethod
    def from_ggml(cls, path: str, device) -> "SileroVad":
        return cls(load_silero_ggml(path), device)

    @classmethod
    def random_init(cls, device, seed: int = 0) -> "SileroVad":
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return cls(init_silero_params(g), device)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1))
        if a.shape[0] < CHUNK:
            return np.zeros((0,), np.float32)
        with torch.inference_mode():
            probs = silero_frame_probs(self.params, to_device(a, self.device), self.lstm)
            return to_host(probs).numpy()
