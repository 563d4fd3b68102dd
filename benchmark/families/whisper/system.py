"""The system under test, built from a configuration file and a seed: the
weights in the public Hugging Face tensor layout, made on the device, the
port's engine over them, and the settings the cell serves with.

Everything the program receives comes from here; the reference receives
the same raw tensors (made again from the same seed after the window).
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from .. import Built


def hf_shapes(dims: dict) -> dict:
    """name → (shape, init) of every tensor of a Whisper checkpoint in the
    Hugging Face layout (``WhisperForConditionalGeneration``, weights
    ``[out, in]``, convs ``[out, in, k]``). ``init`` is ("normal", std),
    ("ones", std) for a layer-norm gain around 1, or ("sinusoid", 0) for
    the encoder's fixed position table."""
    d, dt, m = dims["d_model"], dims["d_model"], dims["num_mel_bins"]
    ff = dims["encoder_ffn_dim"]
    out = {
        "model.encoder.conv1.weight": ((d, m, 3), ("normal", 1 / math.sqrt(3 * m))),
        "model.encoder.conv1.bias": ((d,), ("normal", 0.01)),
        "model.encoder.conv2.weight": ((d, d, 3), ("normal", 1 / math.sqrt(3 * d))),
        "model.encoder.conv2.bias": ((d,), ("normal", 0.01)),
        "model.encoder.embed_positions.weight": ((dims["max_source_positions"], d),
                                                 ("sinusoid", 0)),
    }

    def block(prefix, width, ffn, cross):
        attns = ["self_attn"] + (["encoder_attn"] if cross else [])
        for a in attns:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{prefix}.{a}.{proj}.weight"] = ((width, width), ("normal", 1 / math.sqrt(width)))
                if proj != "k_proj":
                    out[f"{prefix}.{a}.{proj}.bias"] = ((width,), ("normal", 0.01))
            out[f"{prefix}.{a}_layer_norm.weight"] = ((width,), ("ones", 0.02))
            out[f"{prefix}.{a}_layer_norm.bias"] = ((width,), ("normal", 0.02))
        out[f"{prefix}.fc1.weight"] = ((ffn, width), ("normal", 1 / math.sqrt(width)))
        out[f"{prefix}.fc1.bias"] = ((ffn,), ("normal", 0.01))
        out[f"{prefix}.fc2.weight"] = ((width, ffn), ("normal", 1 / math.sqrt(ffn)))
        out[f"{prefix}.fc2.bias"] = ((width,), ("normal", 0.01))
        out[f"{prefix}.final_layer_norm.weight"] = ((width,), ("ones", 0.02))
        out[f"{prefix}.final_layer_norm.bias"] = ((width,), ("normal", 0.02))

    for i in range(dims["encoder_layers"]):
        block(f"model.encoder.layers.{i}", d, ff, False)
    out["model.encoder.layer_norm.weight"] = ((d,), ("ones", 0.02))
    out["model.encoder.layer_norm.bias"] = ((d,), ("normal", 0.02))
    out["model.decoder.embed_tokens.weight"] = ((dims["vocab_size"], dt), ("normal", 0.02))
    out["model.decoder.embed_positions.weight"] = ((dims["max_target_positions"], dt),
                                                   ("normal", 0.01))
    for i in range(dims["decoder_layers"]):
        block(f"model.decoder.layers.{i}", dt, dims["decoder_ffn_dim"], True)
    out["model.decoder.layer_norm.weight"] = ((dt,), ("ones", 0.02))
    out["model.decoder.layer_norm.bias"] = ((dt,), ("normal", 0.02))
    return out


def make_state(dims: dict, seed: int, device) -> dict:
    """The checkpoint's tensors in bfloat16 on ``device``, drawn from
    ``seed`` by one generator on that device in one call: views of one
    buffer, each scaled to its initialisation."""
    return views(make_flat(dims, seed, device), dims)


def make_flat(dims: dict, seed: int, device) -> torch.Tensor:
    """The one buffer behind ``make_state``'s tensors."""
    shapes = hf_shapes(dims)
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    flat = torch.randn(sum(math.prod(s) for s, _ in shapes.values()), generator=g,
                       device=device, dtype=torch.bfloat16)
    for (shape, (kind, std)), t in zip(shapes.values(), views(flat, dims).values()):
        if kind == "sinusoid":
            t.copy_(sinusoids(*shape).to(device, torch.bfloat16))
        else:
            t.mul_(std)
            if kind == "ones":
                t.add_(1.0)
    return flat


def views(flat, dims: dict) -> dict:
    """name → the tensor's view of ``flat`` (a tensor or a numpy array)."""
    out, at = {}, 0
    for name, (shape, _) in hf_shapes(dims).items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].reshape(shape)
        at += n
    return out


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal position table of the encoder."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None]
    return torch.cat([t.sin(), t.cos()], dim=1).float()


def settings_for(config: dict, workload: dict, device: str):
    """The port's ``Settings``: the configuration's, then the cell's."""
    from sentiric_stt_whisper_service_tpu_torch.config import Settings

    fields = {**config.get("settings", {}), **workload.get("settings", {})}
    return dataclasses.replace(Settings(), device=device, **fields)


def host_arrays(flat: torch.Tensor, dims: dict) -> dict:
    """The checkpoint as the port's HF loader takes it: float32 numpy arrays
    on the host, of the published shapes. The loader transposes each
    linear weight and conv kernel into its own layout and stacks the
    layers; each array here is laid out so that its transpose is
    contiguous (rearranged on the device, then one copy to the host), so
    that the loader's copies run over contiguous memory. The values are
    the checkpoint's."""
    parts, layout = [], []
    for name, t in views(flat, dims).items():
        if t.dim() == 2 and "embed" not in name:  # linear [out, in]: stored [in, out]
            parts.append(t.t().contiguous().reshape(-1))
            layout.append((name, t.shape[::-1], (1, 0)))
        elif t.dim() == 3:  # conv [out, in, k]: stored [k, in, out]
            parts.append(t.permute(2, 1, 0).contiguous().reshape(-1))
            layout.append((name, t.shape[::-1], (2, 1, 0)))
        else:
            parts.append(t.reshape(-1))
            layout.append((name, t.shape, None))
    host = torch.cat(parts).cpu().float().numpy()
    del parts
    out, at = {}, 0
    for name, shape, perm in layout:
        n = math.prod(shape)
        a = host[at:at + n].reshape(shape)
        out[name] = a.transpose(perm) if perm else a
        at += n
    return out


def weights_seed(workload: dict, seed: int) -> int:
    """The seed the checkpoint is drawn from: the cell's ``weights_seed``
    where its workload file fixes one, else the run's seed. Random weights
    decide how many timestamped segments each window yields, and so the
    host's work a request; a fixed checkpoint leaves the run's seed the
    clips, their order and the windows judged, so that every seed serves
    the same work in another order."""
    return int(workload.get("weights_seed", seed))


def build(config: dict, workload: dict, seed: int, device: str) -> Built:
    """Weights from ``weights_seed(workload, seed)`` on ``device``, through
    the port's public HF loader
    (``checkpoint/safetensors_io.params_from_hf_state``), into an
    ``SttEngine`` with the cell's settings, warmed up."""
    from sentiric_stt_whisper_service_tpu_torch.checkpoint.safetensors_io import (
        params_from_hf_state,
    )
    from sentiric_stt_whisper_service_tpu_torch.runtime.engine import SttEngine

    dev = torch.device(device)
    t0 = time.perf_counter()
    flat = make_flat(config, weights_seed(workload, seed), dev)
    t1 = time.perf_counter()
    host = host_arrays(flat, config)
    del flat
    _, model = params_from_hf_state(host, dtype=torch.bfloat16, device=dev)
    del host
    t2 = time.perf_counter()
    settings = settings_for(config, workload, device)
    engine = SttEngine(settings, model_name=config["name"], params=model)
    t3 = time.perf_counter()
    warm = engine.warmup()
    return Built(engine, {"weights": t1 - t0, "loader": t2 - t1, "engine": t3 - t2,
                          "warmup": warm})
