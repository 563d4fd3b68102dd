"""The PyTorch port stands alone: importing it pulls in neither JAX, optax nor
the JAX package, its sources hold no library stand-ins for its kernels, and
its kernel wrappers take their plain versions only for CPU tensors."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sentiric_stt_whisper_service_tpu_torch"

MODULES = [
    "sentiric_stt_whisper_service_tpu_torch",
    "sentiric_stt_whisper_service_tpu_torch.audio",
    "sentiric_stt_whisper_service_tpu_torch.kernels",
    "sentiric_stt_whisper_service_tpu_torch.models",
    "sentiric_stt_whisper_service_tpu_torch.models.beam",
    "sentiric_stt_whisper_service_tpu_torch.models.params",
    "sentiric_stt_whisper_service_tpu_torch.models.silero_vad",
    "sentiric_stt_whisper_service_tpu_torch.models.speculative",
    "sentiric_stt_whisper_service_tpu_torch.native",
    "sentiric_stt_whisper_service_tpu_torch.ops",
    "sentiric_stt_whisper_service_tpu_torch.ops.beam_attention",
    "sentiric_stt_whisper_service_tpu_torch.ops.decode_attention",
    "sentiric_stt_whisper_service_tpu_torch.ops.flash_attention",
    "sentiric_stt_whisper_service_tpu_torch.ops.fused_mel",
    "sentiric_stt_whisper_service_tpu_torch.tokenizer",
    "sentiric_stt_whisper_service_tpu_torch.audio.resample",
    "sentiric_stt_whisper_service_tpu_torch.checkpoint",
    "sentiric_stt_whisper_service_tpu_torch.checkpoint.ggml",
    "sentiric_stt_whisper_service_tpu_torch.checkpoint.manager",
    "sentiric_stt_whisper_service_tpu_torch.checkpoint.safetensors_io",
    "sentiric_stt_whisper_service_tpu_torch.config",
    "sentiric_stt_whisper_service_tpu_torch.diarize",
    "sentiric_stt_whisper_service_tpu_torch.models.timestamps",
    "sentiric_stt_whisper_service_tpu_torch.prosody.extractor",
    "sentiric_stt_whisper_service_tpu_torch.runtime",
    "sentiric_stt_whisper_service_tpu_torch.runtime.batcher",
    "sentiric_stt_whisper_service_tpu_torch.runtime.engine",
    "sentiric_stt_whisper_service_tpu_torch.runtime.gang",
    "sentiric_stt_whisper_service_tpu_torch.runtime.streaming",
    "sentiric_stt_whisper_service_tpu_torch.runtime.vad",
    "sentiric_stt_whisper_service_tpu_torch.text",
    "sentiric_stt_whisper_service_tpu_torch.ops.flash_q8",
    "sentiric_stt_whisper_service_tpu_torch.tools",
    "sentiric_stt_whisper_service_tpu_torch.tools.bench_flash_int8",
    "sentiric_stt_whisper_service_tpu_torch.serving",
    "sentiric_stt_whisper_service_tpu_torch.serving.grpc_server",
    "sentiric_stt_whisper_service_tpu_torch.serving.health",
    "sentiric_stt_whisper_service_tpu_torch.serving.http_server",
    "sentiric_stt_whisper_service_tpu_torch.serving.main",
    "sentiric_stt_whisper_service_tpu_torch.serving.metrics",
    "sentiric_stt_whisper_service_tpu_torch.serving.proto.stt_pb2",
    "sentiric_stt_whisper_service_tpu_torch.serving.suts_logging",
    "sentiric_stt_whisper_service_tpu_torch.cli",
    "sentiric_stt_whisper_service_tpu_torch.cli.main",
    "sentiric_stt_whisper_service_tpu_torch.cli.convert",
    "sentiric_stt_whisper_service_tpu_torch.parallel",
    "sentiric_stt_whisper_service_tpu_torch.parallel.mesh",
    "sentiric_stt_whisper_service_tpu_torch.parallel.distributed",
    "sentiric_stt_whisper_service_tpu_torch.parallel.replay",
    "sentiric_stt_whisper_service_tpu_torch.runtime.training",
    "sentiric_stt_whisper_service_tpu_torch.tracing",
]


def test_import_leaves_out_jax_and_the_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'optax')"
        " or m == 'sentiric_stt_whisper_service_tpu'"
        " or m.startswith('sentiric_stt_whisper_service_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize(
    "needle", ["import jax", "from jax", "import optax", "from optax",
               "scaled_dot_product_attention", "torch.compile",
               "sentiric_stt_whisper_service_tpu.", "import tiktoken", "from safetensors",
               "import safetensors"],
)
def test_port_sources_avoid(needle):
    # chip_smoke.py times PyTorch's attention call beside the kernels as a
    # yardstick (library_ms); the package itself never calls it.
    smoke = [] if needle == "scaled_dot_product_attention" else [ROOT / "chip_smoke.py"]
    hits = [
        str(p.relative_to(ROOT))
        for p in sorted(PORT.rglob("*.py")) + smoke
        if needle in p.read_text()
    ]
    assert not hits, f"{needle!r} in {hits}"


def test_cpu_tensors_take_the_plain_versions():
    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel
    from sentiric_stt_whisper_service_tpu_torch.ops.beam_attention import (
        beam_attention,
        beam_cross_attention,
        beam_cross_attention_i4,
    )
    from sentiric_stt_whisper_service_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_i4,
    )
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import flash_attention

    before = dict(kernels.LAUNCHES)
    g = torch.Generator().manual_seed(0)
    compute_log_mel(torch.randn(2, 16000, generator=g))
    q = torch.randn(1, 2, 64, 64, generator=g)
    flash_attention(q, q, q)
    q1 = torch.randn(1, 2, 64, generator=g)
    k = torch.randn(1, 2, 64, 16, generator=g)
    decode_attention(q1, k, k)
    s = torch.ones(1, 2, 16)
    kp = torch.zeros(1, 2, 64, 8, dtype=torch.int8)
    decode_attention_i4(q1, kp, kp, s, s)
    qb = torch.randn(2, 2, 64, generator=g)
    kv = torch.randn(2, 2, 16, 64, generator=g)
    beam_attention(qb, kv, kv, torch.ones(1, 2, 2, 16, dtype=torch.bool), 2)
    qc = torch.randn(1, 2, 2, 64, generator=g)
    beam_cross_attention(qc, k, k)
    beam_cross_attention_i4(qc, kp, kp, s, s)
    assert kernels.LAUNCHES == before  # nothing launched, nothing built


def test_other_devices_raise_instead_of_falling_back():
    from sentiric_stt_whisper_service_tpu_torch.ops.beam_attention import (
        beam_attention,
        beam_cross_attention,
    )
    from sentiric_stt_whisper_service_tpu_torch.ops.decode_attention import decode_attention
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import flash_attention

    q = torch.empty(1, 2, 64, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    q1 = torch.empty(1, 2, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1, 2, 64, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q1, k, k)
    kv = torch.empty(2, 2, 16, 64, device="meta", dtype=torch.bfloat16)
    anc = torch.empty(1, 2, 2, 16, device="meta", dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        beam_attention(q1[:1].expand(2, 2, 64).contiguous(), kv, kv, anc, 2)
    with pytest.raises(ValueError, match="CUDA"):
        beam_cross_attention(q, k, k)


def test_library_name_follows_the_sources():
    from sentiric_stt_whisper_service_tpu_torch import kernels

    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path == kernels.library_path()  # deterministic
    assert {p.name for p in kernels.CSRC.glob("*.cu")} == {
        "mel.cu", "flash_attention.cu", "decode_attention.cu", "decode_attention_i4.cu",
        "beam_attention.cu", "beam_cross_attention.cu", "flash_q8.cu", "dense_w8.cu"}
