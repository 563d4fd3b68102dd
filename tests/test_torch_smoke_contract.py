"""chip_smoke.py names every kernel of the port: its ``SOURCES`` table (one
row of the ``kernels`` JSON line each) has every launch counter of
``kernels.LAUNCHES``, each with a source in ``csrc/`` and the line of the
``pl.pallas_call`` it replaces, and its ``--profile`` name list covers every
``__global__`` function of ``csrc/``, so the breakdown drops none. Its
docstring numbers phases 1 to 11, phase 8's wire chunks carry the WAV header
and odd byte counts, and the probe's and the serving phase's constants hold
what they promise.
chip_smoke.py's top level is stdlib only, so it imports here without a card."""

import importlib.util
import re
from pathlib import Path

from sentiric_stt_whisper_service_tpu_torch import kernels

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sources_name_every_launch_counter():
    smoke = _smoke()
    assert set(smoke.SOURCES) == set(kernels.LAUNCHES)
    for name, (src, replaces, _path) in smoke.SOURCES.items():
        assert (ROOT / smoke.PKG / src).is_file(), (name, src)
        file, line = replaces.rsplit(":", 1)
        assert "pl.pallas_call(" in (ROOT / file).read_text().splitlines()[int(line) - 1], replaces


def test_profile_names_cover_every_kernel_function():
    text = "\n".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu*")))
    text = re.sub(r"__(launch_bounds|cluster_dims)__\([^)]*\)", "", text)
    names = set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    assert "beam_cross_attention_kernel" in names
    assert names == set(_smoke().PROFILE_KERNELS)


def test_docstring_numbers_every_phase():
    """The module docstring describes phases 1 to 11, in order (9: serving,
    10: the int8 attention probe, 11: speculative decoding)."""
    doc = _smoke().__doc__
    numbers = [int(n) for n in re.findall(r"^(\d+)\. ", doc, flags=re.M)]
    assert numbers == list(range(1, 12))
    assert "probe_flash_int8" in doc and "serving" in doc and "spec_turbo" in doc


def test_stream_chunks_carry_the_header_and_odd_counts():
    """Phase 8's wire chunks: a port-written WAV whose first chunk holds the
    44-byte header and one byte more (odd), the rest cut every 200 ms; the
    port's StreamBuffer reads back every sample."""
    import numpy as np

    from sentiric_stt_whisper_service_tpu_torch.native import StreamBuffer

    smoke = _smoke()
    x = (0.3 * np.sin(np.arange(16000) / 10)).astype(np.float32)
    chunks, raw = smoke.wav_chunks(np, x, smoke.STREAM_CHUNK_MS)
    assert b"".join(chunks) == raw and raw[:4] == b"RIFF" and len(raw) == 44 + 32000
    step = 16 * smoke.STREAM_CHUNK_MS * 2
    assert len(chunks[0]) == 44 + step + 1 and len(chunks[-1]) % 2 == 1
    assert all(len(c) == step for c in chunks[1:-1])
    buf = StreamBuffer()
    for c in chunks:
        buf.append(c)
    np.testing.assert_array_equal(buf.read(), np.frombuffer(raw[44:], "<i2"))
    assert smoke.pct([3.0, 1.0, 2.0, 4.0], 0.5) == 3.0 and smoke.pct([5.0], 0.9) == 5.0


def test_bound_counts_the_exponentials():
    """``bound`` takes the largest of the bytes, the tensor-core operations
    and the exponentials (3.9e12 a second): at P1's shape both modes are
    bound by their 16 * 20 * 1500^2 exponentials at about 0.185 ms, above
    their products (0.140 ms qk8, 0.093 ms full8) and bytes (0.073 ms); K2
    at the encoder's [4, 20, 1500, 64] stays bound by its bf16 products,
    0.0466 ms against 0.0462 ms of exponentials."""
    import pytest

    smoke = _smoke()
    B, H, L, D = smoke.P1_SHAPE
    product, n_bytes, exps = 2 * B * H * L * L * D, 4 * B * H * L * D * 2, B * H * L * L
    for ops in ({"int8": product, "bf16": product}, {"int8": 2 * product}):
        ms, by = smoke.bound(n_bytes, ops, exps)
        assert by == "exp" and ms == pytest.approx(0.1846, abs=5e-4)
        assert smoke.bound(n_bytes, ops)[1] != "exp"  # no exponentials counted: as before
    b, n = 4, 4 * H * L * D * 2 * 4
    ms, by = smoke.bound(n, {"bf16": 4 * b * H * L * L * D}, b * H * L * L)
    assert by == "operations" and ms == pytest.approx(0.0466, abs=1e-4)
