"""chip_smoke.py names every kernel of the port: its ``SOURCES`` table (one
row of the ``kernels`` JSON line each) has every launch counter of
``kernels.LAUNCHES``, each with a source in ``csrc/`` and the line of the
``pl.pallas_call`` it replaces, and its ``--profile`` name list covers every
``__global__`` function of ``csrc/``, so the breakdown drops none.
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
