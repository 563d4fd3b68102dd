"""The port's Silero VAD (``models/silero_vad.py``, ``runtime/vad.load_silero``)
against the JAX package's on the CPU.

The same weights on both sides: the JAX package's ``init_silero_params``
carried across with ``models/params.silero_from_numpy``. The port's
probabilities (the per-step cell loop on the CPU, fp32) must lie within
1e-5 of the JAX package's ``silero_frame_probs`` on clips of speech-like
tones, noise and silence, lengths that are and are not whole chunks up
to 30 s. Each package reads the ggml files the other writes, including
the v6.2.0-style container of ``tests/test_silero_vad.py`` (a drifted
hparams blob, f16 data, an extra tensor), and both refuse a drifted
tensor shape. ``is_speech_detected`` through an installed Silero gives
the reference's decisions; ``load_silero`` returns False on a missing or
unparsable file and installs the model from a real one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentiric_stt_whisper_service_tpu.models import silero_vad as ref
from sentiric_stt_whisper_service_tpu.runtime import vad as ref_vad
from sentiric_stt_whisper_service_tpu_torch.models import silero_vad as sv
from sentiric_stt_whisper_service_tpu_torch.models.params import silero_from_numpy
from sentiric_stt_whisper_service_tpu_torch.runtime import vad
from _torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from test_silero_vad import _write_v620_style


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the same as numpy, the port's tensors)."""
    params = ref.init_silero_params(jax.random.key(7))
    tree = jax.tree.map(np.asarray, params)
    return params, tree, silero_from_numpy(tree, "cpu")


def clip(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    t = np.arange(n) / 16000
    if kind == "tone":
        env = np.clip(np.sin(2 * np.pi * 1.5 * t) + 0.5, 0, 1)
        x = 0.3 * np.sin(2 * np.pi * 150 * t) * env + 0.01 * rng.standard_normal(n)
    elif kind == "noise":
        x = 0.3 * rng.standard_normal(n)
    else:
        x = np.zeros(n)
    return x.astype(np.float32)


@pytest.mark.parametrize("kind,n", [("tone", 16000), ("noise", 16000 * 3 + 77),
                                    ("silence", 2048), ("tone", 16000 * 30), ("noise", 1023),
                                    ("tone", 600)])
def test_frame_probs_match(weights, kind, n):
    params, _, mine = weights
    audio = clip(kind, n)
    want = np.asarray(ref.silero_frame_probs(params, jnp.asarray(audio)))
    with torch.inference_mode():
        got = sv.silero_frame_probs(mine, torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (n // sv.CHUNK,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_init_and_adapter():
    """init_silero_params from a torch.Generator: the shapes, zero conv
    biases (the LSTM biases are drawn, as in the JAX package),
    the fixed STFT basis (the JAX package's), the same draws for the same
    seed; the adapter's frames and its refusal of a clip shorter than a
    chunk."""
    a = sv.init_silero_params(torch.Generator().manual_seed(1))
    b = sv.init_silero_params(torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in a.items()} == sv.TENSOR_SHAPES
    for k, v in a.items():
        assert v.dtype == torch.float32 and torch.equal(v, b[k]), k
    assert not a["encoder.0.reparam_conv.bias"].any() and a["decoder.rnn.bias_ih"].any()
    np.testing.assert_array_equal(a["stft.forward_basis_buffer"].numpy(), ref._stft_basis())
    model = sv.SileroVad.random_init("cpu", seed=2)
    assert model.frame_ms == 32.0 and model.lstm is None
    assert model(np.zeros(sv.CHUNK * 4, np.float32)).shape == (4,)
    assert model(np.zeros(10, np.float32)).shape == (0,)


def test_ggml_files_cross_read(tmp_path, weights):
    """The port reads the JAX package's file and the JAX package the port's,
    value for value."""
    params, tree, mine = weights
    theirs_file, mine_file = tmp_path / "jax.bin", tmp_path / "port.bin"
    ref.write_silero_ggml(str(theirs_file), params)
    sv.write_silero_ggml(str(mine_file), mine)
    assert mine_file.read_bytes() == theirs_file.read_bytes()
    got = sv.load_silero_ggml(str(theirs_file))
    back = ref.load_silero_ggml(str(mine_file))
    assert set(got) == set(back) == set(sv.TENSOR_SHAPES)
    for k in sv.TENSOR_SHAPES:
        np.testing.assert_array_equal(got[k], tree[k])
        np.testing.assert_array_equal(np.asarray(back[k]), tree[k])


def test_v620_container(tmp_path, weights):
    """The v6.2.0-style container (drifted hparams, f16 data, an unknown
    tensor) parses to the JAX package's values; a drifted tensor shape
    fails loudly in both packages."""
    params, _, _ = weights
    path = tmp_path / "ggml-silero-v6.2.0.bin"
    _write_v620_style(str(path), params, sv.TENSOR_SHAPES)
    got, want = sv.load_silero_ggml(str(path)), ref.load_silero_ggml(str(path))
    for k in sv.TENSOR_SHAPES:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    drifted = dict(sv.TENSOR_SHAPES, **{"decoder.rnn.weight_ih": (768, 128)})
    bad = dict(params, **{"decoder.rnn.weight_ih": np.zeros((768, 128), np.float32)})
    path = tmp_path / "ggml-silero-v6.9.9.bin"
    _write_v620_style(str(path), bad, drifted, f16=False)
    for load in (sv.load_silero_ggml, ref.load_silero_ggml):
        with pytest.raises(ValueError, match="missing tensors"):
            load(str(path))
    assert vad.load_silero(str(path), device="cpu") is False


def test_gate_through_silero(tmp_path, weights):
    """load_silero installs the model from a file, and is_speech_detected
    through it decides as the JAX package's gate through its Silero; a
    missing file leaves the VAD as it was and returns False."""
    params, _, _ = weights
    path = tmp_path / "ggml-silero-test.bin"
    ref.write_silero_ggml(str(path), params)
    assert vad.load_silero(str(tmp_path / "missing.bin"), device="cpu") is False
    assert vad._vad_model is None
    try:
        assert vad.load_silero(str(path), device="cpu") is True
        assert ref_vad.load_silero(str(path)) is True
        assert isinstance(vad._vad_model, sv.SileroVad) and vad._vad_frame_ms == 32.0
        for kind, n in (("tone", 16000 * 2), ("noise", 16000), ("silence", 16000)):
            audio = clip(kind, n)
            np.testing.assert_allclose(vad.frame_speech_probs(audio),
                                       ref_vad.frame_speech_probs(audio), atol=1e-5)
            for threshold in (0.3, 0.5, 0.75):
                for min_ms in (64, 250, 500):
                    assert vad.is_speech_detected(audio, 16000, threshold, min_ms) == \
                        ref_vad.is_speech_detected(audio, 16000, threshold, min_ms), \
                        (kind, threshold, min_ms)
    finally:
        vad.set_vad_model(None)
        ref_vad.set_vad_model(None)
