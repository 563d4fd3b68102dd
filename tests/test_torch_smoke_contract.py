"""chip_smoke.py names every kernel of the port: its ``SOURCES`` table (one
row of the ``kernels`` JSON line each) has every launch counter of
``kernels.LAUNCHES``, each with a source in ``csrc/`` and the line of the
``pl.pallas_call`` it replaces (or, for a kernel of ``XLA_FUSED``, the JAX
package's ``jnp.dot`` whose operand fusion it takes over), and its ``--profile`` name list covers every
``__global__`` function of ``csrc/``, so the breakdown drops none. Its
docstring numbers phases 1 to 13, phase 8's wire chunks carry the WAV header
and odd byte counts, the probe's and the serving phase's constants hold
what they promise, phase 12's gradient and decode checks and phase 13's
decode checks fail what they must, and phase 13 declares its paths
``engine_tp`` and ``engine_sp`` and requires their checks.
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
        text = (ROOT / file).read_text().splitlines()[int(line) - 1]
        replaced = "jnp.dot(" if name in smoke.XLA_FUSED else "pl.pallas_call("
        assert replaced in text, replaces


def test_profile_names_cover_every_kernel_function():
    text = "\n".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu*")))
    text = re.sub(r"__(launch_bounds|cluster_dims)__\([^)]*\)", "", text)
    names = set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    assert "beam_cross_attention_kernel" in names
    assert names == set(_smoke().PROFILE_KERNELS)


def test_docstring_numbers_every_phase():
    """The module docstring describes phases 1 to 13, in order (9: serving,
    10: the int8 attention probe, 11: speculative decoding, 12: training and
    the mesh, 13: the engine over a mesh)."""
    doc = _smoke().__doc__
    numbers = [int(n) for n in re.findall(r"^(\d+)\. ", doc, flags=re.M)]
    assert numbers == list(range(1, 14))
    assert "probe_flash_int8" in doc and "serving" in doc and "spec_turbo" in doc
    assert "training_tp" in doc and "--tp-worker" in doc
    assert "engine_tp" in doc and "engine_sp" in doc and "--mesh-worker" in doc


def test_phase_twelve_runs_last_and_the_last_line_stays():
    """Phase 12 (training, then the tp ranks) runs after phase 11 and before
    the kernels line; the last line printed is still the contract's
    ``{"ok": true, "device": {"platform": "gpu", ...}}``; a tp rank starts
    before the CUDA check only as ``--tp-worker``."""
    text = (ROOT / "chip_smoke.py").read_text()
    run_body = text[text.index("def run(torch, np"):text.index("def voiced_like(")]
    order = [run_body.index(k) for k in (
        "spec_phase(torch, np, model", "training_phase(torch, np, paths, card)",
        "print(json.dumps({\"kernels\": kernels_json}))", "print(json.dumps({\"ok\": True")]
    assert order == sorted(order)
    tail = run_body[order[-1]:]
    assert tail.split("return 0")[0].strip() == (
        'print(json.dumps({"ok": True, "device": {\n'
        '        "platform": "gpu", "kind": torch.cuda.get_device_name(0),\n'
        '        "count": torch.cuda.device_count()}}))')
    main = text[text.index("def main()"):text.index("def compare(")]
    assert main.index('"--tp-worker" in args') < main.index("torch.cuda.is_available()")


def test_grad_errors_refuse_a_one_sided_zero():
    """Phase 12's gradient comparison: max |dg| / max |g| per parameter, and
    a failure where one side's gradient is all zero (or not finite) and the
    other's is not."""
    import pytest
    import torch

    smoke = _smoke()
    want = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([0.5, 0.5])}
    rels = smoke.grad_errors(torch, {"a": torch.tensor([1.0, -1.9]), "b": want["b"]}, want)
    assert rels == pytest.approx({"a": 0.05, "b": 0.0})
    for bad in (torch.zeros(2), torch.tensor([float("nan"), 0.5])):
        with pytest.raises(smoke.SmokeFailure):
            smoke.grad_errors(torch, {"a": want["a"], "b": bad}, want)



def test_worst_by_group_splits_the_encoder_attention_leaves():
    """Phase 12's two gradient bounds: the encoder's attention q/k/v weights
    and biases form one group, every other parameter (the decoder's q/k/v,
    the encoder's o) the other; each group gives its largest error and its
    parameter."""
    smoke = _smoke()
    rels = {"encoder.blocks.0.attn.q.w": 0.01, "encoder.blocks.31.attn.v.b": 0.03,
            "encoder.blocks.3.attn.k.w": 0.02, "encoder.blocks.0.attn.o.w": 0.5,
            "decoder.blocks.0.attn.k.w": 0.08, "decoder.blocks.0.cross_attn.q.w": 0.04}
    assert smoke.worst_by_group(rels) == {
        "attention": (0.03, "encoder.blocks.31.attn.v.b"),
        "rest": (0.5, "encoder.blocks.0.attn.o.w")}


def test_planted_fault_spoils_only_the_q_and_k_gradients():
    """Phase 12's stand-ins for ``FlashAttention`` on CPU tensors (its
    forward takes the plain version there): the plain path's gradient equals
    ``FlashAttention``'s to 1e-5 (fp32), and the planted fault, a backward
    without its rowsum term, keeps dv and is off by O(1) of max |g| in dq
    and dk, far above the phase's bound for those leaves."""
    import torch

    from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import FlashAttention

    smoke = _smoke()
    plain, no_rowsum = smoke.attention_variants(torch)
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((2, 3, 40, 64), generator=g) for _ in range(4))
    q = q * 0.3  # softmax not one-hot
    k = k + 1.0  # a mean key: the dropped term D * mean(k) is large

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(dout)
        return [t.grad for t in leaves]

    want = grads(plain.apply)
    for got, w in zip(grads(FlashAttention.apply), want):
        assert ((got - w).abs().max() / w.abs().max()).item() <= 1e-5
    faulty = [((got - w).abs().max() / w.abs().max()).item()
              for got, w in zip(grads(no_rowsum.apply), want)]
    assert faulty[2] <= 1e-5
    assert min(faulty[:2]) > 10 * smoke.TRAIN_GRAD_TOL_ATTN, faulty


def test_tp_decode_check_holds_a_divergence_to_twice_the_drift():
    """Phase 12 (b): a tp rank's decode equal to the unsharded one passes; a
    window that differs passes where the unsharded top-two margin at its
    first differing token is within twice the teacher-forced drift, and
    fails where it is above."""
    import pytest
    import torch

    smoke = _smoke()
    want = torch.arange(2 * 16).reshape(2, 16)
    forced = torch.zeros((2, 16, 8))
    margins = torch.full((2, 16), 0.5)
    margins[1, 5] = 0.01
    ref = {"tokens": want, "forced": forced, "margins": margins, "s": 1.0}
    drifted = forced.clone()
    drifted[0, 3, 2] = 0.02  # drift 0.02: twice it is 0.04

    def out(tokens):
        return {"tokens_int4": tokens, "forced_int4": drifted, "decode_int4_s": 1.0}

    smoke.tp_decode_check(torch, 0, "int4", ref, out(want.clone()), "card")
    flip = want.clone()
    flip[1, 5:] = -1  # window 1 from token 5, where the margin is 0.01
    smoke.tp_decode_check(torch, 0, "int4", ref, out(flip), "card")
    flip[1, 4] = -1  # from token 4, where the margin is 0.5
    with pytest.raises(smoke.SmokeFailure):
        smoke.tp_decode_check(torch, 0, "int4", ref, out(flip), "card")


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


def test_phase_thirteen_runs_after_twelve_and_requires_its_checks():
    """Phase 13 (the engine over a mesh) runs after phase 12 and before the
    kernels line; a rank starts before the CUDA check only as
    ``--mesh-worker``; its paths ``engine_tp`` and ``engine_sp`` are set from
    rank 0's counts and their kernels ``need_launched``; the decode, segment,
    kernel and K2-shape checks are ``require``d, not printed; K2's JSON row
    carries its sp form with the launches of ``engine_sp``."""
    smoke = _smoke()
    text = (ROOT / "chip_smoke.py").read_text()
    run_body = text[text.index("def run(torch, np"):text.index("def voiced_like(")]
    order = [run_body.index(k) for k in (
        "training_phase(torch, np, paths, card)", "mesh_phase(torch, np, model, paths, card)",
        "print(json.dumps({\"kernels\": kernels_json}))")]
    assert order == sorted(order)
    assert '"sp_form"' in run_body and 'paths["engine_sp"][name]' in run_body
    main = text[text.index("def main()"):text.index("def compare(")]
    assert main.index('"--mesh-worker"') < main.index("torch.cuda.is_available()")
    assert dict(smoke.MESH_SHAPES) == {"engine_tp": "1x2", "engine_sp": "1x1x2"}
    phase = text[text.index("def mesh_phase("):text.index("def mesh_worker(")]
    for needle in ("paths[path] = got[\"launches\"]", "need_launched(paths, path, names)",
                   "require(err <= tol", "equal decodes, other segments", "alignment scores off by",
                   "K2's last call was not a rank's half"):
        assert needle in phase, needle
    check = text[text.index("def mesh_decode_check("):text.index("def mesh_phase(")]
    assert check.count("require(") >= 3


def test_mesh_decode_check_holds_a_divergence_to_its_drift():
    """Phase 13's rule: a decode equal to the yardstick's passes; a greedy
    decode that differs passes where the unsharded top-two margin at its
    first differing token is within twice the teacher-forced drift and fails
    above it; a beam 5 choice that differs passes where the two average
    log-probabilities lie within four times the drift and fails beyond."""
    import numpy as np
    import pytest
    import torch

    smoke = _smoke()
    sb = 3
    row = np.arange(20)
    forced = torch.zeros((19, 8))
    drifted = forced.clone()
    drifted[5, 2] = 0.02  # drift 0.02
    margins = {j: (0.01 if j == 4 else 0.5) for j in range(17)}
    yard = (sb, row, -1.0)
    smoke.mesh_decode_check(torch, "1x2", "lone", yard, [(sb, row.copy(), -1.0)], forced,
                            drifted, margins.get)
    flip = row.copy()
    flip[sb + 4:] = -1  # from token 4, where the margin is 0.01 <= 0.04
    equal, total, drift = smoke.mesh_decode_check(torch, "1x2", "pair", yard,
                                                  [(sb, row.copy(), -1.0), (sb, flip, -1.0)],
                                                  forced, drifted, margins.get)
    assert (equal, total) == (1, 2) and drift == pytest.approx(0.02)
    flip[sb + 3] = -1  # from token 3, where the margin is 0.5
    with pytest.raises(smoke.SmokeFailure):
        smoke.mesh_decode_check(torch, "1x2", "lone", yard, [(sb, flip, -1.0)], forced,
                                drifted, margins.get)
    smoke.mesh_decode_check(torch, "1x2", "beam", yard, [(sb, flip, -1.05)], forced, drifted,
                            margins.get)
    with pytest.raises(smoke.SmokeFailure):
        smoke.mesh_decode_check(torch, "1x2", "beam", yard, [(sb, flip, -1.2)], forced, drifted,
                                margins.get)
