"""The port against HuggingFace transformers' Whisper (the JAX package's
``tests/test_hf_parity.py``, held here for the PyTorch port): a small
random-init ``WhisperForConditionalGeneration`` (no download), its weights
mapped through ``checkpoint/safetensors_io.params_from_hf_state``; the mel
frontend against HF's feature extractor, the encoder, teacher-forced
decoder logits, a stepwise decode (``decoder_step``) and a token-exact
greedy loop (``decode_window``) against a torch loop driven by HF's own
logits processors. Tolerances are the JAX package's: mel 5e-4, encoder
2e-3 (+1e-3 relative), logits 5e-3 (+1e-3 relative) with the argmax equal
at every position."""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from sentiric_stt_whisper_service_tpu_torch.checkpoint.safetensors_io import (  # noqa: E402
    params_from_hf_state,
)
from sentiric_stt_whisper_service_tpu_torch.models.whisper import (  # noqa: E402
    decoder_apply,
    decoder_step,
    encoder_apply,
    init_kv_cache,
    precompute_xa_kv,
)
from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse fixture)

DEC_IDS = np.array([[50258, 50259, 50359, 123, 4567, 891]], np.int64)


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    cfg = transformers.WhisperConfig(
        vocab_size=51865, num_mel_bins=80, d_model=128, encoder_layers=2,
        encoder_attention_heads=2, decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=512, decoder_ffn_dim=512, max_source_positions=1500,
        max_target_positions=448,
    )
    return transformers.WhisperForConditionalGeneration(cfg).eval()


@pytest.fixture(scope="module")
def mapped(hf_model):
    state = {k: v.detach().numpy() for k, v in hf_model.model.state_dict().items()}
    cfg, model = params_from_hf_state(state, dtype=torch.float32)
    assert cfg.n_audio_head == 2 and cfg.n_text_head == 2
    return cfg, model


@pytest.fixture(scope="module")
def mel():
    audio = (np.random.default_rng(0).standard_normal(480000) * 0.1).astype(np.float32)
    return audio, compute_log_mel(torch.from_numpy(audio)).numpy()  # [3000, 80]


def hf_logits(hf_model, mel):
    with torch.no_grad():
        return hf_model(input_features=torch.from_numpy(mel.T[None]).float(),
                        decoder_input_ids=torch.from_numpy(DEC_IDS)).logits.numpy()[0]


def test_mel_matches_hf_feature_extractor(mel):
    audio, got = mel
    want = transformers.WhisperFeatureExtractor()(
        audio, sampling_rate=16000, return_tensors="np").input_features[0].T
    assert got.shape == want.shape == (3000, 80)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_encoder_matches_hf(hf_model, mapped, mel):
    cfg, model = mapped
    _, m = mel
    with torch.no_grad():
        want = hf_model.model.encoder(torch.from_numpy(m.T[None]).float()).last_hidden_state
        got = encoder_apply(cfg, model, torch.from_numpy(m[None]))
    assert got.shape == want.shape == (1, 1500, 128)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=2e-3, rtol=1e-3)


def test_decoder_logits_match_hf(hf_model, mapped, mel):
    cfg, model = mapped
    _, m = mel
    want = hf_logits(hf_model, m)
    with torch.inference_mode():
        xa_kv = precompute_xa_kv(cfg, model, encoder_apply(cfg, model, torch.from_numpy(m[None])))
        logits, _ = decoder_apply(cfg, model, torch.from_numpy(DEC_IDS), 0,
                                  init_kv_cache(cfg, 1), xa_kv)
    got = logits[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_stepwise_decode_matches_hf(hf_model, mapped, mel):
    """Teacher-forced token by token through ``decoder_step`` (one token at
    a device position, the cross read's step form) against HF's logits of
    the whole sequence."""
    cfg, model = mapped
    _, m = mel
    want = hf_logits(hf_model, m)
    got = []
    with torch.inference_mode():
        xa_kv = precompute_xa_kv(cfg, model, encoder_apply(cfg, model, torch.from_numpy(m[None])))
        kv = init_kv_cache(cfg, 1, 64)
        for i in range(DEC_IDS.shape[1]):
            logits, kv = decoder_step(cfg, model, torch.from_numpy(DEC_IDS[:, i]),
                                      torch.tensor([i]), kv, xa_kv)
            got.append(logits[0].numpy())
    got = np.stack(got)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_greedy_decode_loop_token_exact_vs_hf(hf_model, mapped, mel):
    """The port's ``decode_window`` (suppression, begin suppression, the
    timestamp rules, argmax) against a torch greedy loop over HF's logits
    with HF's processors (SuppressTokens, SuppressTokensAtBegin,
    WhisperTimeStamp): every sampled token equal, the rules feeding back
    through the loop."""
    from transformers import GenerationConfig
    from transformers.generation.logits_process import (
        SuppressTokensAtBeginLogitsProcessor,
        SuppressTokensLogitsProcessor,
        WhisperTimeStampLogitsProcessor,
    )

    from sentiric_stt_whisper_service_tpu_torch.models import (
        TokenIds,
        build_suppress_mask,
        decode_window,
        encode_xa_kv,
    )
    from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

    cfg, model = mapped
    _, m = mel
    tok = fallback_tokenizer(cfg.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sup = build_suppress_mask(cfg.n_vocab, ids, tok.non_speech_tokens)
    sot = list(tok.sot_sequence("en"))
    sample_begin = len(sot)
    max_new = 24  # random weights rarely emit EOT; bound the loop

    tinit = torch.full((1, cfg.n_text_ctx), ids.eot, dtype=torch.int64)
    tinit[0, :sample_begin] = torch.tensor(sot)
    with torch.inference_mode():
        xa_kv = encode_xa_kv(cfg, model, torch.from_numpy(m[None]))
        res = decode_window(cfg, model, xa_kv, tinit, sample_begin, 0, ids,
                            torch.from_numpy(sup), max_len=sample_begin + max_new)
    ours = res.tokens[0, sample_begin:int(res.lengths[0])].tolist()
    if ours and ours[-1] == ids.eot:
        ours = ours[:-1]

    gen_cfg = GenerationConfig(eos_token_id=ids.eot, no_timestamps_token_id=ids.no_timestamps,
                               max_initial_timestamp_index=ids.max_initial_timestamp_index)
    procs = [
        SuppressTokensLogitsProcessor(np.where(np.isneginf(sup))[0].tolist()),
        SuppressTokensAtBeginLogitsProcessor([tok.encode(" ")[0], ids.eot], sample_begin),
        WhisperTimeStampLogitsProcessor(gen_cfg, begin_index=sample_begin),
    ]
    seq, theirs = list(sot), []
    with torch.no_grad():
        enc = hf_model.model.encoder(torch.from_numpy(m.T[None]).float()).last_hidden_state
        for _ in range(max_new):
            dec_in = torch.tensor([seq])
            logits = hf_model(encoder_outputs=(enc,), decoder_input_ids=dec_in).logits[:, -1]
            for p in procs:
                logits = p(dec_in, logits.float())
            nxt = int(logits.argmax(-1))
            if nxt == ids.eot:
                break
            theirs.append(nxt)
            seq.append(nxt)
    assert ours  # EOT and blank are barred at the start: at least one token
    assert ours == theirs
