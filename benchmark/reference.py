"""The plain reference: Whisper's published forward pass in float32 PyTorch,
the frontend, and the decoding rules, written from the published
descriptions and independent of the program under test.

It imports nothing of the program. It takes the raw weights in the public
Hugging Face layout (``model.encoder.layers.N.self_attn.q_proj.weight``,
...) and the raw audio, and works out again whatever the program derives
from them at the precision the configuration states:

  * weight-only quantization of every transformer-block linear layer,
    symmetric per output channel (``qmax`` 127 for int8, 7 for the int4
    control), and of the token embedding per row; conv stems, position
    embeddings and layer norms stay as given;
  * the cross-attention K/V quantized per (layer, head, position) over the
    head dimension (4 bits: the packed int4 carrier's values; 8: an int8
    slab's);
  * the decoder's self-attention K/V rounded to float8 e4m3 (``self_fp8``);
  * everything else in float32, with TF32 off.

Sources: Radford et al. 2022, "Robust Speech Recognition via Large-Scale
Weak Supervision" (the architecture, the log-mel frontend, the suppression
and timestamp rules of openai-whisper's ``decoding.py``); the model cards
and ``config.json`` of ``openai/whisper-large-v3`` and
``openai/whisper-large-v3-turbo`` (sizes, tensor names).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
WINDOW_SAMPLES = 30 * SAMPLE_RATE
NEG = float("-inf")


# ---------------------------------------------------------------- frontend


def resample_to_16k(pcm: np.ndarray, rate: int) -> np.ndarray:
    """float audio at ``rate`` → 16 kHz (scipy's polyphase ``resample_poly``,
    its default Kaiser window)."""
    if rate == SAMPLE_RATE:
        return np.asarray(pcm, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(rate, SAMPLE_RATE)
    return resample_poly(np.asarray(pcm, np.float64), SAMPLE_RATE // g,
                         rate // g).astype(np.float32)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27),
                    lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0)),
                    m * (200.0 / 3))


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa's Slaney mel filterbank (``htk=False, norm="slaney"``), the
    filters openai-whisper ships: [n_mels, N_FFT // 2 + 1]."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    out = np.zeros((n_mels, freqs.size))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        rise = (freqs - lo) / (c - lo)
        fall = (hi - freqs) / (hi - c)
        out[m] = np.maximum(0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return out.astype(np.float32)


def log_mel(window: torch.Tensor, n_mels: int) -> torch.Tensor:
    """openai-whisper's ``log_mel_spectrogram`` of one 30 s window
    [480000] → [3000, n_mels]."""
    win = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32, device=window.device)
    spec = torch.stft(window.float(), N_FFT, HOP, window=win, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec[:, :-1].abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).to(window.device)
    logm = torch.clamp(fb @ power, min=1e-10).log10()
    logm = torch.maximum(logm, logm.max() - 8.0)
    return ((logm + 4.0) / 4.0).T


def window_audio(pcm16: np.ndarray, rate: int, start: int) -> np.ndarray:
    """The 30 s window of a request that starts ``start`` samples (16 kHz)
    into it: int16 PCM → float → 16 kHz → the slice, zero-padded."""
    audio = resample_to_16k(np.asarray(pcm16, np.int16).astype(np.float32) / 32768.0, rate)
    out = np.zeros(WINDOW_SAMPLES, np.float32)
    part = audio[start:start + WINDOW_SAMPLES]
    out[:part.size] = part
    return out


# ---------------------------------------------------------------- weights


def quantize_rows(w: torch.Tensor, qmax: int) -> torch.Tensor:
    """Symmetric quantization of each row of ``w`` (an output channel of an
    HF ``[out, in]`` weight, or a token's embedding), returned dequantized
    in float32: round half to even, clipped to ±qmax, scale max|row| / qmax
    (at least 1e-12)."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / qmax, min=1e-12)
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def quantize_positions(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Cross-attention K or V [H, hd, T] quantized per (head, position) over
    hd, dequantized: scale max|x| / qmax (at least 1e-12), round half to
    even, clipped to ±qmax."""
    qmax = 7.0 if bits == 4 else 127.0
    scale = torch.clamp(x.abs().amax(dim=1, keepdim=True) * (1.0 / qmax), min=1e-12)
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


class Reference:
    """Whisper over HF-named weights ``state`` (on the device the reference
    runs on). ``weight_bits`` 8 is the configuration's int8; 4 is the
    control one step below it."""

    def __init__(self, state: dict, dims: dict, weight_bits: int = 8, self_fp8: bool = True):
        self.dims = dims
        self.self_fp8 = self_fp8
        qmax = 127 if weight_bits == 8 else 7
        self.w = {}
        for name, t in state.items():
            key = name[len("model."):] if name.startswith("model.") else name
            quantized = (".layers." in key and key.endswith(".weight") and t.dim() == 2) or (
                key == "decoder.embed_tokens.weight")
            self.w[key] = quantize_rows(t, qmax) if quantized else t.float()
        self.n_audio_layer = 1 + max(int(k.split(".")[2]) for k in self.w
                                     if k.startswith("encoder.layers."))
        self.n_text_layer = 1 + max(int(k.split(".")[2]) for k in self.w
                                    if k.startswith("decoder.layers."))

    def _lin(self, x, name, bias=True):
        y = x @ self.w[name + ".weight"].T
        return y + self.w[name + ".bias"] if bias else y

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"],
                            eps=1e-5)

    def _heads(self, x):
        h = self.dims["heads"]
        return x.reshape(*x.shape[:-1], h, -1).transpose(-3, -2)  # [..., H, T, hd]

    def _attend(self, q, k, v, causal=False):
        scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if causal:
            t = scores.shape[-1]
            scores = scores.masked_fill(
                torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1), NEG)
        out = (torch.softmax(scores, dim=-1) @ v).transpose(-3, -2)  # [..., T, H, hd]
        return out.reshape(*out.shape[:-2], -1)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [3000, n_mels] → audio features [1500, d]."""
        x = mel.float().T[None]
        x = F.gelu(F.conv1d(x, self.w["encoder.conv1.weight"], self.w["encoder.conv1.bias"],
                            padding=1))
        x = F.gelu(F.conv1d(x, self.w["encoder.conv2.weight"], self.w["encoder.conv2.bias"],
                            stride=2, padding=1))
        x = x[0].T + self.w["encoder.embed_positions.weight"][: x.shape[-1]]
        for i in range(self.n_audio_layer):
            p = f"encoder.layers.{i}"
            y = self._ln(x, p + ".self_attn_layer_norm")
            q = self._heads(self._lin(y, p + ".self_attn.q_proj"))
            k = self._heads(self._lin(y, p + ".self_attn.k_proj", bias=False))
            v = self._heads(self._lin(y, p + ".self_attn.v_proj"))
            x = x + self._lin(self._attend(q, k, v), p + ".self_attn.out_proj")
            y = self._ln(x, p + ".final_layer_norm")
            x = x + self._lin(F.gelu(self._lin(y, p + ".fc1")), p + ".fc2")
        return self._ln(x, "encoder.layer_norm")

    def cross_kv(self, xa: torch.Tensor, bits: int) -> list:
        """Each decoder layer's cross K/V [H, T, hd], quantized to ``bits``
        (4 or 8; 0 leaves them in float32)."""
        out = []
        for i in range(self.n_text_layer):
            p = f"decoder.layers.{i}.encoder_attn"
            kv = []
            for name, bias in (("k_proj", False), ("v_proj", True)):
                t = self._heads(self._lin(xa, f"{p}.{name}", bias))  # [H, T, hd]
                if bits:
                    t = quantize_positions(t.transpose(1, 2), bits).transpose(1, 2)
                kv.append(t)
            out.append(kv)
        return out

    def logits(self, tokens: torch.Tensor, xkv: list, last: bool = False) -> torch.Tensor:
        """Teacher-forced decoder over ``tokens`` [T] (or a batch [N, T] of
        equal lengths) → logits [T, V] (position i predicts token i + 1),
        or with ``last`` those of the last position alone."""
        T = tokens.shape[-1]
        emb = self.w["decoder.embed_tokens.weight"]
        x = emb[tokens] + self.w["decoder.embed_positions.weight"][:T]
        for i in range(self.n_text_layer):
            p = f"decoder.layers.{i}"
            y = self._ln(x, p + ".self_attn_layer_norm")
            q = self._heads(self._lin(y, p + ".self_attn.q_proj"))
            k = self._heads(self._lin(y, p + ".self_attn.k_proj", bias=False))
            v = self._heads(self._lin(y, p + ".self_attn.v_proj"))
            if self.self_fp8:
                k = k.to(torch.float8_e4m3fn).float()
                v = v.to(torch.float8_e4m3fn).float()
            x = x + self._lin(self._attend(q, k, v, causal=True), p + ".self_attn.out_proj")
            y = self._ln(x, p + ".encoder_attn_layer_norm")
            q = self._heads(self._lin(y, p + ".encoder_attn.q_proj"))
            x = x + self._lin(self._attend(q, *xkv[i]), p + ".encoder_attn.out_proj")
            y = self._ln(x, p + ".final_layer_norm")
            x = x + self._lin(F.gelu(self._lin(y, p + ".fc1")), p + ".fc2")
        if last:
            x = x[..., -1, :]
        return self._ln(x, "decoder.layer_norm") @ emb.T


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32, restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------- decoding rules


class Vocab:
    """Whisper's special-token layout for a vocabulary of ``n_vocab`` ids,
    over the byte-level vocabulary the benchmark serves (256 byte tokens,
    then filler ids up to the base size): eot at the base size, then sot,
    the languages, translate, transcribe, startoflm, startofprev, nospeech,
    notimestamps and 1501 timestamps."""

    LANGS_V3 = 100

    def __init__(self, n_vocab: int):
        n_langs = self.LANGS_V3 if n_vocab == 51866 else 99
        self.eot = n_vocab - 1501 - 8 - n_langs
        self.sot = self.eot + 1
        self.lang0 = self.eot + 2
        self.transcribe = self.lang0 + n_langs + 1
        self.timestamp_begin = self.lang0 + n_langs + 6
        self.n_vocab = n_vocab
        self.blank = ord(" ")

    def prompt(self, lang_index: int) -> list:
        """[sot, language, transcribe]: the preamble of a first window with
        timestamps."""
        return [self.sot, self.lang0 + lang_index, self.transcribe]

    def non_speech(self) -> list:
        """openai-whisper's ``non_speech_tokens`` over the byte vocabulary: a
        symbol that is one token is suppressed; of the musical signs, the
        first token (their first UTF-8 byte, and the space before one)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split())
        misc = set("♩♪♫♬♭♮♯")
        out = set()
        for sym in symbols + sorted(misc):
            for text in (sym, " " + sym):
                ids = list(text.encode("utf-8"))
                if len(ids) == 1:
                    out.add(ids[0])
                elif sym in misc:
                    out.add(ids[0])
        for text in (" -", " '"):
            ids = list(text.encode("utf-8"))
            if len(ids) == 1:
                out.add(ids[0])
        return sorted(out)

    def static_mask(self, device) -> torch.Tensor:
        """Always-suppressed ids: every special id from sot up to the first
        timestamp (eot excepted) and the non-speech symbols."""
        m = torch.zeros(self.n_vocab, device=device)
        m[self.sot:self.timestamp_begin] = NEG
        m[self.non_speech()] = NEG
        return m


def allowed_logits(z: torch.Tensor, seq: list, sample_begin: int, vocab: Vocab,
                   static: torch.Tensor, max_initial: int = 50) -> torch.Tensor:
    """The logits of the position that samples token ``len(seq)`` with
    every rule applied that the history decides (suppression, blank and
    eot at the first sample, timestamp pairing, monotonic timestamps, the
    first token a timestamp of at most ``max_initial`` steps). The rule
    that the logits decide (timestamps forced when their total probability
    beats the best text token) is left to :func:`token_gap`."""
    tb = vocab.timestamp_begin
    z = z + static
    n = len(seq) - sample_begin
    if n == 0:
        z[vocab.blank] = NEG
        z[vocab.eot] = NEG
        z[:tb] = NEG
        z[tb + max_initial + 1:] = NEG
        return z
    last_ts = seq[-1] >= tb
    penult_ts = n < 2 or seq[-2] >= tb
    if last_ts and penult_ts:
        z[tb:] = NEG
    elif last_ts:
        keep = z[vocab.eot].clone()
        z[:tb] = NEG
        z[vocab.eot] = keep
    stamps = [t for t in seq[sample_begin:] if t >= tb]
    if stamps:
        floor = max(stamps) if (last_ts and not penult_ts) else max(stamps) + 1
        z[tb:floor] = NEG
    return z


def _kth(x: torch.Tensor, k: int) -> float:
    finite = x[torch.isfinite(x)]
    if finite.numel() == 0:
        return NEG
    return float(torch.topk(finite, min(k, finite.numel())).values[-1])


def token_gap(z: torch.Tensor, token: int, tb: int, rank: int = 1) -> float:
    """How far the reference's logits ``z`` (history rules applied) lie from
    serving ``token`` as a choice among the ``rank`` best: the least logit
    distance over the two ways the forced-timestamp rule can go, 0 when the
    reference itself would serve it, infinite when a rule bars it.

    Without forcing, the token must be among the ``rank`` best of all
    allowed ids, and if the reference would force timestamps, the margin by
    which it would counts too; with forcing (a timestamp token only), the
    token must be among the ``rank`` best timestamps, plus the margin by
    which the reference would not force."""
    if not math.isfinite(float(z[token])):
        return math.inf
    zt = float(z[token])
    lse_ts = float(torch.logsumexp(z[tb:], 0))
    max_text = float(z[:tb].max())
    force_margin = lse_ts - max_text  # > 0: the reference forces timestamps
    free = max(0.0, _kth(z, rank) - zt, force_margin)
    if token < tb:
        return free
    forced = max(0.0, _kth(z[tb:], rank) - zt, -force_margin)
    return min(free, forced)


def logprob_pair(z: torch.Tensor, token: int, tb: int) -> tuple:
    """The reference's log-probabilities of ``token`` under the processed
    distribution (history rules applied): (without forcing, with
    timestamps forced, or None for a text token)."""
    free = float(z[token] - torch.logsumexp(z, 0))
    if token < tb:
        return free, None
    return free, float(z[token] - torch.logsumexp(z[tb:], 0))


def first_choice(z: torch.Tensor, tb: int) -> int:
    """The token a greedy decoder serves from ``z`` (history rules applied):
    timestamps forced when their total probability beats the best text."""
    if float(torch.logsumexp(z[tb:], 0)) > float(z[:tb].max()):
        return tb + int(torch.argmax(z[tb:]))
    return int(torch.argmax(z))


def processed(z: torch.Tensor, seq: list, sample_begin: int, vocab: Vocab,
              static: torch.Tensor) -> torch.Tensor:
    """The logits a decoder samples from at the position after ``seq``:
    :func:`allowed_logits`, and text barred where the timestamps' total
    probability beats the best text token."""
    z = allowed_logits(z.clone(), seq, sample_begin, vocab, static)
    tb = vocab.timestamp_begin
    if float(torch.logsumexp(z[tb:], 0)) > float(z[:tb].max()):
        z[:tb] = NEG
    return z


# Faults a beam search can be given in the program's place (the calibration
# of the limit on ``beam_not_first``): "prune" keeps the candidates ranked 2 to
# K + 1 (the best dropped), "rank" ranks them by their token's own
# log-probability instead of the running score, "pick" serves the worst
# hypothesis by average log-probability.
BEAM_FAULTS = ("prune", "rank", "pick")


def beam_search(ref: Reference, xkv: list, prompt: list, beam: int, max_len: int,
                vocab: Vocab, static: torch.Tensor, fault: str = None) -> list:
    """openai-whisper's beam search (``BeamSearchDecoder`` with its
    ``MaximumLikelihoodRanker``, no length penalty, patience 1) from
    ``prompt`` up to ``max_len`` positions, over the processed logits
    (:func:`processed`): each live beam proposes its ``beam + 1`` best
    tokens (the lower id first on a tie); the ``beam`` best candidates by
    running log-probability that are not eot live on (the lower candidate
    first on a tie); an eot candidate that outranks the last of them is
    kept as finished, at most ``beam`` in all; the search ends once
    ``beam`` have finished. The winner has the best average
    log-probability over its sampled tokens (eot included) among the
    finished, the live beams joining when fewer than ``beam`` finished.
    Returns the winner's sampled tokens. ``fault``: one of
    :data:`BEAM_FAULTS`."""
    sb, eot, K = len(prompt), vocab.eot, int(beam)
    live = [(list(prompt), 0.0)]
    done = []  # (average, tokens)
    with torch.inference_mode():
        for pos in range(sb, max_len):
            z = ref.logits(torch.tensor([s for s, _ in live], device=static.device), xkv,
                           last=True).float()
            cands, eots = [], []
            for b, (seq, score) in enumerate(live):
                zr = processed(z[b], seq, sb, vocab, static)
                lps = zr - torch.logsumexp(zr, 0)
                vals, toks = torch.sort(zr, descending=True, stable=True)
                for j in range(K + 1):
                    tok, lp = int(toks[j]), float(lps[int(toks[j])])
                    if not math.isfinite(lp):
                        break
                    (eots if tok == eot else cands).append(
                        (score + lp, b * (K + 1) + j, b, tok, lp))
            key = (lambda c: (-c[4], c[1])) if fault == "rank" else (lambda c: (-c[0], c[1]))
            cands.sort(key=key)
            keep = cands[1:K + 1] if fault == "prune" else cands[:K]
            if not keep:
                break
            kth = keep[-1][0] if len(keep) == K else NEG
            for score, _, b, _, _ in sorted(eots, key=lambda c: (-c[0], c[2])):
                if score > kth and len(done) < K:
                    done.append((score / (pos + 1 - sb), live[b][0][sb:] + [eot]))
            live = [(live[b][0] + [tok], score) for score, _, b, tok, _ in keep]
            if len(done) >= K:
                break
    pool = list(done)
    if len(done) < K:
        pool += [(score / max(1, len(seq) - sb), seq[sb:]) for seq, score in live]
    pick = min if fault == "pick" else max
    return pick(pool, key=lambda c: c[0])[1]

