"""The comparison that decides ``correct``: served tokens against the plain
reference (``reference.py``), once the window has closed and the program's
state is freed.

A sample of the windows the program served, drawn from the seed with the
request that served the most tokens in it, is run once through the
reference over its prompt and served tokens (teacher-forced), from the
request's own int16 PCM: resampling, log-mel, encoder, the quantized cross
K/V, the decoder and the rules. Two numbers are compared:

  * ``token_gap``: the widest logit distance between a served token and a
    choice the decoder could make under the reference (the best token for
    greedy decoding, one of the ``beam + 1`` best a beam proposes; see
    ``reference.token_gap``); a served token that a rule bars reads
    infinite;
  * ``logprob_err``: the widest distance between the log-probability the
    engine reports for a served token (``TokenData.p`` is its exponential)
    and the reference's;
  * ``beam_not_first``: the share of the served tokens of the run's
    beam-searched windows, pooled, that are not the reference's first
    choice at their position. A sound search's winner takes the first
    choice at most steps and a lower one where that pays later; a search
    that keeps or ranks the wrong hypotheses serves lower choices far more
    often, though each token stays among the beam's and its probability
    right, which the two numbers above read.

The prompt has to be the reference's own ``[sot, language, transcribe]``.
The cross K/V is quantized as the window's route holds it: the continuous
batcher's pool is an int8 container, the engine's other routes hold the
configuration's ``compute_type`` (int4). The alignment pass (its DTW),
prosody and the VAD run on the host in numpy and are not compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as R

# Whisper's language order (openai-whisper tokenizer.py); a prompt's
# language token is ``lang0`` + the index.
LANGUAGES = ("en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro "
             "da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu "
             "is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be tg sd gu am yi lo "
             "uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln ha ba jw su yue").split()


def served(window: dict, eot: int) -> list:
    """(position offset, token, reported log-probability) of every token the
    window served: up to its first eot, which counts only where it was
    sampled (a budget's end reads 0)."""
    out = []
    for i, (tok, lp) in enumerate(zip(window["tokens"], window["logprobs"])):
        if tok == eot:
            if lp != 0.0:
                out.append((i, tok, lp))
            break
        out.append((i, tok, lp))
    return out


def cross_bits(config: dict, route: str) -> int:
    """The cross K/V precision a window's route holds under the
    configuration's ``compute_type``: the continuous batcher's pool is an
    int8 container whenever the weights are quantized; the engine's own
    routes (the gang, the batched long-form path, a lone request) hold
    the packed int4 carrier under "int4" and int8 under "int8"."""
    ct = config["settings"]["compute_type"]
    if not ct.startswith(("int4", "int8")):
        return 0
    return 4 if ct.startswith("int4") and route != "batcher" else 8


def assign_starts(record) -> None:
    """Each window's start in the request's 16 kHz audio: the batched
    long-form path decodes 30 s windows in order; a single-window request
    starts at 0. Windows of a sequential multi-window request are left
    unplaced (not judged)."""
    batched = [w for w in record.windows if w["path"] == "batched"]
    for i, w in enumerate(batched):
        w["start"] = i * 480000
    ones = [w for w in record.windows if w["path"] == "one"]
    if len(ones) == 1 and record.clip.pcm.size <= 30 * record.clip.rate:
        ones[0]["start"] = 0


def sample_windows(records: list, n: int, seed: int) -> list:
    """(record, window) pairs: the window with the most served tokens, then
    ``n - 1`` more drawn from the seed among the judged records' windows."""
    pool = [(r, w) for r in records for w in r.windows if w.get("start") is not None]
    if not pool:
        return []
    longest = max(range(len(pool)), key=lambda i: len(pool[i][1]["tokens"]))
    rest = [i for i in range(len(pool)) if i != longest]
    rng = np.random.default_rng([seed % (2 ** 63), 41])
    pick = [longest] + [int(i) for i in rng.permutation(rest)[: max(0, n - 1)]]
    return [pool[i] for i in pick]


class Judge:
    """The reference over one run's weights: ``state`` (HF names) and the
    configuration ``config``; ``weight_bits`` 8 as stated (4: the control)."""

    def __init__(self, state: dict, config: dict, language: str, weight_bits: int = 8,
                 device=None):
        self.config = config
        self.device = device or next(iter(state.values())).device
        self.vocab = R.Vocab(config["vocab_size"])
        self.static = self.vocab.static_mask(self.device)
        self.prompt = self.vocab.prompt(LANGUAGES.index(language))
        self.ref = R.Reference(state, {"heads": config["encoder_attention_heads"]}, weight_bits)

    @torch.inference_mode()
    def logits(self, record, window: dict, cross_bits: int) -> tuple:
        """(reference logits at each served position [n, V], the served
        list) of one window."""
        ref = self.ref
        xkv = self.cross(record, window, cross_bits)
        toks = served(window, self.vocab.eot)
        seq = window["prompt"] + [t for _, t, _ in toks]
        z = ref.logits(torch.tensor(seq[:-1] or seq, device=self.device), xkv)
        sb = len(window["prompt"])
        return z[sb - 1:sb - 1 + len(toks)].float(), toks

    def cross(self, record, window: dict, cross_bits: int) -> list:
        """The reference's quantized cross K/V of one window."""
        ref = self.ref
        audio = torch.from_numpy(R.window_audio(record.clip.pcm, record.clip.rate,
                                                window["start"]))
        mel = R.log_mel(audio.to(self.device), self.config["num_mel_bins"])
        return ref.cross_kv(ref.encode(mel), cross_bits)

    def searched(self, record, window: dict, bits: int, searcher, fault: str = None) -> list:
        """The tokens ``searcher``'s (a Judge's) own beam search serves for a
        window in the program's place, with ``fault`` planted (one of
        ``reference.BEAM_FAULTS``, or None): same prompt, beam and budget."""
        prompt = window["prompt"]
        max_len = window.get("max_len") or len(prompt) + len(window["tokens"])
        return R.beam_search(searcher.ref, searcher.cross(record, window, bits), prompt,
                             window["beam"], max_len, self.vocab, self.static, fault)

    @torch.inference_mode()
    def not_first(self, record, window: dict, bits: int, tokens: list) -> tuple:
        """(of ``tokens`` served after the window's prompt, those that are
        not the reference's first choice at their position, all of them):
        the first choice either way the forced-timestamp rule can go
        (``reference.token_gap`` at rank 1 reads 0)."""
        if not tokens:
            return 0, 0
        seq = list(window["prompt"]) + list(tokens)
        sb, tb = len(window["prompt"]), self.vocab.timestamp_begin
        z = self.ref.logits(torch.tensor(seq[:-1], device=self.device),
                            self.cross(record, window, bits)).float()
        n = sum(R.token_gap(R.allowed_logits(z[sb - 1 + i].clone(), seq[:sb + i], sb, self.vocab,
                                             self.static), tok, tb, 1) > 0.0
                for i, tok in enumerate(tokens))
        return n, len(tokens)

    def readings(self, pairs: list, control=None) -> dict:
        """The numbers compared over ``pairs`` of (record, window): the
        program's ``token_gap``, ``logprob_err`` and ``beam_not_first`` and,
        with ``control`` (a Judge one precision below), the control's; for
        ``beam_not_first`` the control's own beam search serves in the
        program's place, and so does the reference's with each of
        ``reference.BEAM_FAULTS`` planted."""
        out = {"token_gap": 0.0, "logprob_err": 0.0, "tokens": 0, "windows": 0}
        if control is not None:
            out.update(control_token_gap=0.0, control_logprob_err=0.0)
        share = {}  # reading → [tokens not first, beam tokens]
        tb, eot = self.vocab.timestamp_begin, self.vocab.eot
        with R.exact_float32():
            for record, window in pairs:
                bits = cross_bits(self.config, window["route"])
                z, toks = self.logits(record, window, bits)
                zc = control.logits(record, window, bits)[0] if control is not None else None
                if window["beam"] > 1:
                    searches = {}
                    if control is not None:
                        searches["control_beam_not_first"] = self.searched(
                            record, window, bits, control)
                        for f in R.BEAM_FAULTS:
                            searches[f"fault_{f}_beam_not_first"] = self.searched(
                                record, window, bits, self, f)
                    for name, tokens in searches.items():
                        n, m = self.not_first(record, window, bits, tokens)
                        acc = share.setdefault(name, [0, 0])
                        acc[0], acc[1] = acc[0] + n, acc[1] + m
                sb = len(window["prompt"])
                rank = window["beam"] + 1 if window["beam"] > 1 else 1
                seq = list(window["prompt"])
                if window["prompt"] != self.prompt:
                    out["token_gap"] = math.inf
                for i, (_, tok, lp) in enumerate(toks):
                    zr = R.allowed_logits(z[i].clone(), seq, sb, self.vocab, self.static)
                    out["token_gap"] = max(out["token_gap"], R.token_gap(zr, tok, tb, rank))
                    out["logprob_err"] = max(out["logprob_err"], _lp_err(zr, tok, lp, tb))
                    if window["beam"] > 1:
                        acc = share.setdefault("beam_not_first", [0, 0])
                        acc[0] += R.token_gap(zr, tok, tb, 1) > 0.0
                        acc[1] += 1
                    if zc is not None:
                        zcr = R.allowed_logits(zc[i].clone(), seq, sb, self.vocab, self.static)
                        first = R.first_choice(zcr, tb)
                        out["control_token_gap"] = max(out["control_token_gap"],
                                                       R.token_gap(zr, first, tb, rank))
                        out["control_logprob_err"] = max(out["control_logprob_err"],
                                                         _pair_err(zcr, zr, tok, tb))
                    seq.append(tok)
                out["tokens"] += len(toks)
                out["windows"] += 1
                if eot in seq[sb:-1]:
                    out["token_gap"] = math.inf  # tokens served after an eot
        for name, (n, m) in share.items():
            out[name] = n / m if m else 0.0
        out.setdefault("beam_not_first", 0.0)
        return out


def _lp_err(zr: torch.Tensor, tok: int, lp: float, tb: int) -> float:
    free, forced = R.logprob_pair(zr, tok, tb)
    errs = [abs(lp - free)] + ([abs(lp - forced)] if forced is not None else [])
    errs = [e for e in errs if math.isfinite(e)]
    return min(errs) if errs else math.inf


def _pair_err(zc: torch.Tensor, zr: torch.Tensor, tok: int, tb: int) -> float:
    c, r = R.logprob_pair(zc, tok, tb), R.logprob_pair(zr, tok, tb)
    errs = [abs(a - b) for a, b in zip(c, r) if a is not None and b is not None]
    errs = [e for e in errs if math.isfinite(e)]
    return min(errs) if errs else math.inf
