"""The Whisper family: encoder-decoder speech models in the Hugging Face
layout of ``WhisperForConditionalGeneration`` (large-v3, large-v3-turbo),
served by the port's ``SttEngine`` over 30 s windows with cross attention.

  * ``build``: ``system.build`` (weights from the seed, or from the cell's
    fixed ``weights_seed``, through the port's HF loader, the engine,
    ``warmup()``);
  * ``tap``: ``decode_tap.DecodeTap`` (each decoded window: prompt, served
    tokens, reported log-probabilities, strategy, route);
  * ``describe``: the decode graph classes captured so far;
  * ``judge``: ``compare.Judge`` over ``reference.Reference`` on a sample of
    the windows, from the raw weights made again from the same seed;
  * ``served_flops``: ``flops.window_flops`` of each decoded window.
"""

from __future__ import annotations

import torch

from . import flops, system
from .compare import Judge, assign_starts, sample_windows
from .decode_tap import DecodeTap

build = system.build
tap = DecodeTap


def describe(engine) -> dict:
    """Decode graph classes captured so far: the engine's own and the beam
    gang's (the batcher's pools capture theirs when they are built)."""
    gang = engine._beam_gang
    return {"engine": len(engine.graphs.stats()),
            "gang": len(gang.graphs.stats()) if gang is not None else 0,
            "pools": len(engine._batchers)}


def judge(records: list, config: dict, workload: dict, seed: int, device: str,
          control: bool = False) -> dict:
    """The numbers compared over ``records`` (those that came back without
    error): a sample of ``check.windows`` placed windows drawn from the
    seed, through the reference at the configuration's precision and, with
    ``control``, also one precision below (int4 weights)."""
    for r in records:
        assign_starts(r)
    state = system.make_state(config, system.weights_seed(workload, seed), torch.device(device))
    language = workload["mix"]["language"]
    ref = Judge(state, config, language)
    pairs = sample_windows(records, workload["check"]["windows"], seed)
    ctl = Judge(state, config, language, weight_bits=4) if control else None
    return ref.readings(pairs, control=ctl)


def served_flops(config: dict, record) -> float:
    """Each decoded window encoded at its full positions, its cross K/V, and
    its prompt and served tokens through every decoder layer and the tied
    logits, once a beam."""
    return sum(flops.window_flops(config, len(w["prompt"]) + len(w["tokens"]), w["beam"])
               for w in record.windows)
