"""What a Whisper engine decoded, read at the program's boundary: each
window a request decoded, with its prompt, the tokens served, the
log-probabilities the engine reports for them, the decoding strategy, the
window's last position (``max_len``: the beam gang's ``GangKey`` or the
``decode`` op's argument) and the route (the continuous batcher, whose pool
holds an int8 cross slab, or the engine's other routes).

:class:`DecodeTap` wraps ``SttEngine._decode_one`` (every single-window
route: the batcher, the beam gang, the engine's own graph classes),
``SttEngine._decode_batched`` (to name the batcher's route),
``SttEngine._get_beam_gang`` (the gang's ``submit``, for its ``GangKey``)
and, for the batched long-form path, the engine's ``decode`` op
(``_replay.call("decode", ...)``). The public ``TranscriptionResult``
carries token texts and probabilities but no ids. It is installed on one
engine and removed with :meth:`~DecodeTap.remove`.
"""

from __future__ import annotations

import threading


class DecodeTap:
    """Collects decoded windows into the record that the calling thread
    names with :meth:`bind`."""

    def __init__(self, engine):
        self.engine = engine
        self._local = threading.local()
        one, batched, call = engine._decode_one, engine._decode_batched, engine._replay.call
        get_gang = engine._get_beam_gang
        self._gangs = []
        tap = self

        def decode_one(xa_kv, init_tokens, sample_begin, sot_index, temperature, beam_size,
                       best_of, *args, **kwargs):
            local = tap._local
            local.depth = getattr(local, "depth", 0) + 1
            local.route = "engine"
            local.max_len = None
            try:
                res = one(xa_kv, init_tokens, sample_begin, sot_index, temperature, beam_size,
                          best_of, *args, **kwargs)
            finally:
                local.depth -= 1
            tap._add(res, 0, list(init_tokens), sample_begin, temperature, beam_size,
                     local.route, "one")
            return res

        def decode_batched(*args, **kwargs):
            tap._local.route = "batcher"
            return batched(*args, **kwargs)

        def replay_call(name, *args, **kwargs):
            # decode: (xa_kv, tinit, sample_begin, sot_index, t, beam, best_of, max_len, ...)
            if name == "decode":
                tap._local.max_len = int(args[7])
            out = call(name, *args, **kwargs)
            if name == "decode" and getattr(tap._local, "depth", 0) == 0 and out is not None:
                tinit, sample_begin, temperature, beam = args[1], args[2], args[4], args[5]
                for row in range(tinit.shape[0]):
                    tap._add(out, row, [int(x) for x in tinit[row, :sample_begin]],
                             sample_begin, temperature, beam, "engine", "batched")
            return out

        def get_beam_gang():
            gang = get_gang()
            if gang is not None and "submit" not in gang.__dict__:
                submit = gang.submit

                def tapped_submit(xa_kv, tokens_row, key, *args, **kwargs):
                    tap._local.max_len = int(key.max_len)
                    return submit(xa_kv, tokens_row, key, *args, **kwargs)

                gang.submit = tapped_submit
                tap._gangs.append(gang)
            return gang

        engine._decode_one = decode_one
        engine._decode_batched = decode_batched
        engine._get_beam_gang = get_beam_gang
        engine._replay.call = replay_call

    def remove(self) -> None:
        for name in ("_decode_one", "_decode_batched", "_get_beam_gang"):
            self.engine.__dict__.pop(name, None)
        self.engine._replay.__dict__.pop("call", None)
        for gang in self._gangs:
            gang.__dict__.pop("submit", None)

    def bind(self, record) -> None:
        """Windows decoded by this thread from now on go to ``record``
        (an object with a ``windows`` list), or nowhere for None."""
        self._local.record = record

    def _add(self, res, row, prompt, sample_begin, temperature, beam, route, path) -> None:
        record = getattr(self._local, "record", None)
        if record is None or res is None:
            return
        end = int(res.lengths[row])
        seq = [int(x) for x in res.tokens[row, sample_begin:end]]
        lps = [float(x) for x in res.token_logprobs[row, sample_begin:end]]
        record.windows.append(dict(prompt=prompt, tokens=seq, logprobs=lps, row=row,
                                   temperature=float(temperature), beam=int(beam),
                                   route=route, path=path,
                                   max_len=getattr(self._local, "max_len", None)))
