"""Continuous-batching decode scheduler, held against the JAX package's
``runtime/batcher.py``.

Concurrent greedy requests share one decode step over a fixed array of
``max_slots`` slots. New windows are admitted into free slots between step
chunks (all admissions of a tick share one encoder launch and one batched
prefill per prompt bucket), every step advances every live slot at its own
position, and finished slots are harvested and recycled.

Device state (S = max_slots, F = xa_ctx), allocated once on the engine's
device and zero-filled, so an empty slot's slab holds no garbage:
  tokens, tok_lps  [S, ctx]        sampled tokens and their log-probabilities
  pos, done, forced_eot, sample_begin, max_len, sum_lp, no_speech   [S]
  kv               [L, S, H, cache_len, hd]   self cache, one row per position
  xa_kv            the cross slab per slot in the pool's form: int8
                   [L, S, H, hd, F] + one scale per position [L, S, H, F]
                   (``kv_bits=4`` and ``8``, read by K3) or the compute dtype
                   (``kv_bits=0``, read by K3)
  last_logits      [S, V]           logits for each slot's next position

What differs from the JAX package:

  * **Per-slot positions.** Slot s writes its row at ``pos[s]`` and reads
    rows ``<= pos[s]`` (``models/whisper.decoder_step`` with a ``[S]``
    position). The JAX package's shared ring row is a TPU write trick and
    is not ported. Rows that a bucketed prefill wrote past a slot's prompt,
    and rows a slot's previous request left, are masked and each is
    overwritten before it is first read, so a recycled slot needs no
    clearing.
  * **The int4 pool is an int8 container**, as in the JAX package: a
    packed int4 carrier from ``submit_encoded`` is unpacked into it at
    admission (its values in [-7, 7] keep their int4 scales, so the decode
    equals the one-shot int4 path's), and a raw window is encoded at 8 bits
    and its int8 cross K/V handed back with the result. The step reads the
    container with K3. At S = 8 the large-v3 container holds 32 x 8 x 20 x
    64 x 1500 bytes = 0.49 GB each for K and V, twice the carrier. A
    request whose cross K/V fits neither form of the pool is rejected.
  * **CUDA graphs.** On the card each step replays a CUDA graph: the pool's
    state tensors are its static buffers, admission writes them eagerly
    between chunks, and there is one graph per self-cache read bound
    (``models/beam.read_bounds``), picked by the host from the largest live
    position it read at the last sync plus the chunk's steps. The graphs
    are captured when the pool is built, on the empty pool, holding the
    device lock exclusively. On the CPU, or with ``graph=False``, the same
    step runs eagerly. A capture or a replay that fails raises.

The worker thread installs each admitted request's future in its slot
before any device work, so an admission failure rejects (never orphans)
it, and polls each live request's ``should_abort`` once per chunk. Greedy
decoding only: the temperature-fallback ladder and beam search stay on the
engine's own path. ``quantize_kv=True`` with no ``kv_bits`` means
``kv_bits=8``, as in the JAX package.

**Over a mesh** (``mesh``, the mesh of a model sharded by
``parallel/mesh.shard_params``) the pool holds the shard's heads and every
rank holds every slot (dp replicates here, as in the JAX engine). One worker
tick is one op of the engine's replay channel (``replay``,
``parallel/replay.py``), carrying the tick's admissions (slot, window audio
or cross-K/V handle, prompt, ``sot_index``, ``max_tokens``), the slots its
abort polls freed, the live slots and the positions the host read: rank 0
runs the worker and decides, the other ranks run no thread and replay the
ticks. Under a tp group the step runs eagerly (``models/graphs.graphable``).

While a device trace records (``tracing``), the worker's spans have the
role ``worker``: a ``batcher.tick`` holding ``batcher.take`` (the queue and
the abort polls), ``batcher.admit`` (with the admission encode),
``batcher.chunk`` (the steps), ``batcher.readback`` (its device wait a
``to_host`` wait span) and ``batcher.harvest``; the idle wait for work is
the wait span ``batcher.idle``. Each chunk is a counter ``batcher.chunk``
(``steps``, ``live`` slots, the ``requests`` it serves) and each tick that
admits a counter ``batcher.admit`` (``admitted``, ``requests``): the
request ids are those of the ``request`` spans that submitted them.
``/debug/profile`` logs the live slots per step and the admissions per
tick, and its Chrome trace shows each counter, request ids and all, on the
worker's track.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..models.beam import read_bounds
from ..models.graphs import (
    DeviceLock,
    StepLoop,
    _capture,
    graphable,
    read_bound,
    to_device,
    to_host,
)
from ..models.sampling import NEG_INF, TokenIds, apply_timestamp_rules, prompt_bucket
from ..models.whisper import (
    WhisperConfig,
    decoder_apply,
    decoder_step,
    encoder_apply,
    init_kv_cache,
    int_view,
    precompute_xa_kv,
    text_heads,
)
from ..ops import compute_log_mel
from ..ops.quant import unpack_xa_kv
from ..parallel.replay import Replay, channel_for


@dataclasses.dataclass
class BatchState:
    """The pool's device state, updated in place (the JAX package's
    ``BatchState`` without ``ring_row``)."""

    tokens: torch.Tensor  # [S, ctx] int64
    pos: torch.Tensor  # [S] int64
    done: torch.Tensor  # [S] bool; empty slots count as done
    # True when the slot's EOT was forced at max_len (the one-shot decode
    # would simply have stopped there: no EOT sampled, so neither its
    # logprob nor a +1 in the average's denominator).
    forced_eot: torch.Tensor  # [S] bool
    sample_begin: torch.Tensor  # [S] int64
    max_len: torch.Tensor  # [S] int64
    sum_lp: torch.Tensor  # [S] f32
    tok_lps: torch.Tensor  # [S, ctx] f32
    no_speech: torch.Tensor  # [S] f32
    kv: dict
    xa_kv: dict
    last_logits: torch.Tensor  # [S, V] f32


@dataclasses.dataclass
class _Request:
    audio: Optional[np.ndarray]  # one window of samples, or None
    xa_kv: Optional[dict]  # precomputed [L, 1, ...] cross K/V, or None
    init_tokens: list
    sot_index: int
    max_tokens: int
    future: Future
    should_abort: Optional[callable] = None  # polled once per step chunk
    request: int = 0  # the submitting request's id while the tracer is on


_XA_NAMES = {4: ("k_q", "v_q", "k_scale", "v_scale"), 8: ("k_q", "v_q", "k_scale", "v_scale"),
             0: ("k", "v")}


class ContinuousBatcher:
    def __init__(
        self,
        cfg: WhisperConfig,
        params,
        ids: TokenIds,
        suppress_mask: torch.Tensor,
        max_slots: int = 8,
        cache_len: int = 256,
        steps_per_sync: int = 4,
        quantize_kv: bool = False,
        kv_bits: Optional[int] = None,
        xa_ctx: Optional[int] = None,
        self_dtype: Optional[torch.dtype] = None,
        mesh=None,
        graph: bool = True,
        device_lock: Optional[DeviceLock] = None,
        replay: Optional[Replay] = None,
    ):
        replay = channel_for(params, mesh, replay, "ContinuousBatcher")
        if kv_bits is None:
            kv_bits = 8 if quantize_kv else 0
        if kv_bits not in _XA_NAMES:
            raise ValueError(f"kv_bits must be 0, 4 or 8, got {kv_bits}")
        self.cfg, self.params, self.ids = cfg, params, ids
        self.suppress_mask = suppress_mask
        self.device = suppress_mask.device
        self.S = max_slots
        self.cache_len = cache_len
        self.steps_per_sync = steps_per_sync
        self.kv_bits = kv_bits
        self.quantize_kv = kv_bits > 0
        self.self_dtype = self_dtype
        self.xa_ctx = xa_ctx or cfg.n_audio_ctx
        if kv_bits == 4 and self.xa_ctx % 2:
            raise ValueError(f"xa_ctx {self.xa_ctx}: the int4 carrier packs position pairs, "
                             "so it must be even")
        self.bounds = read_bounds(cache_len)
        self.n_head = text_heads(cfg, params)
        self._lock = device_lock or DeviceLock()
        self._replay = replay
        self._op = f"batcher/{self.xa_ctx}"
        replay.register(self._op, self._tick_op)
        replay.register(self._op + "/reset", self._reset_op)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._slot_req: list[Optional[_Request]] = [None] * max_slots
        self._host_pos = [0] * max_slots  # each slot's position at the last sync
        with torch.inference_mode():
            self.state = self._init_state()
            self._loop = StepLoop(self.state, {}, self._step_fn())
            self.graph_pool_bytes = 0
            if graph and graphable(params) and self.device.type == "cuda":
                with self._lock.exclusive():
                    self.graph_pool_bytes = _capture(self._loop, self.bounds,
                                                     torch.cuda.graph_pool_handle())
        self.pool_bytes = sum(t.numel() * t.element_size() for t in self._tensors())
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = None
        if replay.leader:  # the other ranks of a mesh replay rank 0's ticks
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="continuous-batcher")
            self._thread.start()

    # ------------------------------------------------------------------
    def _init_state(self) -> BatchState:
        cfg, S, dev = self.cfg, self.S, self.device
        hd = cfg.n_text_state // cfg.n_text_head
        L, H, F = cfg.n_text_layer, self.n_head, self.xa_ctx
        names = _XA_NAMES[self.kv_bits]
        slab = (L, S, H, hd, F)
        xa = {n: torch.zeros(slab, dtype=torch.int8 if self.kv_bits else cfg.dtype, device=dev)
              for n in names[:2]}
        xa.update({n: torch.zeros((L, S, H, F), dtype=torch.float32, device=dev)
                   for n in names[2:]})
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        return BatchState(
            tokens=torch.full((S, cfg.n_text_ctx), self.ids.eot, **i64),
            pos=torch.zeros((S,), **i64),
            done=torch.ones((S,), dtype=torch.bool, device=dev),
            forced_eot=torch.zeros((S,), dtype=torch.bool, device=dev),
            sample_begin=torch.zeros((S,), **i64),
            max_len=torch.zeros((S,), **i64),
            sum_lp=torch.zeros((S,), **f32),
            tok_lps=torch.zeros((S, cfg.n_text_ctx), **f32),
            no_speech=torch.zeros((S,), **f32),
            kv=init_kv_cache(cfg, S, self.cache_len, dtype=self.self_dtype, device=dev,
                             n_head=H),
            xa_kv=xa,
            last_logits=torch.zeros((S, cfg.n_vocab), **f32),
        )

    def _tensors(self) -> list:
        st = self.state
        out = []
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            out.extend(v.values() if isinstance(v, dict) else [v])
        return out

    def _reset(self) -> None:
        """Every slot empty again, in place (the graphs keep the buffers)."""
        self._replay.call(self._op + "/reset")

    @torch.inference_mode()
    def _reset_op(self, own=None) -> None:
        with self._lock.shared():
            for t in self._tensors():
                t.zero_()
            self.state.tokens.fill_(self.ids.eot)
            self.state.done.fill_(True)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def submit(self, window_audio: np.ndarray, init_tokens, sot_index: int,
               max_tokens: int = 224, should_abort=None) -> Future:
        """Queue one 30 s window for decoding; resolves to a dict with
        tokens / token_logprobs / sum_logprob / avg_logprob / no_speech_prob
        / xa_kv (or None if aborted)."""
        return self._put(_Request(window_audio, None, list(init_tokens), sot_index, max_tokens,
                                  Future(), should_abort))

    def submit_encoded(self, xa_kv: dict, init_tokens, sot_index: int, max_tokens: int = 224,
                       should_abort=None) -> Future:
        """Like :meth:`submit` with the encoder pass already done (the
        window's [L, 1, ...] cross K/V in the pool's form)."""
        return self._put(_Request(None, xa_kv, list(init_tokens), sot_index, max_tokens,
                                  Future(), should_abort))

    def _put(self, req: _Request) -> Future:
        if tracing.on:
            req.request = tracing.request_id()
        self._queue.put(req)
        self._wake.set()
        return req.future

    def is_idle(self) -> bool:
        """True when no slot is occupied and nothing is queued: a new request
        would decode alone. Advisory (racy by nature)."""
        return self._queue.empty() and all(r is None for r in self._slot_req)

    def shutdown(self) -> None:
        """Stop the worker; reject what is still queued or in a slot."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        pending = [r for r in self._slot_req if r is not None]
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in pending:
            if not req.future.done():
                req.future.set_exception(RuntimeError("continuous batcher shut down"))

    # ------------------------------------------------------------------
    # Device work
    # ------------------------------------------------------------------
    def _encode(self, audio: np.ndarray) -> dict:
        """[N, samples] audio → the pool's form of cross K/V (int8 in a
        quantized pool, as the JAX package's ``_encode_op``), one launch of
        each stage for the whole tick (K1, then K2 at B = N on the card)."""
        x = to_device(np.ascontiguousarray(audio), self.device)
        mel = compute_log_mel(x, n_mels=self.cfg.n_mels, dtype=self.cfg.dtype)
        return precompute_xa_kv(self.cfg, self.params, encoder_apply(self.cfg, self.params, mel),
                                8 if self.kv_bits else 0)

    def _step_fn(self):
        """One greedy step of every slot (``_step_chunk_op``'s body),
        updating ``BatchState`` in place; ``step(state, c_valid)``."""
        cfg, ids, model = self.cfg, self.ids, self.params
        vocab = torch.arange(cfg.n_vocab, device=self.device)
        start_row = torch.where((vocab == ids.blank) | (vocab == ids.eot), NEG_INF, 0.0)
        ctx_last, cache_last = cfg.n_text_ctx - 1, self.cache_len - 1
        suppress = self.suppress_mask[None, :]

        def step(st: BatchState, c_valid: int) -> None:
            logits = st.last_logits + suppress
            at_start = st.pos == st.sample_begin
            logits = torch.where(at_start[:, None], logits + start_row[None, :], logits)
            logits = apply_timestamp_rules(logits, st.tokens, st.pos, st.sample_begin, ids)
            next_tok = torch.argmax(logits, dim=-1)
            tok_lp = torch.log_softmax(logits, dim=-1).gather(1, next_tok[:, None])[:, 0]
            hit_max = st.pos >= st.max_len.clamp(max=ctx_last)
            forced = hit_max & ~st.done
            next_tok = torch.where(st.done | hit_max, ids.eot, next_tok)
            # A forced EOT was never sampled: its logprob stays out of sum_lp.
            tok_lp = torch.where(st.done | forced, 0.0, tok_lp)
            write_pos = st.pos.clamp(max=ctx_last)
            st.tokens.scatter_(1, write_pos[:, None], next_tok[:, None])
            st.tok_lps.scatter_(1, write_pos[:, None], tok_lp[:, None])
            st.sum_lp.add_(tok_lp)
            new_done = st.done | (next_tok == ids.eot)
            logits, _ = decoder_step(cfg, model, next_tok, write_pos.clamp(max=cache_last),
                                     st.kv, st.xa_kv, c_valid=c_valid)
            st.pos.add_((~st.done).to(torch.int64))
            st.done.copy_(new_done)
            st.forced_eot.logical_or_(forced)
            st.last_logits.copy_(logits)

        return step

    def _chunk(self, live: list) -> tuple[np.ndarray, np.ndarray]:
        """``steps_per_sync`` steps of every slot at the read bound that the
        live slots' positions need; returns (done, pos) read back."""
        n = self.steps_per_sync
        top = max(self._host_pos[s] for s in live) + n - 1
        bound = read_bound(min(top, self.cache_len - 1), self.bounds)
        with tracing.begin("batcher.chunk") if tracing.on else tracing.OFF:
            for _ in range(n):
                self._loop.advance(bound)
        with tracing.begin("batcher.readback") if tracing.on else tracing.OFF:
            st = self.state
            both = to_host(torch.stack([st.done.to(torch.int64), st.pos])).numpy()
        return both[0].astype(bool), both[1]

    def _admit(self, admits: list) -> None:
        """Install a tick's admissions: one encode for every raw window, one
        batched prefill and install per prompt bucket. Forms are checked
        before anything is installed."""
        st = self.state
        groups: dict[int, list] = {}
        for slot, req in admits:
            groups.setdefault(prompt_bucket(len(req.init_tokens)), []).append((slot, req))
        n_crop = self.xa_ctx * 320  # encoder positions → samples
        names = set(_XA_NAMES[self.kv_bits])
        for bucket, group in groups.items():
            # Raw windows first, so that their rows line up with the batched encode.
            raws = [(s, r) for s, r in group if r.xa_kv is None]
            encs = [(s, r) for s, r in group if r.xa_kv is not None]
            parts = []
            if raws:
                audio = np.zeros((len(raws), n_crop), np.float32)
                for j, (_, r) in enumerate(raws):
                    w = np.asarray(r.audio, np.float32).reshape(-1)[:n_crop]
                    audio[j, : w.shape[0]] = w
                enc = self._encode(audio)
                parts.append(enc)
                # Each raw request gets its slice back with its result: the
                # engine reuses it for the alignment pass and fallback rungs
                # (kept under a handle of the replay channel on a mesh).
                for j, (_, r) in enumerate(raws):
                    r.xa_kv = self._replay.keep({k: v[:, j : j + 1] for k, v in enc.items()})
            # A packed int4 carrier is unpacked into the int8 container.
            parts.extend(unpack_xa_kv(r.xa_kv) if self.kv_bits else r.xa_kv for _, r in encs)
            for p in parts:
                if set(p) != names:
                    raise ValueError(f"cross K/V {sorted(p)} does not fit a kv_bits="
                                     f"{self.kv_bits} pool ({sorted(names)})")
                for k, v in p.items():
                    want = st.xa_kv[k].shape
                    if v.shape[0] != want[0] or v.shape[2:] != want[2:]:
                        raise ValueError(f"cross K/V {k} {tuple(v.shape)} does not fit the "
                                         f"pool's {tuple(want)}")
            xa_new = parts[0] if len(parts) == 1 else {
                k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
            ordered = raws + encs
            N = len(ordered)
            prompts = np.full((N, bucket), self.ids.eot, np.int64)
            n_prompts = np.zeros((N,), np.int64)
            sots = np.zeros((N,), np.int64)
            max_lens = np.zeros((N,), np.int64)
            slots = np.zeros((N,), np.int64)
            for j, (slot, req) in enumerate(ordered):
                n = len(req.init_tokens)
                prompts[j, :n] = req.init_tokens
                n_prompts[j] = n
                sots[j] = req.sot_index
                max_lens[j] = min(n + req.max_tokens, self.cache_len - 1,
                                  self.cfg.n_text_ctx - 1)
                slots[j] = slot
            dev = self.device
            prompts_t, n_t, sots_t, slots_t, max_lens_t = (
                to_device(a, dev) for a in (prompts, n_prompts, sots, slots, max_lens))
            rows = torch.arange(N, device=dev)
            kv_n = init_kv_cache(self.cfg, N, bucket, dtype=st.kv["k"].dtype, device=dev,
                                 n_head=self.n_head)
            logits, kv_n = decoder_apply(self.cfg, self.params, prompts_t, 0, kv_n, xa_new)
            nsp = torch.softmax(logits[rows, sots_t], dim=-1)[:, self.ids.no_speech]

            for k, v in kv_n.items():
                int_view(st.kv[k])[:, slots_t, :, :bucket] = int_view(v)
            for k, v in xa_new.items():
                st.xa_kv[k][:, slots_t] = v
            token_rows = torch.full((N, self.cfg.n_text_ctx), self.ids.eot, dtype=torch.int64,
                                    device=dev)
            token_rows[:, :bucket] = prompts_t
            st.tokens[slots_t] = token_rows
            st.tok_lps[slots_t] = 0.0
            st.last_logits[slots_t] = logits[rows, n_t - 1]
            st.pos[slots_t] = n_t
            st.done[slots_t] = False
            st.forced_eot[slots_t] = False
            st.sample_begin[slots_t] = n_t
            st.max_len[slots_t] = max_lens_t
            st.sum_lp[slots_t] = 0.0
            st.no_speech[slots_t] = nsp
            for j, slot in enumerate(slots.tolist()):
                self._host_pos[slot] = int(n_prompts[j])

    # ------------------------------------------------------------------
    # Worker loop (host)
    # ------------------------------------------------------------------
    def _free_slots(self) -> list:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _worker(self) -> None:
        with tracing.worker_role():
            while not self._stop.is_set():
                try:
                    self._worker_tick()
                except Exception as e:  # noqa: BLE001 — reject, never orphan
                    for i, req in enumerate(self._slot_req):
                        if req is not None and not req.future.done():
                            req.future.set_exception(e)
                        self._slot_req[i] = None
                    self._reset()

    @torch.inference_mode()
    def _worker_tick(self) -> None:
        with (tracing.begin("batcher.tick") if tracing.on else tracing.OFF) as tick:
            traced = tick is not None
            with tracing.begin("batcher.take") if traced else tracing.OFF:
                admits = self._take_queued()
                aborts = self._poll_aborts()
                live = [i for i, r in enumerate(self._slot_req) if r is not None]
            if not (admits or aborts or live):
                with tracing.begin("batcher.idle", tracing.WAIT) if traced else tracing.OFF:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                return
            read = self._tick(admits, aborts, live)
            if traced and admits:
                tracing.count("batcher.admit", admitted=len(admits),
                              requests=tuple(r.request for _, r in admits))
            if read is None:
                return
            done, pos = read
            if traced:
                served = [self._slot_req[s] for s in live if self._slot_req[s] is not None]
                tracing.count("batcher.chunk", steps=self.steps_per_sync, live=len(served),
                              requests=tuple(r.request for r in served))
            with (tracing.begin("batcher.harvest") if traced else tracing.OFF,
                  self._lock.shared()):
                for slot in live:
                    if self._slot_req[slot] is None:  # its admission failed
                        continue
                    self._host_pos[slot] = int(pos[slot])
                    if done[slot]:
                        self._harvest(slot, int(pos[slot]))

    @torch.inference_mode()
    def _admit_queued(self) -> None:
        """Admit queued requests into the free slots (a tick without a
        chunk)."""
        admits = self._take_queued()
        if admits:
            self._tick(admits, [], [])

    def _take_queued(self) -> list:
        """Queued requests into the free slots, on the host: each future is
        in _slot_req before any device work, so a failed admission rejects
        it (here, in ``_tick``, or by the _worker backstop)."""
        admits = []
        for slot in self._free_slots():
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            self._slot_req[slot] = req
            self._host_pos[slot] = len(req.init_tokens)
            admits.append((slot, req))
        return admits

    def _poll_aborts(self) -> list:
        """Cooperative abort: a cancelled slot is freed and resolves None.
        Returns the freed slots (marked done on the device by the tick)."""
        freed = []
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.should_abort and req.should_abort():
                self._slot_req[slot] = None
                freed.append(slot)
                if not req.future.done():
                    req.future.set_result(None)
        return freed

    def _tick(self, admits: list, aborts: list, live: list):
        """One tick on the device, as one op of the replay channel: the
        admissions, the aborted slots marked done, then a chunk of steps of
        the ``live`` slots. Rejects the admitted requests if their admission
        failed; returns the chunk's (done, pos), or None without one."""
        admissions = [(slot, r.audio, r.xa_kv, r.init_tokens, r.sot_index, r.max_tokens)
                      for slot, r in admits]
        error, read = self._replay.call(self._op, admissions, aborts, live,
                                        list(self._host_pos), own=admits)
        if error is not None:
            for slot, req in admits:
                self._slot_req[slot] = None
                if not req.future.done():
                    req.future.set_exception(error)
        return read

    @torch.inference_mode()
    def _tick_op(self, admissions, aborts, live, host_pos, own=None):
        """The tick's device work on every rank (rank 0's requests in
        ``own``; a follower's stand-ins from ``admissions``). Returns
        (the admission's exception or None, the chunk's (done, pos) or
        None)."""
        admits = own if own is not None else [
            (slot, _Request(audio, xa, list(init), sot, max_tokens, Future()))
            for slot, audio, xa, init, sot, max_tokens in admissions]
        self._host_pos[:] = host_pos
        error = read = None
        dev = self.device
        with self._lock.shared():
            if admits:
                try:
                    with tracing.begin("batcher.admit") if tracing.on else tracing.OFF:
                        self._admit(admits)
                except Exception as e:  # noqa: BLE001 — rejected by the caller, not orphaned
                    failed = [s for s, _ in admits]
                    self.state.done[to_device(np.array(failed), dev)] = True
                    live = [s for s in live if s not in failed]
                    error = e
            if aborts:
                self.state.done[to_device(np.array(aborts), dev)] = True
            if live:
                read = self._chunk(live)
        return error, read

    def _harvest(self, slot: int, end: int) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        st = self.state
        sb = len(req.init_tokens)
        seq = to_host(st.tokens[slot, sb:end]).numpy()
        eots = np.nonzero(seq == self.ids.eot)[0]  # trim at the first EOT
        if eots.size:
            seq = seq[: eots[0]]
        lps = to_host(st.tok_lps[slot, sb : sb + len(seq)]).numpy()
        small = to_host(torch.stack([st.sum_lp[slot], st.forced_eot[slot].float(),
                                     st.no_speech[slot]])).numpy()
        sum_lp, forced, no_speech = float(small[0]), bool(small[1]), float(small[2])
        # The denominator of decode_window: a sampled EOT counts, a forced one not.
        n_sampled = max(len(seq) + (0 if forced else 1), 1)
        req.future.set_result({
            "tokens": seq,
            "token_logprobs": lps,
            "sum_logprob": sum_lp,
            "avg_logprob": sum_lp / n_sampled,
            "no_speech_prob": no_speech,
            "xa_kv": req.xa_kv,  # [L, 1, ...]: for raw windows, a slice of the tick's encode
        })
