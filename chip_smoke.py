#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA:

    python3 chip_smoke.py

It uses only ``sentiric_stt_whisper_service_tpu_torch`` (never JAX or the
JAX package) and fails with a non-zero exit on the first phase that fails:

1. the card: ``nvidia-smi`` name and power limit; no CUDA device is a failure;
   the versions of the four packages the servers import (``grpc``,
   ``aiohttp``, ``google.protobuf``, ``prometheus_client``);
2. the build: every kernel of ``csrc/`` compiled from this checkout, one
   ``nvcc`` per source, all started together; and the native WAV parser
   (``native/sstw_native.cpp``, ``g++`` into the package's ``_build/``),
   which must build;
3. kernel checks at the slices' shapes (4 windows of large-v3, 5 beams):
   each kernel (K1 log-mel, K2 flash attention, K3 decode attention in its
   bf16, causal and int8 forms, K4 int4 decode attention, K5 beam
   self-attention in its bf16 and int8 forms at two read bounds, K6 beam
   cross-attention in its bf16, int8 and int4 forms; K5 and K6 again at
   beam 9, two groups of query beams; and at phase 7's shapes: K2 over an
   admission tick of 8 windows, K3 int8 and K4 over a pool of 8 slots, K5
   and K6 at the gang's bucket of 8 items x 5 beams; P1, the int8 attention
   probe's kernel, in its qk8 and full8 modes at the probe's [16,20,1500,64]
   on the probe's inputs, its int8 codes bit-equal to the plain version's,
   full8 held to a bound per element (``ops/flash_q8.full8_tolerance``),
   each mode's bound shown to reject a PV without its first key tile, with
   SDPA timed beside it as a yardstick) against its plain
   PyTorch version on the same inputs, with the stated tolerance; each one's
   median time per call beside the plain version's, the time of one PyTorch
   call that computes the same function where there is one, and the bound:
   the least time the card could take, the larger of the bytes over 3.35 TB/s
   and the operations over the peak rate for the inputs' type; beside them
   the kernel's and the library call's device time (20 calls replayed in a
   CUDA graph, so the host's dispatch is left out) and, for the decode
   kernels K3–K6, the kernel's cold device time (the graph's calls rotate
   through copies of the inputs, so none is in L2 when read, as in the
   decode, where each layer's slab comes from device memory); K6 also at
   the form of speculative decoding's verify pass (B = 1, the gamma + 1 = 5
   positions as its query rows, int4 slab: ``verify_form`` in its JSON row);
4. the greedy slice: large-v3 at full width with random weights from a fixed
   seed, int8 weights + fused qkv, four synthetic 16 kHz WAV requests written
   and parsed by the port, then pad_or_trim → compute_log_mel →
   encode_xa_kv_q(bits=4) → greedy decode_window with an fp8 self cache and
   timestamp rules (the JAX package's bench prompt and 128-token budget),
   then text, three times (the spread of one tree). It repeats once with an
   int8 and a bf16 cross slab on a short budget, so K3's two forms run in
   the pipeline too. The decode replays the step's CUDA graph
   (``models/graphs.py``): a first request of each shape class, cut short,
   captures it (capture seconds, static buffers and graph pool printed).
   It checks that logits and log-probabilities are finite, that the graphed
   ``DecodeResult`` equals eager decoding on the card in every field (on a
   16-token cap for int4), that stepwise decoding (the kernels) agrees with
   a teacher-forced prefill (plain PyTorch) of the same tokens, and that
   K1–K4 were launched during the slice;
5. the beam slice: the same requests and model through decode_window_beam
   (beam 5, int4 cross slab, bf16 self cache, timestamp rules, 128-token
   budget, three times), graphed as phase 4. It checks that K5 and K6 each
   launched once per layer per step and K3/K4 not at all, that
   log-probabilities are finite, that the graphed result equals eager
   decoding (16-token budget), and that decoder_step_beam under random
   parents and tokens (K5, K6) agrees with a teacher-forced prefill of every
   hypothesis (plain PyTorch).

6. the engine: ``runtime/engine.SttEngine`` over the same large-v3 model
   (int4 compute: int4 cross slab, fp8 self cache; ``device="auto"``; VAD,
   diarization, ``language="auto"`` and token timestamps on; the gates
   relaxed so that random weights keep their segments), the user's entry
   point ``transcribe_pcm16`` on WAVs written by the port and parsed by its
   native parser (each parse counted; one that falls back fails the run):
   voiced synthetic clips of 5, 12, 21 and 30 s, an 8 kHz clip (the
   resample path), a 50 s clip through the sequential long-form loop and
   through the batched one, and a silent clip (the VAD gate); once with
   ``beam_size=1`` (path ``engine_greedy``: K1, K2, K4) and once with the
   default ``beam_size=5`` (path ``engine_beam``: K1, K2, K5, K6), each
   after ``warmup()``, then one request with the default gates, whose
   ladder must climb above t = 0 (best-of sampling on the card). It prints
   each request's wall, audio seconds, segments, tokens and stage split
   (language detection, encode, decode, alignment pass, prosody with
   clustering), audio seconds per second over each set, the warm-up and
   the engine's graph classes with their static buffers and pool. It
   checks that every kernel of each path launched, that segment times are
   non-negative with starts in order, that token times lie inside the
   request's audio and in order within a segment, that the silent clip
   gives the one ``language="unknown"`` result, and that one window's
   token ids from the engine (graphed) equal an eager decode
   (``graph=False``) of the same window by phase 4's functions. (The
   reference's long-form loop closes an unterminated trailing segment at
   the window's audio end even when its opening timestamp lies later, so
   t1 < t0 can occur with random weights, in the JAX package too; such
   segments are counted, not refused.) Phase 6's engines run at
   ``parallel_requests=1``: one request at a time on the engine's own graph
   classes;
7. concurrency: the engine at ``parallel_requests=8``, ``max_batch_size=8``
   (otherwise phase 6's settings), eight requests started together from
   eight threads (phase 6's 5, 12, 21 and 30 s, 10 s at 8 kHz and 50 s
   sequential clips, and two more 30 s clips). Greedy (path
   ``concurrent_greedy``: K1, K2, K4) rides the continuous batcher's int4
   pool (``runtime/batcher.py``, warmed up; an int8 container, as the JAX
   package's: raw windows are encoded at 8 bits): each request's wall beside its
   phase 6 wall, the set's wall and audio-s/s beside phase 6's set, the
   graphed step ms by number of live slots, slots live per step, the pool's
   bytes, then the device's idle share over a 32-token set under
   ``torch.profiler``. Two parked pools driven tick by tick with the same
   admissions (eight windows, 32 tokens) check that the graphed pool equals
   an eager one (``graph=False``) bit for bit and that each request's
   first-step logits lie within 0.25 x the logits' std of a solo B = 1
   prefill over the same int8 slab (printing the common token prefix with a solo ``decode_window``),
   and that an aborted request resolves None and frees its slot for a
   queued ninth while the others finish. An int8 engine, not warmed up (its
   pool is built and captured under load), runs the set at 16 tokens (path
   ``concurrent_greedy_int8``: K3). Beam 5 rides the beam gang (path
   ``concurrent_beam``: K1, K2, K5, K6; its batch buckets captured in
   ``warmup()``): the gangs formed and their buckets, the walls, and each
   gang class's static buffers. Every future must resolve and every request
   keep segments. Apart from each path's counts, the launches of the
   pools' and the gang's own step graphs (paths ``concurrent_greedy_pool``,
   ``concurrent_greedy_int8_pool``, ``concurrent_beam_gang``) must show K3
   (not K4) in both pools, K5 and K6 in the gang: the request threads'
   language detection launches K4 at B = 1 besides. (``chip_threads.py``
   measures the two choices behind the concurrent paths' reads and eager
   stages.)
8. streams: ``runtime/streaming.StreamingSession`` over phase 6's model
   (stock settings: beam 5 finals, greedy partials, 500 ms ticks, language
   auto, VAD on; the gates relaxed), fed port-written WAVs in wire chunks
   (the first carries the 44-byte header and one byte more) as fast as the
   session takes them. ``stream_parity``: a 6 s clip in 200 ms chunks on a
   ``warmup()``ed engine at ``parallel_requests=1``; each tick's wall and
   cap, their p50 and p90, the first partial's latency after the chunk
   that crossed 500 ms, and EOS → last final; it checks that partials end
   in " " and are never final, that finals come only on EOS and leave the
   buffer empty, that times are in order, that the finals (and each
   window's token ids) equal ``transcribe_pcm16`` of the same buffer with
   the session's final options, that no ``DecodeGraphs`` class was
   captured in the ticks or the finalize, and that the ticks launched K1,
   K2, K4 and the finals K5, K6. ``stream_incremental``: the same clip in
   incremental mode (commits, trimmed samples, tick walls; finals' offsets
   in order, the buffer exactly the uncommitted tail). ``stream_cap``: a
   32 s clip in 4 s chunks; the tick past the 30 s cap must flush finals
   through a beam-5 re-decode (K5, K6). ``concurrent_streams``: four 6 s
   streams from four threads through an engine at ``parallel_requests=4``,
   ``max_batch_size=4``, ``language="en"``: tick p50 and p90 beside one
   stream's, every stream's EOS finals, and the pool's own step graphs on
   K3, not K4 (path ``concurrent_streams_pool``). ``silero``: a random-init
   Silero written with ``write_silero_ggml`` and installed by
   ``load_silero``; its probabilities for a 30 s clip on the card within
   1e-4 of the CPU's cell loop (TF32 off), its time per 30 s, the gate's
   decision on a voiced and a silent clip, and one ``transcribe_pcm16``
   through the gate.
9. serving: ``serving.main.serve(settings, random_init=True, block=False)``
   (large-v3 int4 from seed 0, VAD on, language auto, the gates relaxed,
   ``parallel_requests`` = ``max_batch_size`` = 4, warm-up on, free local
   ports) driven by real clients, its JSON log events captured (any error
   event but the tenant gate's, and any HTTP 5xx, fails the phase): HTTP
   ``/v1/transcribe`` and ``/v1/audio/transcriptions`` with a 12 s WAV
   (text and segments equal to ``transcribe_pcm16`` of the same PCM on the
   same engine), the tenant and file gates, ``/health`` and ``/metrics``;
   the gRPC health ``Check`` and a unary call through ``cli.main._unary``
   (equal to the same direct call); a 6 s stream through ``cli.main._stream``
   at real time (0.5 s chunks every 0.5 s): partials never final, finals
   only after EOS and equal to ``transcribe_pcm16`` of the whole buffer,
   the first partial's latency and EOS -> last final; four requests at
   once as gRPC unary calls (beam 5, the gang) and as HTTP requests with
   ``beam_size`` 1 (the batcher's pool), beside phase 7's sets; a unary call
   cancelled once its decode runs (its steps, from K5's launches, below the
   224-step budget); ``/debug/profile?seconds=1`` during a request (the
   trace, from the port's CUPTI recorder, names the port's kernels; the
   request's wall beside a direct call's, and the server's logged stop
   (its wait for and hold of graph launches) and write), against the
   targets of a hold of at most 2 s and a loss of at most 5 s; then
   ``serving.main.shutdown``, after
   which no non-daemon thread is left. Path ``serving`` launches K1–K6;
   each front end's wall is printed beside a direct call's;
10. the probe: ``tools/bench_flash_int8.main()`` (path ``probe_flash_int8``)
   prints its three variants (K2, P1 qk8, P1 full8: ms, TFLOP/s, error
   against fp32 attention); each must have launched its kernel and be no
   worse than twice its plain version's error on the same inputs;
11. speculative decoding (``models/speculative.py``): phase 4's large-v3
   target and a random large-v3-turbo draft (4 decoder layers, d = 1280,
   its own seed, int8 weights + fused qkv), both int4 slabs from one encode
   of the target, fp8 self caches, gamma 4, 12 s and 30 s windows decoded
   alone with a 128-token budget, three ways on the same cross K/V: (a)
   ``decode_window_spec`` with the target as its own draft (the upper bound
   of acceptance), (b) with the turbo draft (a random draft: the lower
   bound), (c) the graphed ``decode_window`` at t = 0. Each prints its
   wall (the encode included), tokens/s and, for (a) and (b), rounds,
   tokens and accepted drafts a round, and each class's capture seconds and
   static buffers. (a) and (b) must equal (c) token for token up to their
   first divergence, where the verify pass's top-two margin must lie within
   twice phase 4's step-vs-teacher-forced drift; the graphed rounds must
   equal eager rounds in every field (32-token budget); on the 12 s window
   (paths ``spec_self``, ``spec_turbo``) K1, K2, K4 (the draft's steps)
   and K6 (the verify pass) launch, K3 and K5 do not, and each replayed
   round launches K6 once a target layer and K4 gamma times a draft
   layer. Then ``SttEngine`` with ``draft_model="large-v3-turbo"`` (phase
   6's greedy settings, ``parallel_requests=1``, a random draft) after
   ``warmup()`` on the 12 s request (path ``engine_spec``): its wall beside
   phase 6's greedy engine's, and ``PerformanceMetrics.spec`` must count
   rounds;
12. training and the mesh (``runtime/training.py``, ``parallel/``): (a)
   large-v3 at full width, bf16 weights (not int8), random init made
   trainable (``training_copy``); a batch of two 30 s synthetic windows,
   their mel from K1, [2, 128] token ids from a seeded ``torch.Generator``,
   the loss mask 0 on the 3 prompt positions. Before any step, on the
   weights of ``TRAIN_GRAD_SEEDS`` seeds, ``loss_and_grads`` through K2
   (``FlashAttention``: K2 forward, plain backward) against the plain path
   (``attention_reference`` under autograd) on the same batch: per
   parameter max |dg| / max |g|, the encoder's attention q/k/v leaves
   within ``TRAIN_GRAD_TOL_ATTN`` and the rest within ``TRAIN_GRAD_TOL``, no
   gradient all-zero or non-finite in one and not the other, every encoder
   ``attn.q/k/v`` weight's nonzero, and K2 launched once per encoder layer
   (32) in the forward pass; on the first seed a planted fault (K2's
   backward without its rowsum term) must exceed the q/k/v bound. Then
   (path ``training``) on the first seed's weights the mel and five
   ``train_step``s on the batch at lr 1e-3 (the default 1e-5 moves no bf16
   weight): a finite loss at every step, falling from the first to the
   fifth, K1 and 32 K2 launches a step; the step's wall (median of steps
   3-5), target tokens/s and audio-s/s, the peak device memory and the
   AdamW state's bytes. (b) tensor parallelism on the one card: large-v3's
   width at 4 + 4 layers, two processes of this script (``--tp-worker``)
   joined over gloo (NCCL takes one rank per card) on a "1x2" mesh, 10
   heads each; each runs ``loss_and_grads``, the teacher-forced logits of
   the training tokens, and greedy 16-token ``decode_window``s over an int4
   slab (K4) and an int8 slab (K3) with its heads (path ``training_tp``,
   rank 0's counts), held against the same model unsharded in this process
   on the same weights: the loss within ``TP_LOSS_RTOL``, each gradient
   shard within ``TP_GRAD_TOL`` of its block of the unsharded gradient, the
   logits as phases 4-5 hold theirs (``drift_check``); K3 and K4 against
   their plain versions on their last call's inputs in the rank's decodes
   (2 windows x 10 heads) at phase 3's tolerance; each decode equal to the
   unsharded one, or where a window differs the unsharded top-two margin
   at its first differing token within twice the largest difference of the
   two models' teacher-forced logits over the unsharded decode. The phase
   prints its wall.
13. the engine over a mesh (``runtime/engine.py`` under ``mesh_shape``,
   ``parallel/replay.py``): phase 4's large-v3 int8 weights (seed 0), int4
   compute, phase 6's settings and relaxed gates at ``parallel_requests`` =
   ``max_batch_size`` = 2, 32 tokens a window, a voiced 12 s clip: greedy on
   the lone path with the language pinned (K4) and token timestamps, two
   at once with the language detected (detection: K4; the batcher's pool:
   K3), beam 5 through the gang (K5, K6). The unsharded engine (mesh "1")
   in this process gives the yardstick. Then this script twice as
   ``--mesh-worker`` (two processes on the one card over gloo): (a) mesh
   "1x2" (tp = 2, 10 heads a rank; path ``engine_tp``, decode eager), (b)
   mesh "1x1x2" (sp = 2; path ``engine_sp``, the lone request, graphed),
   rank 0 serving and rank 1 following. Each decode equals the unsharded
   one, or where it differs the unsharded top-two margin at its first
   differing token lies within twice the drift (phase 12's rule; the drift
   from the two models' teacher-forced logits over the yardstick's rows on
   the int4 slab, the mesh's computed on its ranks through the replay
   channel), for beam 5 the chosen hypotheses' average log-probabilities
   within four times the drift; equal decodes give equal segments (text,
   times, token pieces) and alignment scores within twice the distance that
   one ulp of the encoder output moves the unsharded ones
   (``align_sensitivity``; the token times, a DTW over them, are printed).
   Each rank holds K2-K6 against their plain
   versions on their last call's inputs at the rank's shapes (phase 3's
   tolerances); on (b) K2's last call is a rank's 750 query rows against
   1500 keys. It prints each request's wall beside the unsharded one's,
   each rank's launches and peak memory, and rank 0's replay broadcasts a
   step on the lone request (tp: its share of the eager step). (c) On
   each mesh an engine with phase 11's random large-v3-turbo draft (seed
   SEED + 12, gamma 4), sharded like the target (paths ``engine_tp_spec``,
   ``engine_sp_spec``; the speculative window one op of the channel, its
   rounds eager at tp and graphed at sp), beside the unsharded engine with
   the same draft: the 12 s clip greedy alone, whose decode is held by
   (a)'s rule; it prints the wall, the rounds and accepted drafts, rank
   0's decision broadcasts a round and each rank's peak memory, requires
   rounds > 0 and K4 and K6 launched and held against their plain versions
   at the rank's heads. Phase 3 holds K2 at one window and at (b)'s rank
   shape too (``one_window_form`` and ``sp_form`` in the K2 JSON row, the
   latter with its launches on ``engine_sp``).

``--tp-worker RANK PORT DIR`` is one rank of phase 12's tensor-parallel
leg, ``--mesh-worker RANK PORT DIR`` one of phase 13's (started by the
phase; its inputs and outputs in ``DIR``).

``--kernels-of DIR`` runs phases 1–3 only, with the package of the checkout
in ``DIR``, and ends with the checks as one JSON list; ``--compare DIR`` runs
that for ``DIR`` and for this checkout in turns (DIR, this, this, DIR) and
prints the times side by side, and whether each check's kernel output is
bit-equal in all four runs: the way to hold a change against its parent
commit on one card.

Each path (greedy int4, greedy int8, greedy bf16, beam 5, engine greedy,
engine beam, concurrent greedy, concurrent greedy int8, concurrent beam,
the concurrent pools' and gang's own, phase 8's streams, serving, the
probe, phase 11's greedy, speculative and engine runs, phase 12's
training steps and tp ranks, and phase 13's tp and sp engines) has its own
launch counts, set to 0 just before its (first) run and read just after it; each
run must launch every kernel of its path. A graph replay adds the launches
its capture counted. ``--profile`` runs phase 3, then replaces phases 4–5
with a breakdown of both slices (the greedy one with the int4 and the int8
slab): stage times, and kernel time, launches and the device's idle share
per decode step under ``torch.profiler``, eager and graphed, and the graphed
greedy slice's wall at four intervals between reads of the device. The last lines
are the smoke's wall, the card, one JSON object with each kernel's route, source, launch count
on the path its row times (and on every path), error, times and bound, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import faulthandler
import functools
import io
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
PKG = "sentiric_stt_whisper_service_tpu_torch"
SEED = 0
N_REQUESTS = 4
DURATIONS_S = (5.0, 12.0, 21.0, 30.0)
DECODE_TOKENS = 128  # the JAX package's bench budget
SHORT_TOKENS = 16  # the int8 / bf16 cross-slab repeats, and the eager comparisons
RUNS = 3  # runs of the greedy int4 and beam 5 slices: the spread of one tree
STEP_CHECK_TOKENS = 16  # stepwise vs teacher-forced logits
BEAM = 5  # the JAX package's default beam_size
BEAM_WIDE = 9  # above the 8 query beams a K5 or K6 cluster takes: two groups
WARM_TOKENS = 4  # the capture run's tokens: the measured run's shape class, cut short
BEAM_STEP_CHECK = 8  # beam steps held against a teacher-forced prefill
SPEC_GAMMA = 4  # phase 11: draft tokens per speculative round
WATCHDOG_S = 1140  # the run's limit, under the 1200 s it is given
P1_SHAPE = (16, 20, 1500, 64)  # the int8 attention probe's default (BENCH_B/H/L/D)
TRAIN_B, TRAIN_T, TRAIN_PROMPT = 2, 128, 3  # phase 12: windows, tokens, masked prompt positions
TRAIN_STEPS = 5
TRAIN_LR = 1e-3  # at the default 1e-5 no bf16 weight moves (its step is under half an ulp)
# Phase 12: per parameter max |dg| / max |g| of K2's gradient against the
# plain path's, on the weights of TRAIN_GRAD_SEEDS seeds. Both sides are the
# same bf16 computation up to ~1 bf16 ulp (0.4 %) in the attention outputs,
# carried through the layers. The encoder's attention q/k/v leaves
# (ATTN_LEAF), whose gradients FlashAttention's backward gives, have their
# own bound: on an H100 the three seeds read at most 3.1e-2 there, and a
# backward without its rowsum term 3.8e2, which the phase requires above the
# bound. The rest, led by decoder self-attention q and k (their gradients
# come from cancellation), read at most 0.100.
TRAIN_GRAD_SEEDS = 3
ATTN_LEAF = re.compile(r"encoder\.blocks\.\d+\.attn\.[qkv]\.[wb]")
TRAIN_GRAD_TOL_ATTN = 0.1
TRAIN_GRAD_TOL = 0.3
# ... and of a tp shard's against its block of the unsharded one (the tp
# partial sums' order).
TP_GRAD_TOL = 0.1
TP_LOSS_RTOL = 1e-2
TP_LAYERS = 4  # phase 12 (b): encoder and decoder layers at large-v3's width
TP_TOKENS = 16  # phase 12 (b): the greedy decodes' budget

# The card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): memory
# bytes/s and operations/s by the type of a kernel's inputs.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
# Exponentials a second on the special-function units: 16 a clock on each of
# the 132 SMs, about 3.9e12 (FlashAttention-3, Shah et al. 2024, section 3;
# the CUDA C++ Programming Guide's throughput table, compute capability 9.0).
EXP_PER_S = 3.9e12

# The TPU kernel each CUDA kernel replaces, its source in the port, and the
# path whose run gives its JSON row's launch count: the path that runs the
# form the row times.
SOURCES = {
    "log_mel": ("csrc/mel.cu", "sentiric_stt_whisper_service_tpu/ops/pallas_mel.py:74",
                "greedy_int4"),
    "flash_attention": ("csrc/flash_attention.cu",
                        "sentiric_stt_whisper_service_tpu/ops/flash_attention.py:85",
                        "greedy_int4"),
    "decode_attention": ("csrc/decode_attention.cu",
                         "sentiric_stt_whisper_service_tpu/ops/decode_attention.py:146",
                         "greedy_int8"),
    "decode_attention_i4": ("csrc/decode_attention_i4.cu",
                            "sentiric_stt_whisper_service_tpu/ops/decode_attention.py:227",
                            "greedy_int4"),
    "beam_attention": ("csrc/beam_attention.cu",
                       "sentiric_stt_whisper_service_tpu/ops/beam_attention.py:214", "beam5"),
    "beam_cross_attention": ("csrc/beam_cross_attention.cu",
                             "sentiric_stt_whisper_service_tpu/ops/beam_attention.py:333",
                             "beam5"),
    "flash_q8": ("csrc/flash_q8.cu", "tools/bench_flash_int8.py:105", "probe_flash_int8"),
    # W8 replaces no Pallas kernel: the JAX package's int8 product, whose
    # weight conversion XLA fuses into the matmul's operand.
    "dense_w8": ("csrc/dense_w8.cu", "sentiric_stt_whisper_service_tpu/models/whisper.py:268",
                 "greedy_int4"),
}
# The kernels of SOURCES that replace XLA's fusion rather than a Pallas kernel.
XLA_FUSED = ("dense_w8",)

# The port's kernel functions (every __global__ of csrc/), matched by name in
# the --profile breakdown.
PROFILE_KERNELS = ("log_mel_kernel", "flash_attention_kernel", "decode_attention_kernel",
                   "decode_attention_i4_kernel", "beam_attention_kernel",
                   "beam_cross_attention_kernel", "flash_q8_quant_kernel", "flash_q8_kernel",
                   "dense_w8_kernel")


# The packages the servers import (serving/): phase 9 runs only where they load.
SERVING_PACKAGES = ("grpc", "aiohttp", "google.protobuf", "prometheus_client")


def serving_import(name: str) -> str:
    """``name``'s version (or "ok") if it imports here, else why not."""
    import importlib

    try:
        return getattr(importlib.import_module(name), "__version__", "ok")
    except Exception as e:  # noqa: BLE001 — printed, never a failure
        return f"not importable ({type(e).__name__})"


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def warmup_stream():
    """The one side stream of every capture's warm-up: PyTorch keeps a
    cuBLAS workspace for each stream it sees."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (median), so no host
    dispatch is in the time. The inputs stay in L2 between calls."""
    import torch

    side = warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def cold_graph_ms(call, tensors, calls: int = 20) -> float:
    """Device milliseconds per call of ``call(*tensors)`` with its inputs cold
    in L2: the captured calls rotate through copies of ``tensors``, enough
    that more than twice the L2 is read between two reads of one copy."""
    n = max(2, math.ceil(2 * L2_BYTES / nbytes(*tensors)) + 1)
    fns = [functools.partial(call, *(t.clone() for t in tensors)) for _ in range(n)]
    order = itertools.cycle(fns)
    return graph_ms(lambda: next(order)(), calls=n * -(-calls // n))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds per call, CUDA events around each call: the
    device time plus whatever of the host's dispatch the device waits for."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def speech_like(rng, seconds: float, sr: int = 16000):
    """Band-limited noise with a ~4 Hz syllable envelope and pauses."""
    import numpy as np

    n = int(seconds * sr)
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1.0 / sr)
    spec *= (f > 80) * (f < 4000) / np.sqrt(np.maximum(f, 80.0))
    x = np.fft.irfft(spec, n)
    t = np.arange(n) / sr
    env = np.clip(np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6.28)), 0, None)
    env *= np.sin(2 * np.pi * 0.25 * t + rng.uniform(0, 6.28)) > -0.5  # pauses
    x = x * env
    return (0.3 * x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: dict, exps: float = 0) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it): the largest
    of the bytes over the memory rate ("bytes"), the operations {type: count}
    over each type's peak, the types' times added ("operations"), and the
    exponentials over the special-function units' rate ("exp")."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3,
             "exp": exps / EXP_PER_S * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


def ops_text(ops: dict) -> str:
    return " + ".join(f"{n / 1e9:.3f} G{k}" for k, n in ops.items()) + " ops"


def check_kernels(torch, np) -> list[dict]:
    """Phase 3: each kernel against its plain version at the slices' shapes."""
    import torch.nn.functional as F_

    from sentiric_stt_whisper_service_tpu_torch.ops import beam_attention as ba
    from sentiric_stt_whisper_service_tpu_torch.ops import decode_attention as da
    from sentiric_stt_whisper_service_tpu_torch.ops import fused_mel, mel
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import (
        attention_reference,
        flash_attention,
    )
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import (
        _quantize_kv,
        quantize_weight,
        unpack_nibbles_i8,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = []

    def record(name, kernel_fn, plain_fn, tol, why, work, library_fn=None, library_note="",
               cold=None, alone=None, per_item=False, **meta):
        """``tol`` is absolute, a callable of max |plain| for outputs
        stored in bf16 (whose rounding step scales with the value), or a
        tensor: a bound per element.
        ``work`` is (bytes moved, {type: operations}[, exponentials]) for
        the bound;
        ``library_fn`` one PyTorch call computing the same function. A
        ``library_note`` marks a yardstick on other inputs: its time is
        printed and kept out of the JSON line. ``ms``, ``plain_ms`` and
        ``library_ms`` are times per call (``time_ms``: host dispatch
        included wherever the device waits for it); ``device_ms`` and
        ``library_device_ms`` are device times from CUDA-graph replay
        (``graph_ms``); ``cold`` = (call, tensors), the kernel as
        ``call(*tensors)``, gives ``cold_device_ms`` (``cold_graph_ms``);
        ``alone``, the kernel's call where ``kernel_fn`` wraps it in plain
        PyTorch, gives its own device time ``alone_device_ms``. ``per_item``
        holds each item (the outputs' first axis) to ``tol`` of its own max
        |plain| as well. ``digest`` names the kernel's output bytes, so that
        ``--compare`` shows where two trees' kernels give the same bits."""
        import hashlib

        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(got.contiguous().view(torch.uint8).cpu().numpy()
                                .tobytes()).hexdigest()[:16]
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, plain "
                f"{tuple(want.shape)} {want.dtype}")
        require(bool(torch.isfinite(got.float()).all()), f"{name}: kernel output not finite")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        peak = want.float().abs().max().item()
        for i in range(got.shape[0]) if per_item else ():
            err_i = (got[i].float() - want[i].float()).abs().max().item()
            tol_i = tol(want[i].float().abs().max().item())
            require(err_i <= tol_i, f"{name}: item {i} max_abs_err {err_i:.3e} > tol {tol_i:.2e}")
        if torch.is_tensor(tol):  # per element: the worst share of its bound
            worst = (diff / tol).max().item()
            ok, tol_text = worst <= 1.0, f"per element, worst |err| / tol {worst:.3f}"
        else:
            tol = tol(peak) if callable(tol) else tol
            ok, tol_text = err <= tol, f"tol {tol:.2e}"
        del diff
        ms, plain_ms, device_ms = time_ms(kernel_fn), time_ms(plain_fn), graph_ms(kernel_fn)
        cold_ms = cold_graph_ms(*cold) if cold is not None else None
        alone_ms = graph_ms(alone) if alone is not None else None
        library_ms = library_device_ms = None
        if library_fn is not None:
            library_ms, library_device_ms = time_ms(library_fn), graph_ms(library_fn)
        bound_ms, bound_by = bound(*work)
        lib_txt = (f"{library_ms:.4f} ms (device {library_device_ms:.4f}){library_note}"
                   if library_fn is not None else "none")
        print(f"  {name:<38} max_abs_err {err:.3e} ({tol_text}: {why}; max |plain| "
              f"{peak:.3g})  kernel {ms:.4f} ms (device {device_ms:.4f}"
              f"{f', cold {cold_ms:.4f}' if cold is not None else ''}"
              f"{f', kernel alone {alone_ms:.4f}' if alone is not None else ''})"
              f"  plain {plain_ms:.4f} ms"
              f"  library {lib_txt}  bound {bound_ms:.4f} ms ({bound_by}: "
              f"{work[0] / 1e6:.2f} MB, {ops_text(work[1])})  "
              f"{'OK' if ok else 'FAIL'}")
        require(ok, f"{name}: max_abs_err {err:.3e} beyond its bound ({tol_text})")
        mine = not library_note  # a yardstick on other inputs stays out of the JSON line
        rows.append(dict(check=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms if mine else None, device_ms=device_ms,
                         cold_device_ms=cold_ms, alone_device_ms=alone_ms,
                         library_device_ms=library_device_ms if mine else None,
                         bound_ms=bound_ms, bound_by=bound_by, digest=digest, **meta))

    # K1: 4 windows of 30 s at large-v3's 128 mels; both sides through the
    # whole-clip clamp so the tolerance is the JAX package's (atol 3e-4); the
    # device time with the clamp, then the kernel's alone.
    # The bound counts what the function needs:
    # per frame a 400-point real FFT (2.5 N log2 N operations), the power (3
    # per bin), the mel projection over the filterbank's nonzeros (2 each)
    # and the log; bytes: the audio, the filterbank's nonzeros and band table
    # (first bin, count, offset) read, the log-mel written.
    audio = torch.from_numpy(
        np.stack([speech_like(rng, 30.0) for _ in range(N_REQUESTS)])).to(dev)
    n_frames = N_REQUESTS * (audio.shape[-1] // 160)
    nonzeros = int(np.count_nonzero(mel.mel_filterbank(128)))
    mel_ops = n_frames * (2.5 * 400 * np.log2(400) + 201 * 3 + 2 * nonzeros + 128)
    mel_bytes = nbytes(audio) + 4 * (nonzeros + 3 * 128) + n_frames * 128 * 4
    record("K1 log_mel [4,480000]->[4,3000,128]",
           lambda: mel.clamp_and_scale(fused_mel.log_mel_power_fused(audio, 128)),
           lambda: mel.clamp_and_scale(mel.log_mel_power(audio, 128)),
           3e-4, "fp32 sums in another order", (mel_bytes, {"fp32": mel_ops}),
           alone=lambda: fused_mel.log_mel_power_fused(audio, 128), kernel="log_mel", main=True)

    # K2: the encoder's attention shape, bf16, q and k pre-scaled.
    shape = (N_REQUESTS, 20, 1500, 64)
    q = (torch.randn(shape, generator=g, device=dev) * 0.3).bfloat16()
    k = (torch.randn(shape, generator=g, device=dev) * 0.3).bfloat16()
    v = torch.randn(shape, generator=g, device=dev).bfloat16()
    B_, H_, L_, D_ = shape
    record("K2 flash_attention [4,20,1500,64]",
           lambda: flash_attention(q, k, v), lambda: attention_reference(q, k, v),
           lambda peak: 2**-5 * peak,
           "4 bf16 steps at max |plain|: weights and output rounded to bf16",
           (nbytes(q, k, v, q), {"bf16": 4 * B_ * H_ * L_ * L_ * D_}, B_ * H_ * L_ * L_),
           library_fn=lambda: F_.scaled_dot_product_attention(q, k, v, scale=1.0),
           kernel="flash_attention", main=True)
    # ... and at an admission tick's N = 8 windows (phase 7's pools).
    shape8 = (CONCURRENT, *shape[1:])
    q8, k8_ = ((torch.randn(shape8, generator=g, device=dev) * 0.3).bfloat16() for _ in range(2))
    v8_ = torch.randn(shape8, generator=g, device=dev).bfloat16()
    record(f"K2 flash_attention [{CONCURRENT},20,1500,64]",
           lambda: flash_attention(q8, k8_, v8_), lambda: attention_reference(q8, k8_, v8_),
           lambda peak: 2**-5 * peak,
           "4 bf16 steps at max |plain|: weights and output rounded to bf16",
           (nbytes(q8, k8_, v8_, q8), {"bf16": 4 * CONCURRENT * H_ * L_ * L_ * D_},
            CONCURRENT * H_ * L_ * L_),
           library_fn=lambda: F_.scaled_dot_product_attention(q8, k8_, v8_, scale=1.0),
           kernel="flash_attention")

    # ... and at one window: unsharded (Lq = Lk = 1500), and a rank's 750
    # query rows of an sp = 2 mesh against the 1500 keys of both ranks
    # (phase 13 (b)); from a generator of their own, so that the later
    # checks draw the same inputs in a tree that has no sp form.
    g1 = torch.Generator(device=dev)
    g1.manual_seed(SEED + 2)
    try:  # a tree whose K2 takes one length only (``--kernels-of`` an older one)
        flash_attention(*(torch.zeros((1, 1, n, 64), device=dev).bfloat16()
                          for n in (64, 128, 128)))
        lengths = ((L_, False), (L_ // 2, True))
    except ValueError:
        lengths = ((L_, False),)
    for lq, sp_form in lengths:
        q1 = (torch.randn((1, H_, lq, D_), generator=g1, device=dev) * 0.3).bfloat16()
        k1, v1 = ((torch.randn((1, H_, L_, D_), generator=g1, device=dev) * s_).bfloat16()
                  for s_ in (0.3, 1.0))
        record(f"K2 flash_attention q [1,20,{lq},64] k [1,20,{L_},64]",
               lambda: flash_attention(q1, k1, v1), lambda: attention_reference(q1, k1, v1),
               lambda peak: 2**-5 * peak,
               "4 bf16 steps at max |plain|: weights and output rounded to bf16",
               (nbytes(q1, k1, v1, q1), {"bf16": 4 * H_ * lq * L_ * D_}, H_ * lq * L_),
               library_fn=lambda: F_.scaled_dot_product_attention(q1, k1, v1, scale=1.0),
               kernel="flash_attention", sp=sp_form)

    # P1: the int8 attention probe's kernel at the probe's shape, both modes,
    # on the probe's own inputs. Operations: QKᵀ on the int8 tensor cores and
    # PV in bf16 (qk8) or int8 (full8), 2·B·H·L²·d each; one exponential a
    # score; bytes: q, k, v read and the output written. No PyTorch call
    # computes P1's function: SDPA (exact attention) is timed beside it as a
    # yardstick. Beside each mode: its pre-pass and its attention kernel
    # alone, and K2 on the same inputs.
    import importlib.util

    if importlib.util.find_spec(f"{PKG}.ops.flash_q8") is not None:  # absent in older trees
        from sentiric_stt_whisper_service_tpu_torch.ops import flash_q8 as fq
        from sentiric_stt_whisper_service_tpu_torch.ops.flash_q8 import (
            flash_q8,
            flash_q8_plain,
            full8_tolerance,
        )
        from sentiric_stt_whisper_service_tpu_torch.tools.bench_flash_int8 import make_inputs

        qp, kp, vp = make_inputs(P1_SHAPE, dev)
        B1, H1, L1, D1 = P1_SHAPE
        product = 2 * B1 * H1 * L1 * L1 * D1
        v_cut = vp.clone()
        v_cut[:, :, :64] = 0  # a wrong kernel's PV: the first 64-key tile left out
        for mode in ("qk8", "full8"):
            got, codes = flash_q8(qp, kp, vp, mode, return_codes=True)
            want, want_codes = flash_q8_plain(qp, kp, vp, mode, return_codes=True)
            for cname, c in want_codes.items():
                require(torch.equal(codes[cname], c), f"P1 {mode}: the kernel's {cname} codes "
                        f"differ from the plain version's")
            # qk8: two bf16 steps at max |plain|; full8: the bound per element
            # from the arithmetic (ops/flash_q8.full8_tolerance).
            tol_p1 = ((lambda peak: 2**-6 * peak) if mode == "qk8"
                      else full8_tolerance(qp, kp, vp, want))
            cut = (flash_q8_plain(qp, kp, v_cut, mode).float() - want.float()).abs()
            missed = (cut / (tol_p1 if mode == "full8"
                             else tol_p1(want.float().abs().max().item()))).max().item()
            require(missed > 1.0, f"P1 {mode}: the bound passes a PV without a key tile")
            print(f"  P1 {mode}: int8 codes {', '.join(want_codes)} equal the plain version's "
                  f"bit for bit; the bound rejects a PV without its first 64-key tile (worst "
                  f"|err| / tol {missed:.1f})")
            del got, codes, want, want_codes, cut
            split = {}
            if hasattr(fq, "launch"):  # one kernel alone (trees before the split have none)
                full8 = mode == "full8"
                out_p1 = torch.empty_like(qp)
                scratch = fq.prepass_buffers(B1 * H1, L1, full8, qp.device)
                fq.launch(qp, kp, vp, out_p1, scratch, None, full8, fq.PREPASS)
                split = {
                    "prepass_device_ms": graph_ms(functools.partial(
                        fq.launch, qp, kp, vp, out_p1, scratch, None, full8, fq.PREPASS)),
                    "attention_device_ms": graph_ms(functools.partial(
                        fq.launch, qp, kp, vp, out_p1, scratch, None, full8, fq.ATTENTION)),
                }
                del out_p1, scratch
            split["k2_device_ms"] = graph_ms(functools.partial(flash_attention, qp, kp, vp))
            print(f"  P1 {mode}: device ms "
                  + ", ".join(f"{k.removesuffix('_device_ms')} {v:.4f}" for k, v in split.items())
                  + " (the pre-pass and the attention kernel alone; K2 on the same inputs)")
            record(f"P1 flash_q8 {mode} [16,20,1500,64]",
                   functools.partial(flash_q8, qp, kp, vp, mode),
                   functools.partial(flash_q8_plain, qp, kp, vp, mode), tol_p1,
                   "2 bf16 steps at max |plain|: fp32 sums in another order, bf16 output"
                   if mode == "qk8" else
                   "2 bf16 steps at the element, plus 4 p8 codes a row off by one, each "
                   "max |v_col| / 127 over the row's s",
                   (nbytes(qp, kp, vp, qp),
                    {"int8": product, "bf16": product} if mode == "qk8" else {"int8": 2 * product},
                    B1 * H1 * L1 * L1),
                   library_fn=lambda: F_.scaled_dot_product_attention(qp, kp, vp, scale=1.0),
                   library_note=" (yardstick: SDPA, exact attention, not P1's function)",
                   kernel="flash_q8", main=mode == "qk8", codes_equal=True, **split)
            del tol_p1
        del qp, kp, vp, v_cut

    # K3 / K4: the decode step's cross read, [S=4, H=20, hd=64, F=1500].
    S, H, HD, F = N_REQUESTS, 20, 64, 1500
    q1 = torch.randn((S, H, HD), generator=g, device=dev).bfloat16()
    ks = torch.randn((S, H, HD, F), generator=g, device=dev)
    vs = torch.randn((S, H, HD, F), generator=g, device=dev)
    kb, vb = ks.bfloat16(), vs.bfloat16()
    scale = HD ** -0.5
    tol = lambda peak: 2**-6 * peak  # noqa: E731
    why = "2 bf16 steps at max |plain|: fp32 sums, bf16 output"
    slab_ops = 4 * S * H * HD * F
    k3 = functools.partial(da.decode_attention, scale=scale)
    record("K3 decode_attention bf16", lambda: k3(q1, kb, vb),
           lambda: da.decode_attention_reference(q1, kb, vb, scale=scale),
           tol, why, (nbytes(q1, kb, vb, q1), {"bf16": slab_ops}),
           library_fn=lambda: F_.scaled_dot_product_attention(
               q1[:, :, None], kb.transpose(-1, -2), vb.transpose(-1, -2), scale=scale),
           cold=(k3, (q1, kb, vb)), kernel="decode_attention")
    pos = torch.tensor([0, 17, 700, F - 1], dtype=torch.int32, device=dev)
    live = int((pos + 1).sum())  # positions the causal bound leaves
    # SDPA yardstick: the causal bound as a boolean mask, built outside the timing.
    pos_mask = (torch.arange(F, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
    record("K3 decode_attention bf16 causal",
           lambda: da.decode_attention(q1, kb, vb, pos=pos, scale=scale),
           lambda: da.decode_attention_reference(q1, kb, vb, pos=pos, scale=scale),
           tol, why, (nbytes(q1, q1, pos) + live * H * HD * 2 * 2, {"bf16": 4 * H * HD * live}),
           library_fn=lambda: F_.scaled_dot_product_attention(
               q1[:, :, None], kb.transpose(-1, -2), vb.transpose(-1, -2), attn_mask=pos_mask,
               scale=scale),
           library_note=" (SDPA with a boolean mask built outside the timing)",
           cold=(lambda q_, k_, v_, p_: k3(q_, k_, v_, pos=p_), (q1, kb, vb, pos)),
           per_item=True, kernel="decode_attention")
    k8, k8s = quantize_weight(ks, axis=-2)
    v8, v8s = quantize_weight(vs, axis=-2)
    record("K3 decode_attention int8", lambda: k3(q1, k8, v8, k8s, v8s),
           lambda: da.decode_attention_reference(q1, k8, v8, k8s, v8s, scale=scale),
           tol, why, (nbytes(q1, k8, v8, k8s, v8s, q1), {"int8": slab_ops}),
           cold=(k3, (q1, k8, v8, k8s, v8s)), kernel="decode_attention", main=True)
    k4, k4s = _quantize_kv(ks, 4)
    v4, v4s = _quantize_kv(vs, 4)
    k4_call = functools.partial(da.decode_attention_i4, scale=scale)
    record("K4 decode_attention_i4", lambda: k4_call(q1, k4, v4, k4s, v4s),
           lambda: da.decode_attention_reference(
               q1, unpack_nibbles_i8(k4), unpack_nibbles_i8(v4), k4s, v4s, scale=scale),
           tol, why, (nbytes(q1, k4, v4, k4s, v4s, q1), {"int8": slab_ops}),
           cold=(k4_call, (q1, k4, v4, k4s, v4s)), kernel="decode_attention_i4", main=True)
    # ... and at the pool's S = 8 slots (phase 7): K4 over the int4 pool,
    # K3 over the int8 one.
    S8 = CONCURRENT
    q1_8 = torch.randn((S8, H, HD), generator=g, device=dev).bfloat16()
    ks_8 = torch.randn((S8, H, HD, F), generator=g, device=dev)
    vs_8 = torch.randn((S8, H, HD, F), generator=g, device=dev)
    k8_8, k8s_8 = quantize_weight(ks_8, axis=-2)
    v8_8, v8s_8 = quantize_weight(vs_8, axis=-2)
    record(f"K3 decode_attention int8 S={S8}", lambda: k3(q1_8, k8_8, v8_8, k8s_8, v8s_8),
           lambda: da.decode_attention_reference(q1_8, k8_8, v8_8, k8s_8, v8s_8, scale=scale),
           tol, why, (nbytes(q1_8, k8_8, v8_8, k8s_8, v8s_8, q1_8), {"int8": slab_ops * S8 // S}),
           cold=(k3, (q1_8, k8_8, v8_8, k8s_8, v8s_8)), kernel="decode_attention")
    k4_8, k4s_8 = _quantize_kv(ks_8, 4)
    v4_8, v4s_8 = _quantize_kv(vs_8, 4)
    record(f"K4 decode_attention_i4 S={S8}", lambda: k4_call(q1_8, k4_8, v4_8, k4s_8, v4s_8),
           lambda: da.decode_attention_reference(
               q1_8, unpack_nibbles_i8(k4_8), unpack_nibbles_i8(v4_8), k4s_8, v4s_8, scale=scale),
           tol, why, (nbytes(q1_8, k4_8, v4_8, k4s_8, v4s_8, q1_8), {"int8": slab_ops * S8 // S}),
           cold=(k4_call, (q1_8, k4_8, v4_8, k4s_8, v4s_8)), kernel="decode_attention_i4")

    # K5: the beam step's self read at the beam slice's shapes: 4 items x 5
    # beams, slot caches of 160 rows (128 tokens after a 3-token prompt),
    # random ancestry paths (one source slot per beam and position before
    # pos, none after), both 128-row read buckets.
    K, C = BEAM, 160
    qb = torch.randn((S * K, H, HD), generator=g, device=dev).bfloat16()
    kc = torch.randn((S * K, H, C, HD), generator=g, device=dev) * 0.3
    vc = torch.randn((S * K, H, C, HD), generator=g, device=dev) * 0.3
    kcb, vcb = kc.bfloat16(), vc.bfloat16()
    kc8, kc8s = quantize_weight(kc, axis=-1)  # per-row scales [S*K, H, C]
    vc8, vc8s = quantize_weight(vc, axis=-1)
    for c_valid, at in ((128, 100), (160, 150)):
        src = torch.randint(0, K, (S, K, C), generator=g, device=dev)
        anc = F_.one_hot(src, K).permute(0, 1, 3, 2).bool().contiguous()  # [S, Kd, Ks, C]
        anc[..., at:] = False
        read = anc[..., :c_valid]
        rows_read = int(read.any(dim=1).sum()) * H  # (slot, head, position) rows on a path
        entries = int(read.sum()) * H  # (beam, slot, head, position) scores
        # SDPA yardstick on a pre-folded copy [S, H, K*c_valid, 64] with the
        # ancestry as a boolean mask; the fold is not timed.
        fold = lambda x: (x.reshape(S, K, H, C, HD)[:, :, :, :c_valid]  # noqa: E731
                          .permute(0, 2, 1, 3, 4).reshape(S, H, K * c_valid, HD).contiguous())
        qf = qb.reshape(S, K, H, HD).transpose(1, 2).contiguous()
        kf, vf = fold(kcb), fold(vcb)
        mask = read.reshape(S, 1, K, K * c_valid)
        for form in ("bf16", "int8"):
            if form == "bf16":
                tensors, itemsize = (qb, kcb, vcb, anc), 2

                def k5(q_, k_, v_, a_, c_valid=c_valid):
                    return ba.beam_attention(q_, k_, v_, a_, K, scale=scale, c_valid=c_valid)
            else:
                tensors, itemsize = (qb, kc8, vc8, anc, kc8s, vc8s), 1

                def k5(q_, k_, v_, a_, ks_, vs_, c_valid=c_valid):
                    return ba.beam_attention(q_, k_, v_, a_, K, scale=scale, c_valid=c_valid,
                                             k_scale=ks_, v_scale=vs_)
            plain = functools.partial(
                lambda q_, k_, v_, a_, ks_=None, vs_=None, c_valid=c_valid:
                ba.beam_attention_reference(q_, k_, v_, a_, K, scale, c_valid, ks_, vs_),
                *tensors)
            scale_bytes = rows_read * 4 * 2 if form == "int8" else 0
            record(f"K5 beam_attention {form} c_valid={c_valid}",
                   functools.partial(k5, *tensors), plain, tol, why,
                   (nbytes(qb, qb, read) + rows_read * HD * itemsize * 2 + scale_bytes,
                    {form: 4 * HD * entries}),
                   library_fn=(lambda kf=kf, vf=vf, mask=mask: F_.scaled_dot_product_attention(
                       qf, kf, vf, attn_mask=mask, scale=scale)) if form == "bf16" else None,
                   library_note=" (SDPA on a pre-folded copy, fold not timed)",
                   cold=(k5, tensors), kernel="beam_attention",
                   main=(form == "bf16" and c_valid == 128))

    # K6: the beam step's cross read, the 5 beams of each item against its
    # shared slab [4, 20, 64, 1500]. The plain version rounds its softmax
    # weights to bf16 (the JAX package's _attend_xa), the kernel keeps them
    # in fp32: four bf16 steps.
    q6 = torch.randn((S, H, K, HD), generator=g, device=dev).bfloat16()
    tol6 = lambda peak: 2**-5 * peak  # noqa: E731
    why6 = "4 bf16 steps at max |plain|: plain weights rounded to bf16"
    cross_ops = 4 * S * H * K * HD * F
    k6 = functools.partial(ba.beam_cross_attention, scale=scale)
    k6_i4 = functools.partial(ba.beam_cross_attention_i4, scale=scale)
    record("K6 beam_cross_attention bf16", lambda: k6(q6, kb, vb),
           lambda: ba.beam_cross_attention_reference(q6, kb, vb, scale=scale),
           tol6, why6, (nbytes(q6, kb, vb, q6), {"bf16": cross_ops}),
           library_fn=lambda: F_.scaled_dot_product_attention(
               q6, kb.transpose(-1, -2), vb.transpose(-1, -2), scale=scale),
           cold=(k6, (q6, kb, vb)), kernel="beam_cross_attention")
    record("K6 beam_cross_attention int8", lambda: k6(q6, k8, v8, k8s, v8s),
           lambda: ba.beam_cross_attention_reference(q6, k8, v8, k8s, v8s, scale=scale),
           tol6, why6, (nbytes(q6, k8, v8, k8s, v8s, q6), {"int8": cross_ops}),
           cold=(k6, (q6, k8, v8, k8s, v8s)), kernel="beam_cross_attention")
    record("K6 beam_cross_attention int4", lambda: k6_i4(q6, k4, v4, k4s, v4s),
           lambda: ba.beam_cross_attention_reference(
               q6, unpack_nibbles_i8(k4), unpack_nibbles_i8(v4), k4s, v4s, scale=scale),
           tol6, why6, (nbytes(q6, k4, v4, k4s, v4s, q6), {"int8": cross_ops}),
           cold=(k6_i4, (q6, k4, v4, k4s, v4s)), kernel="beam_cross_attention", main=True)

    # K6 in speculative decoding's verify pass (phase 11): the gamma + 1 = 5
    # positions of one window as the beams of one item, B = 1, int4 slab.
    qv = torch.randn((1, H, SPEC_GAMMA + 1, HD), generator=g, device=dev).bfloat16()
    kv4, vv4, kv4s, vv4s = (t[:1].contiguous() for t in (k4, v4, k4s, v4s))
    record(f"K6 beam_cross_attention int4 verify B=1 K={SPEC_GAMMA + 1}",
           lambda: k6_i4(qv, kv4, vv4, kv4s, vv4s),
           lambda: ba.beam_cross_attention_reference(
               qv, unpack_nibbles_i8(kv4), unpack_nibbles_i8(vv4), kv4s, vv4s, scale=scale),
           tol6, why6, (nbytes(qv, kv4, vv4, kv4s, vv4s, qv),
                        {"int8": 4 * H * (SPEC_GAMMA + 1) * HD * F}),
           cold=(k6_i4, (qv, kv4, vv4, kv4s, vv4s)), kernel="beam_cross_attention",
           verify=True)

    # K5 and K6 at the gang's largest bucket (phase 7): B = 8 items x 5
    # beams, the slot caches of a 224-token budget (256 rows) at both read
    # bounds (K5, bf16 as the gang stores them), and K6 over an int4 slab of
    # 8 items.
    B8, C8 = CONCURRENT, 256
    qg = torch.randn((B8 * K, H, HD), generator=g, device=dev).bfloat16()
    kg, vg = ((torch.randn((B8 * K, H, C8, HD), generator=g, device=dev) * 0.3).bfloat16()
              for _ in range(2))
    for c_valid, at in ((128, 100), (256, 230)):
        src = torch.randint(0, K, (B8, K, C8), generator=g, device=dev)
        ancg = F_.one_hot(src, K).permute(0, 1, 3, 2).bool().contiguous()
        ancg[..., at:] = False
        read = ancg[..., :c_valid]
        rows_read, entries = int(read.any(dim=1).sum()) * H, int(read.sum()) * H
        k5_g = functools.partial(ba.beam_attention, beam_size=K, scale=scale, c_valid=c_valid)
        record(f"K5 beam_attention bf16 B={B8} c_valid={c_valid}",
               functools.partial(k5_g, qg, kg, vg, ancg),
               functools.partial(ba.beam_attention_reference, qg, kg, vg, ancg, K, scale,
                                 c_valid),
               tol, why, (nbytes(qg, qg, read) + rows_read * HD * 2 * 2, {"bf16": 4 * HD * entries}),
               cold=(k5_g, (qg, kg, vg, ancg)), kernel="beam_attention")
    q6_8 = torch.randn((B8, H, K, HD), generator=g, device=dev).bfloat16()
    record(f"K6 beam_cross_attention int4 B={B8}", lambda: k6_i4(q6_8, k4_8, v4_8, k4s_8, v4s_8),
           lambda: ba.beam_cross_attention_reference(
               q6_8, unpack_nibbles_i8(k4_8), unpack_nibbles_i8(v4_8), k4s_8, v4s_8, scale=scale),
           tol6, why6, (nbytes(q6_8, k4_8, v4_8, k4s_8, v4s_8, q6_8), {"int8": cross_ops * B8 // S}),
           cold=(k6_i4, (q6_8, k4_8, v4_8, k4s_8, v4s_8)), kernel="beam_cross_attention")

    check_w8(torch, g, record)

    # K5 and K6 at beam 9: two groups of query beams per (item, head), each
    # over all 9 slots (K5) or the whole slab (K6). A package that refuses
    # 9 beams (a parent under --compare) leaves these rows out.
    if ba.MAX_BEAMS < BEAM_WIDE:
        return rows
    K9, c_valid = BEAM_WIDE, 128
    q9 = torch.randn((S * K9, H, HD), generator=g, device=dev).bfloat16()
    k9, v9 = ((torch.randn((S * K9, H, C, HD), generator=g, device=dev) * 0.3).bfloat16()
              for _ in range(2))
    src = torch.randint(0, K9, (S, K9, C), generator=g, device=dev)
    anc9 = F_.one_hot(src, K9).permute(0, 1, 3, 2).bool().contiguous()
    anc9[..., 100:] = False
    read = anc9[..., :c_valid]
    rows_read, entries = int(read.any(dim=1).sum()) * H, int(read.sum()) * H
    k5_9 = functools.partial(ba.beam_attention, beam_size=K9, scale=scale, c_valid=c_valid)
    record(f"K5 beam_attention bf16 beam {K9} c_valid={c_valid}",
           lambda: k5_9(q9, k9, v9, anc9),
           lambda: ba.beam_attention_reference(q9, k9, v9, anc9, K9, scale, c_valid),
           tol, why, (nbytes(q9, q9, read) + rows_read * HD * 2 * 2, {"bf16": 4 * HD * entries}),
           cold=(k5_9, (q9, k9, v9, anc9)), kernel="beam_attention")
    q6_9 = torch.randn((S, H, K9, HD), generator=g, device=dev).bfloat16()
    record(f"K6 beam_cross_attention int4 beam {K9}", lambda: k6_i4(q6_9, k4, v4, k4s, v4s),
           lambda: ba.beam_cross_attention_reference(
               q6_9, unpack_nibbles_i8(k4), unpack_nibbles_i8(v4), k4s, v4s, scale=scale),
           tol6, why6, (nbytes(q6_9, k4, v4, k4s, v4s, q6_9), {"int8": 4 * S * H * K9 * HD * F}),
           cold=(k6_i4, (q6_9, k4, v4, k4s, v4s)), kernel="beam_cross_attention")
    return rows


# W8 at large-v3's decode widths: the fused qkv, o / cross q / cross o, fc1,
# fc2 (K, N) and the tied logits, at a greedy step's 1 row, the pool's 8, the
# gang's 40 and an align pass's 128; the M_MAX sweep at 64 to 512 rows.
W8_SHAPES = ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))
W8_VOCAB = 51866
W8_ROWS = (1, 8, 40, 128)
W8_SWEEP_ROWS = (64, 128, 256, 512)


def check_w8(torch, g, record) -> None:
    """Phase 3's W8 rows: the kernel against its plain version, with today's
    cast + ``torch.matmul`` + scale (+ bias) as the library yardstick, then
    the device time of both at the ``M_MAX`` sweep's rows. A package without
    ``ops/dense_w8`` (a parent under --compare) leaves them out."""
    try:
        from sentiric_stt_whisper_service_tpu_torch.ops import dense_w8 as w8
    except ImportError:
        return
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def operands(M, K, N, logits):
        x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(bf)
        shape = (N, K) if logits else (K, N)
        w_q = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(N, generator=g, device=dev) * 0.01 + 1e-4
        b = torch.randn(N, generator=g, device=dev).to(bf)
        return x, w_q, scale, b

    def cast_dense(x, w_q, scale, b):  # the port's int8 dense before W8
        return (torch.matmul(x, w_q.to(x.dtype)).float() * scale).to(x.dtype) + b

    def cast_logits(x, emb_q, scale):  # the port's tied logits before W8
        return torch.matmul(x.float(), emb_q.float().T) * scale

    def logits_tol(x, emb_q, scale):  # two fp32 sums of K terms in any order
        mag = torch.matmul(x.float().abs(), emb_q.float().abs().T) * scale
        return 2 * x.shape[-1] * 2**-24 * mag + 1e-30

    cases = [(K, N, False) for K, N in W8_SHAPES] + [(1280, W8_VOCAB, True)]
    for M in W8_ROWS:
        for K, N, logits in cases:
            x, w_q, scale, b = operands(M, K, N, logits)
            work = (nbytes(x, w_q, scale) + M * N * (4 if logits else 2) + (0 if logits else 2 * N),
                    {"bf16": 2 * M * K * N})
            main = M == 8 and (K, N) == (1280, 3840)
            if logits:
                record(f"W8 logits_w8 M={M} [{W8_VOCAB},{K}]",
                       lambda: w8.logits_w8(x, w_q, scale),
                       lambda: w8.logits_w8_plain(x, w_q, scale),
                       logits_tol(x, w_q, scale), "two fp32 sums of K terms in any order", work,
                       library_fn=lambda: cast_logits(x, w_q, scale),
                       cold=(w8.logits_w8, (x, w_q, scale)), kernel="dense_w8", rows=M,
                       shape=[K, N])
            else:
                record(f"W8 dense_w8 M={M} [{K},{N}]", lambda: w8.dense_w8(x, w_q, scale, b),
                       lambda: w8.dense_w8_plain(x, w_q, scale, b), lambda peak: 2**-6 * peak,
                       "2 bf16 steps at max |plain|: fp32 sums in another order, then rounded",
                       work, library_fn=lambda: cast_dense(x, w_q, scale, b),
                       cold=(w8.dense_w8, (x, w_q, scale, b)), kernel="dense_w8", main=main,
                       rows=M, shape=[K, N])
    print(f"  W8 M_MAX sweep (device ms, kernel / cast + torch.matmul; M_MAX = {w8.M_MAX}):")
    for M in W8_SWEEP_ROWS:
        parts = []
        for K, N, logits in cases:
            x, w_q, scale, b = operands(M, K, N, logits)
            if logits:
                mine = graph_ms(lambda: w8.logits_w8(x, w_q, scale))
                lib = graph_ms(lambda: cast_logits(x, w_q, scale))
            else:
                mine = graph_ms(lambda: w8.dense_w8(x, w_q, scale, b))
                lib = graph_ms(lambda: cast_dense(x, w_q, scale, b))
            parts.append(f"[{K},{N}] {mine:.4f} / {lib:.4f}")
            del x, w_q, scale, b
        print(f"    M={M}: " + "; ".join(parts))


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if "--tp-worker" in args:  # phase 12's tp rank: its device is the phase's
        i = args.index("--tp-worker")
        sys.path.insert(0, str(ROOT))
        return tp_worker(torch, int(args[i + 1]), int(args[i + 2]), Path(args[i + 3]))
    if "--mesh-worker" in args:  # phase 13's rank: its device is the phase's
        i = args.index("--mesh-worker")
        sys.path.insert(0, str(ROOT))
        return mesh_worker(torch, int(args[i + 1]), int(args[i + 2]), Path(args[i + 3]))
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: no CUDA device", file=sys.stderr)
        return 1
    # A run that hangs prints every thread's stack and exits non-zero; lines
    # go out as they are printed, so none is lost when it does.
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if "--compare" in args:
        return compare(Path(args[args.index("--compare") + 1]).resolve())
    kernels_of = "--kernels-of" in args
    root = Path(args[args.index("--kernels-of") + 1]).resolve() if kernels_of else ROOT
    if not (root / PKG / "__init__.py").is_file():
        print(f"FAIL: package {PKG} not found in {root}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    try:
        return run(torch, np, profile="--profile" in args, kernels_only=kernels_of)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1


def compare(other: Path) -> int:
    """``--compare DIR``: phase 3 with the package of another checkout
    (``DIR``, e.g. the parent commit unpacked with ``git archive``) and with
    this one's, in turns (other, this, this, other), each in a process of its
    own (``--kernels-of``), then each check's per-call, device and cold times
    side by side. Both use this script's checks."""
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        done = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--kernels-of",
                               str(root)], capture_output=True, text=True, timeout=900)
        lines = done.stdout.strip().splitlines()
        print(f"== {label}: {root}")
        print("\n".join(line for line in lines[:-1] if not line.startswith("  ptxas")))
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        runs.append({row["check"]: row for row in json.loads(lines[-1])})
    print("== per call / device / cold (K3-K6) or kernel alone (K1) ms: other (runs 1, 4) | "
          "this (runs 2, 3)")
    fmt = lambda r: "-" if r is None else "/".join(  # noqa: E731
        f"{r[k]:.4f}" for k in ("ms", "device_ms", "cold_device_ms", "alone_device_ms")
        if r.get(k) is not None)
    for name in runs[1]:
        got = [fmt(run.get(name)) for run in (runs[0], runs[3], runs[1], runs[2])]
        bits = {run[name].get("digest") for run in runs if name in run}
        same = ("" if name not in runs[0] or None in bits
                else "; outputs bit-equal" if len(bits) == 1 else "; outputs differ")
        print(f"  {name:<38} {got[0]}, {got[1]} | {got[2]}, {got[3]}{same}")
    return 0


def run(torch, np, profile: bool = False, kernels_only: bool = False) -> int:
    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.audio import (
        parse_wav_robust,
        pcm16_to_f32,
        write_wav,
    )
    from sentiric_stt_whisper_service_tpu_torch.models import (
        TokenIds,
        build_suppress_mask,
        config_for,
        decode_window,
        decode_window_beam,
        decoder_apply,
        decoder_step_beam,
        encode_xa_kv,
        encode_xa_kv_q,
        init_params,
    )
    from sentiric_stt_whisper_service_tpu_torch.models.beam import read_bucket
    from sentiric_stt_whisper_service_tpu_torch.models.whisper import decoder_step, init_kv_cache
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel, pad_or_trim
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import fuse_decoder_qkv, quantize_params
    from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

    t_start = time.perf_counter()
    require("jax" not in sys.modules, "the port imported jax")

    # Full-fp32 products in the plain versions (cuDNN's default is TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"== 1. card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), device 0 = {torch.cuda.get_device_name(0)}")
    print("  the servers' packages here: " + ", ".join(
        f"{name} {serving_import(name)}" for name in SERVING_PACKAGES))

    print("== 2. build")
    path, seconds, log = kernels.build(verbose=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    kernels.lib()
    print(f"  built {path.relative_to(path.parents[2])} in {seconds:.1f} s")
    if not kernels_only:  # the native WAV parser (native/sstw_native.cpp): required here
        from sentiric_stt_whisper_service_tpu_torch import native

        t0 = time.perf_counter()
        require(native.get_lib() is not None, "the native WAV library did not build (g++)")
        print(f"  native WAV parser {native._lib_path().relative_to(ROOT)}: "
              f"{time.perf_counter() - t0:.1f} s (build or load)")

    print(f"== 3. kernel checks [{card}]")
    checks = check_kernels(torch, np)
    if kernels_only:
        print(json.dumps(checks))
        return 0

    print(f"== 4. greedy slice: large-v3, int8 weights, int4 cross slab, fp8 self cache "
          f"[{card}]")
    dev = torch.device("cuda")
    cfg = config_for("large-v3")
    t0 = time.perf_counter()
    with torch.inference_mode():
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        model = fuse_decoder_qkv(quantize_params(init_params(cfg, g)))
    torch.cuda.synchronize()
    print(f"  random init (seed {SEED}) + quantize + fuse: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    tok = fallback_tokenizer(cfg.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sup = torch.from_numpy(build_suppress_mask(cfg.n_vocab, ids, tok.non_speech_tokens)).to(dev)
    sot = tok.sot_sequence("en")
    sb = len(sot)
    tinit = torch.full((N_REQUESTS, cfg.n_text_ctx), ids.eot, dtype=torch.int64, device=dev)
    tinit[:, :sb] = torch.tensor(sot, device=dev)

    rng = np.random.default_rng(SEED)
    wavs = []
    for seconds in DURATIONS_S:
        buf = io.BytesIO()
        write_wav(buf, speech_like(rng, seconds))
        wavs.append(buf.getvalue())
    decoded = [parse_wav_robust(w) for w in wavs]
    require(all(d.is_valid and d.sample_rate == 16000 for d in decoded), "WAV round trip failed")
    audio_np = np.stack([pad_or_trim(pcm16_to_f32(d.pcm_data)) for d in decoded])
    audio_s = sum(len(d.pcm_data) for d in decoded) / 16000.0
    audio = torch.from_numpy(audio_np).to(dev)

    # (imported after phase 3, which --kernels-of runs with packages that predate it)
    from sentiric_stt_whisper_service_tpu_torch.models import DecodeGraphs

    graphs = DecodeGraphs()  # every graphed class of this run: one memory pool

    def pipeline(bits: int, self_dtype, budget: int, beam: int = 0, **kw):
        mel = compute_log_mel(audio, n_mels=cfg.n_mels, dtype=cfg.dtype)
        require(tuple(mel.shape) == (N_REQUESTS, 3000, cfg.n_mels), f"mel shape {tuple(mel.shape)}")
        xa = encode_xa_kv_q(cfg, model, mel, bits) if bits else encode_xa_kv(cfg, model, mel)
        return xa, decode(xa, self_dtype, budget, beam, **kw)

    def decode(xa, self_dtype, budget: int, beam: int = 0, **kw):
        kw.setdefault("graphs", graphs)
        if beam:
            return decode_window_beam(cfg, model, xa, tinit, sb, 0, ids, sup, beam_size=beam,
                                      max_len=sb + budget, **kw)
        return decode_window(cfg, model, xa, tinit, sb, 0, ids, sup, max_len=sb + budget,
                             self_dtype=self_dtype, **kw)

    def timed(bits, self_dtype, budget, beam=0, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            xa, res = pipeline(bits, self_dtype, budget, beam, **kw)
        torch.cuda.synchronize()
        return xa, res, time.perf_counter() - t

    def capture(label, bits, self_dtype, budget, beam=0):
        """The first request of the measured run's shape class, cut short
        (greedy: ``sample_cap``; beam: an abort after one chunk), captures
        its graphs."""
        before = len(graphs.stats())
        if beam:
            polls = itertools.count()
            _, res, wall = timed(bits, self_dtype, budget, beam, abort_chunk=WARM_TOKENS,
                                 should_abort=lambda: next(polls) >= 2)
            require(res is None, f"{label}: the capture run was not cut short")
        else:
            _, _, wall = timed(bits, self_dtype, budget, sample_cap=WARM_TOKENS)
        for st in graphs.stats()[before:]:
            print(f"  [{label}] captured {st['graphs']} graph(s) of a step in "
                  f"{st['capture_s']:.2f} s (eager warm-up included); static buffers "
                  f"{st['static_bytes'] / 2**20:.1f} MiB, graph pool grown by "
                  f"{st['pool_bytes'] / 2**20:.1f} MiB [{card}]")
        print(f"  [{label}] capture run ({WARM_TOKENS} tokens, capture included): {wall:.2f} s")

    def same_as_eager(label, xa, self_dtype, budget, beam=0, **kw):
        """The graphed window's DecodeResult against eager decoding on the
        card, every field bit for bit."""
        with torch.inference_mode():
            eager = decode(xa, self_dtype, budget, beam, graph=False, **kw)
            graphed = decode(xa, self_dtype, budget, beam, **kw)
        for name in graphed._fields:
            require(torch.equal(getattr(graphed, name), getattr(eager, name)),
                    f"{label}: graphed {name} differs from eager decoding")
        n = [n - sb for n in graphed.lengths.tolist()]
        print(f"  [{label}] graphed DecodeResult equals eager decoding in every field "
              f"({budget}-token budget{', cap ' + str(kw['sample_cap']) if kw else ''}; "
              f"tokens {n})")

    def report(label, res, walls, budget, launched, show_text):
        lengths = res.lengths.tolist()
        n_tok = [n - sb for n in lengths]
        lp = torch.cat([res.token_logprobs[i, sb:n] for i, n in enumerate(lengths)])
        require(bool(torch.isfinite(lp).all()), f"{label}: non-finite token log-probabilities")
        for name in ("no_speech_probs", "sum_logprobs", "avg_logprobs"):
            require(bool(torch.isfinite(getattr(res, name)).all()), f"{label}: non-finite {name}")
        wall = walls[0]
        print(f"  [{label}] budget {budget}, graphed: wall {wall:.3f} s, {audio_s / wall:.1f} "
              f"audio-s/s, {sum(n_tok) / wall:.1f} tokens/s [{card}]; launches {launched}")
        if len(walls) > 1:
            print(f"  [{label}] walls of {len(walls)} runs: "
                  f"{', '.join(f'{w:.3f}' for w in walls)} s; tokens/s "
                  f"{', '.join(f'{sum(n_tok) / w:.1f}' for w in walls)}")
        if show_text:
            for i in range(N_REQUESTS):
                toks = res.tokens[i, sb : lengths[i]].tolist()
                text = tok.decode_with_timestamps(toks)
                print(f"    request {i} ({DURATIONS_S[i]:.0f} s): {n_tok[i]} tokens, first "
                      f"{toks[:8]}, text {ascii(text[:72])}")

    def measured(runs, *args, **kw):
        """``runs`` runs of one request; the launch counts of the first, set
        to 0 just before it and read just after."""
        walls = []
        for r in range(runs):
            kernels.reset_launch_counts()
            xa, res, wall = timed(*args, **kw)
            if r == 0:
                first, launched = (xa, res), dict(kernels.LAUNCHES)
            walls.append(wall)
        return first[0], first[1], walls, launched

    f8 = torch.float8_e4m3fn
    if profile:
        profile_slices(torch, cfg, model, audio, timed, card)
        print(card)
        return 0

    paths = {}  # path -> the launch counts of its run
    for path, label, bits, self_dtype, budget, cross_read, runs in (
        ("greedy_int4", "int4 slab, fp8 self cache", 4, f8, DECODE_TOKENS, "decode_attention_i4",
         RUNS),
        ("greedy_int8", "int8 slab, fp8 self cache", 8, f8, SHORT_TOKENS, "decode_attention", 1),
        ("greedy_bf16", "bf16 slab, bf16 self cache", 0, None, SHORT_TOKENS, "decode_attention", 1),
    ):
        capture(path, bits, self_dtype, budget)
        xa, res, walls, paths[path] = measured(runs, bits, self_dtype, budget)
        report(f"{path}: {label}", res, walls, budget, paths[path], show_text=bits == 4)
        for name in ("log_mel", "flash_attention", cross_read, "dense_w8"):
            require(paths[path][name] > 0, f"{path}: kernel {name} was not launched")
        require(paths[path]["dense_w8"] % (6 * cfg.n_text_layer + 1) == 0,
                f"{path}: W8 launched {paths[path]['dense_w8']} times, not 6 x layers + 1 "
                f"per decoder pass")
        require(paths[path][cross_read] % cfg.n_text_layer == 0,
                f"{path}: {cross_read} launched {paths[path][cross_read]} times, not once per "
                f"layer per step")
        if bits == 4:
            main_xa, main_tokens = xa, res.tokens
            same_as_eager(path, xa, self_dtype, budget, sample_cap=SHORT_TOKENS)
        else:
            same_as_eager(path, xa, self_dtype, budget)

    # Stepwise decoding (K4 cross read, fp8 self cache) against a
    # teacher-forced prefill of the same tokens (plain cross read).
    T = sb + STEP_CHECK_TOKENS
    seq = main_tokens[:, :T]
    with torch.inference_mode():
        kv = init_kv_cache(cfg, N_REQUESTS, 160, dtype=f8, device=dev)
        full, _ = decoder_apply(cfg, model, seq, 0, kv, main_xa)
        kv = init_kv_cache(cfg, N_REQUESTS, 160, dtype=f8, device=dev)
        step_logits = []
        for p in range(T):
            logits, kv = decoder_step(cfg, model, seq[:, p], p, kv, main_xa)
            step_logits.append(logits)
        stepwise = torch.stack(step_logits, dim=1)
    # The two paths round bf16 activations in different GEMM shapes and the
    # cross read in different places (K4 keeps fp32 weights, the prefill
    # rounds them to bf16), and the drift compounds over 32 layers; a wrong
    # cross read moves the logits by the order of their spread.
    drift = drift_check("stepwise vs teacher-forced", full, stepwise, torch)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(f"== 5. beam slice: large-v3, int8 weights, int4 cross slab, bf16 self cache, "
          f"beam {BEAM} [{card}]")
    torch.cuda.reset_peak_memory_stats()
    capture("beam5", 4, None, DECODE_TOKENS, beam=BEAM)
    xa, res, walls, beam_launches = measured(RUNS, 4, None, DECODE_TOKENS, beam=BEAM)
    paths["beam5"] = beam_launches
    report(f"beam5: int4 slab, bf16 self cache, beam {BEAM}", res, walls, DECODE_TOKENS,
           beam_launches, show_text=True)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    same_as_eager(f"beam{BEAM}", xa, None, SHORT_TOKENS, beam=BEAM)
    L = cfg.n_text_layer
    n_k5, n_k6 = beam_launches["beam_attention"], beam_launches["beam_cross_attention"]
    require(n_k5 > 0 and n_k5 == n_k6 and n_k5 % L == 0,
            f"beam slice: K5 launched {n_k5} and K6 {n_k6} times, not once per layer per step")
    print(f"  K5 and K6: {n_k5} launches each = {L} layers x {n_k5 // L} steps")
    require(beam_launches["log_mel"] > 0 and beam_launches["flash_attention"] > 0,
            "beam slice: the frontend or encoder kernels were not launched")
    require(beam_launches["decode_attention"] == beam_launches["decode_attention_i4"] == 0,
            "beam slice: the greedy cross-read kernels ran in the beam step")

    # decoder_step_beam (K5 over the slot caches, K6 over the shared int4
    # slab) under random parents and tokens, held against a teacher-forced
    # prefill of every hypothesis with plain attention.
    B, K, C = N_REQUESTS, BEAM, 160
    gen = np.random.default_rng(SEED + 1)
    with torch.inference_mode():
        prompt = tinit[:, :sb]
        kv_b = init_kv_cache(cfg, B, C, device=dev)
        _, kv_b = decoder_apply(cfg, model, prompt, 0, kv_b, xa)
        kv = init_kv_cache(cfg, B * K, C, device=dev)
        for name, x in kv_b.items():
            kv[name].view(x.shape[0], B, K, *x.shape[2:])[:, :, 0] = x
        anc = torch.zeros((B, K, K, C), dtype=torch.bool, device=dev)
        anc[:, :, 0, :sb] = True
        eye = torch.eye(K, dtype=torch.bool, device=dev)
        hyps = prompt.repeat_interleave(K, dim=0)  # [B*K, t]
        xa_bk = {name: x.repeat_interleave(K, dim=1) for name, x in xa.items()}
        got, want = [], []
        for p in range(sb, sb + BEAM_STEP_CHECK):
            parent = torch.from_numpy(gen.integers(0, K, size=(B, K))).to(dev)
            toks = torch.from_numpy(gen.integers(100, 40000, size=(B * K,))).to(dev)
            anc = anc[torch.arange(B, device=dev)[:, None], parent]
            anc[:, :, :, p] |= eye
            hyps = torch.cat([hyps[(parent + torch.arange(B, device=dev)[:, None] * K)
                                   .reshape(-1)], toks[:, None]], dim=1)
            logits, kv = decoder_step_beam(cfg, model, toks, p, kv, xa, anc, K,
                                           c_valid=read_bucket(p, C))
            full, _ = decoder_apply(cfg, model, hyps, 0, init_kv_cache(cfg, B * K, C, device=dev),
                                    xa_bk)
            got.append(logits)
            want.append(full[:, -1])
    drift_check(f"beam steps vs teacher-forced hypotheses ({BEAM_STEP_CHECK} steps)",
                torch.stack(want, 1), torch.stack(got, 1), torch)

    print(f"== 6. engine: large-v3, int4 compute, VAD, diarization, language auto, token "
          f"timestamps [{card}]")
    requests, sequential = engine_phase(torch, np, model, paths, card)

    print(f"== 7. concurrency: large-v3, int4 compute, parallel_requests {CONCURRENT}, "
          f"max_batch_size {CONCURRENT}: the continuous batcher and the beam gang [{card}]")
    concurrency_phase(torch, np, model, paths, card, requests, sequential)

    print(f"== 8. streams: large-v3, int4 compute, StreamingSession over WAV chunks; the Silero "
          f"VAD [{card}]")
    streaming_phase(torch, np, model, paths, card)

    print(f"== 9. serving: serve() of large-v3 int4 (random init), parallel_requests "
          f"{SERVE_PARALLEL}; HTTP, gRPC and the CLI [{card}]")
    serving_phase(torch, np, paths, card, sequential)

    print(f"== 10. the int8 attention probe (tools/bench_flash_int8.py) at "
          f"{list(P1_SHAPE)} [{card}]")
    probe_phase(torch, paths, card)

    print(f"== 11. speculative decoding: large-v3 target, large-v3-turbo draft (seed "
          f"{SEED + 12}), int4 slabs, fp8 self caches, gamma {SPEC_GAMMA} [{card}]")
    spec_phase(torch, np, model, paths, card, drift, requests, sequential)

    print(f"== 12. training: large-v3 bf16, {TRAIN_B} x 30 s windows, {TRAIN_T} tokens, "
          f"{TRAIN_STEPS} AdamW steps; tp = 2 on the one card over gloo [{card}]")
    training_phase(torch, np, paths, card)

    print(f"== 13. the engine over a mesh: large-v3 int4, two processes on the one card over "
          f"gloo: tp = 2 (mesh 1x2), then sp = 2 (mesh 1x1x2), each also with the "
          f"large-v3-turbo draft, beside the unsharded engine [{card}]")
    mesh_phase(torch, np, model, paths, card)

    kernels_json = []
    for name, (src, replaces, path) in SOURCES.items():
        mine = [c for c in checks if c["kernel"] == name]
        row = next(c for c in mine if c.get("main"))  # the form the JSON row times
        kernels_json.append({
            "name": name, "route": "cuda", "source": f"{PKG}/{src}", "replaces": replaces,
            "launches": paths[path][name], "launches_path": path,
            "launches_by_path": {p: counts[name] for p, counts in paths.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            # The exponentials' unit is operations too; bound_term names it.
            "bound_by": "bytes" if row["bound_by"] == "bytes" else "operations",
            "bound_term": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "library_device_ms": row["library_device_ms"],
            "cold_device_ms": row["cold_device_ms"],
            **{k: row[k] for k in ("prepass_device_ms", "attention_device_ms", "k2_device_ms")
               if k in row},
        })
        forms = {"one_window_form": next((c for c in mine if c.get("sp") is False), None),
                 "sp_form": next((c for c in mine if c.get("sp")), None)}
        for form, form_row in forms.items():  # K2 at one window, and a rank's rows of sp = 2
            if form_row is not None:
                kernels_json[-1][form] = {
                    "check": form_row["check"],
                    **({"launches": paths["engine_sp"][name], "launches_path": "engine_sp"}
                       if form == "sp_form" else {}),
                    **{k: form_row[k] for k in ("max_abs_err", "ms", "plain_ms", "device_ms",
                                                "bound_ms", "bound_by", "library_ms",
                                                "library_device_ms")}}
        verify = next((c for c in mine if c.get("verify")), None)
        if verify is not None:  # K6 at the verify form, with its launches on the spec path
            kernels_json[-1]["verify_form"] = {
                "check": verify["check"], "launches": paths["spec_turbo"][name],
                "launches_path": "spec_turbo", **{k: verify[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "device_ms", "cold_device_ms", "bound_ms",
                    "bound_by", "library_ms")}}
    print(f"  smoke wall {time.perf_counter() - t_start:.1f} s, the build included [{card}]")
    print(card)
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def voiced_like(rng, seconds: float, sr: int = 16000):
    """Harmonics of a gliding 110–195 Hz pitch under a 1.5 Hz syllable
    envelope with pauses, plus a little noise: passes the energy VAD."""
    import numpy as np

    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 110 + 60 * rng.uniform() + 25 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in range(1, 16))
    env = np.clip(np.sin(2 * np.pi * 1.5 * t + rng.uniform(0, 6.28)) + 0.6, 0, 1)
    env *= np.sin(2 * np.pi * 0.2 * t + rng.uniform(0, 6.28)) > -0.6  # pauses
    x = x * env + 0.02 * rng.standard_normal(n)
    return (0.3 * x / (np.abs(x).max() + 1e-9)).astype(np.float32)


ENGINE_TOKENS_CHECK = 32  # the capped request held against eager decoding


def engine_phase(torch, np, model, paths, card) -> None:
    """Phase 6: the engine on the card (see the module docstring)."""
    import dataclasses

    from sentiric_stt_whisper_service_tpu_torch import kernels, native
    from sentiric_stt_whisper_service_tpu_torch.audio import parse_wav_robust, write_wav
    from sentiric_stt_whisper_service_tpu_torch.config import Settings
    from sentiric_stt_whisper_service_tpu_torch.models import decode_window, encode_xa_kv_q
    from sentiric_stt_whisper_service_tpu_torch.models.sampling import prompt_bucket
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel, pad_or_trim
    from sentiric_stt_whisper_service_tpu_torch.runtime import engine as eng_mod
    from sentiric_stt_whisper_service_tpu_torch.runtime import (
        PerformanceMetrics,
        RequestOptions,
        SttEngine,
    )

    relaxed = dict(quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
                   min_segment_avg_prob=0.0)
    # One request at a time on the engine's own graph classes (phase 7 runs
    # the concurrent paths).
    base = Settings(device="auto", compute_type="int4", enable_vad=True,
                    enable_diarization=True, language="auto", no_timestamps=False,
                    model_filename="ggml-large-v3.bin", parallel_requests=1)
    require(base.beam_size == BEAM, "the default beam size moved")

    rng = np.random.default_rng(SEED + 6)
    clips = [(f"{s:.0f} s", voiced_like(rng, s), 16000, {}) for s in DURATIONS_S]
    clips.append(("10 s at 8 kHz", voiced_like(rng, 10.0, sr=8000), 8000, {}))
    long_clip = voiced_like(rng, 50.0)
    clips.append(("50 s sequential", long_clip, 16000, dict(condition_on_previous_text=True)))
    clips.append(("50 s batched", long_clip, 16000, dict(condition_on_previous_text=False)))
    clips.append(("3 s silence", np.zeros(48000, np.float32), 16000, {}))
    requests = []  # (label, pcm16, rate, options): WAVs through the port's writer and parser
    native_parses = []  # the native parser's calls inside parse_wav_robust: succeeded or not
    real_native = native.parse_wav_native

    def counted_native(data):
        out = real_native(data)
        native_parses.append(out is not None)
        return out

    native.parse_wav_native = counted_native
    try:
        for label, x, rate, opts in clips:
            buf = io.BytesIO()
            write_wav(buf, x, sample_rate=rate)
            d = parse_wav_robust(buf.getvalue())
            require(d.is_valid and d.sample_rate == rate, f"{label}: WAV round trip failed")
            requests.append((label, d.pcm_data, rate, opts))
    finally:
        native.parse_wav_native = real_native
    require(len(native_parses) == len(clips) and all(native_parses),
            f"the WAVs did not all parse natively: {native_parses}")
    print(f"  {len(clips)} WAVs parsed by the native parser (native/sstw_native.cpp)")

    sequential = {}  # path -> (audio s, wall s, {label: wall s})

    def run_set(path, engine, beam):
        print(f"  [{path}] warmup(): {engine.warmup():.2f} s [{card}]")
        kernels.reset_launch_counts()
        total_audio = total_wall = 0.0
        walls = {}
        for label, pcm, rate, opts in requests:
            m = PerformanceMetrics()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = engine.transcribe_pcm16(pcm, rate, RequestOptions(beam_size=beam, **opts), m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            seconds = len(pcm) / rate
            total_audio += seconds
            total_wall += wall
            walls[label] = wall
            stages = ", ".join(f"{k} {v:.1f}" for k, v in m.stages_ms.items())
            n_tok = sum(r.token_count for r in res)
            print(f"  [{path}] {label}: wall {wall:.3f} s, {seconds:.1f} audio-s, "
                  f"{len(res)} segment(s), {n_tok} tokens; stages ms: {stages or 'none'}; "
                  f"language {res[0].language if res else '-'} [{card}]")
            check_results(path, label, res, seconds, silent="silence" in label)
        counts = dict(kernels.LAUNCHES)
        paths[path] = counts
        sequential[path] = (total_audio, total_wall, walls)
        print(f"  [{path}] {len(requests)} requests, {total_audio:.1f} audio-s in "
              f"{total_wall:.2f} s: {total_audio / total_wall:.2f} audio-s/s [{card}]; "
              f"launches {counts}")
        need = ("log_mel", "flash_attention") + (
            ("beam_attention", "beam_cross_attention") if beam > 1 else ("decode_attention_i4",))
        for name in need:
            require(counts[name] > 0, f"{path}: kernel {name} was not launched")
        for st in engine.graphs.stats():
            key = st["key"]
            print(f"  [{path}] graph class {key[0]} rows {key[2]}"
                  f"{f' beams {key[3]}' if key[0] == 'beam' else ''}: {st['graphs']} graph(s), "
                  f"captured in {st['capture_s']:.2f} s, static buffers "
                  f"{st['static_bytes'] / 2**20:.1f} MiB, pool grown by "
                  f"{st['pool_bytes'] / 2**20:.1f} MiB [{card}]")
        held = sum(st["static_bytes"] for st in engine.graphs.stats())
        print(f"  [{path}] graph classes hold {held / 2**20:.1f} MiB of static buffers; device "
              f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")

    def check_results(path, label, res, seconds, silent):
        if silent:
            require(len(res) == 1 and res[0].language == "unknown" and res[0].text == "",
                    f"{path} {label}: the VAD gate did not give the one 'unknown' result")
            return
        require(bool(res), f"{path} {label}: no segment under relaxed gates")
        end_cs = int(round(seconds * 100))
        late = 0
        for a, b in zip(res, res[1:]):
            require(b.t0 >= a.t0, f"{path} {label}: segment starts out of order")
        for r in res:
            require(r.t0 >= 0 and r.t1 >= 0, f"{path} {label}: negative segment time")
            late += r.t1 < r.t0
            times = [(k.t0, k.t1) for k in r.tokens]
            require(all(0 <= t0 <= t1 <= end_cs + 1 for t0, t1 in times),
                    f"{path} {label}: a token time lies outside the audio: {times[:8]}")
            require(all(b[0] >= a[0] for a, b in zip(times, times[1:])),
                    f"{path} {label}: token times out of order within a segment")
        if late:
            print(f"    ({late} trailing segment(s) opened past the audio's end: t1 < t0, "
                  "as in the reference)")

    eng_greedy = SttEngine(dataclasses.replace(base, beam_size=1, **relaxed),
                           model_name="large-v3", params=model)
    require(eng_greedy.device.type == "cuda" and eng_greedy.xa_bits == 4
            and eng_greedy.self_dtype == torch.float8_e4m3fn, "engine: not the int4 card setup")
    run_set("engine_greedy", eng_greedy, 1)

    # One window's token ids from the engine (graphed, a capped request)
    # against phase 4's functions decoding the same window eagerly.
    seen = []
    decode_one = eng_greedy._decode_one

    def recording(*args, **kw):
        res = decode_one(*args, **kw)
        seen.append((args, kw, res))
        return res

    eng_greedy._decode_one = recording
    label, pcm, _, _ = requests[3]  # the 30 s clip: window 0 is all of it
    eng_greedy.transcribe_pcm16(pcm, 16000, RequestOptions(
        beam_size=1, max_decode_tokens=ENGINE_TOKENS_CHECK))
    del eng_greedy._decode_one
    (_, init_tokens, sb, sot_index, temp, _, _), kw, res = seen[0]  # window 0
    cfg = model.cfg
    sample_len = kw["sample_len"]
    prefill = max(prompt_bucket(sb), eng_mod.TICK_PREFILL)
    dev = torch.device("cuda")
    audio = torch.from_numpy(pad_or_trim(pcm.astype(np.float32) / 32768.0)[None]).to(dev)
    tinit = torch.full((1, cfg.n_text_ctx), eng_greedy.ids.eot, dtype=torch.int64, device=dev)
    tinit[0, :sb] = torch.tensor(init_tokens, device=dev)
    with torch.inference_mode():
        xa = encode_xa_kv_q(cfg, model, compute_log_mel(audio, n_mels=cfg.n_mels,
                                                        dtype=cfg.dtype), 4)
        eager = decode_window(cfg, model, xa, tinit, sb, sot_index, eng_greedy.ids,
                              eng_greedy.suppress_mask, 0.0, None,
                              max_len=min(cfg.n_text_ctx, prefill + sample_len),
                              prefill_len=prefill, self_dtype=torch.float8_e4m3fn,
                              sample_cap=sample_len, graph=False)
    n = int(res.lengths[0])
    require(temp == 0.0 and n == int(eager.lengths[0])
            and np.array_equal(res.tokens[0, :n], eager.tokens[0, :n].cpu().numpy()),
            "engine: graphed token ids differ from eager decoding of the same window")
    print(f"  [engine_greedy] {label} window, {n - sb} tokens (cap {sample_len}): the engine's "
          f"graphed token ids equal an eager decode_window (graph=False) of phase 4's encode")

    eng_beam = SttEngine(dataclasses.replace(base, **relaxed), model_name="large-v3",
                         params=model)
    run_set("engine_beam", eng_beam, BEAM)

    # The default gates: random weights fail the logprob gate, so the
    # ladder climbs from beam 5 at t = 0 to best-of 5 sampling above it.
    eng_default = SttEngine(base, model_name="large-v3", params=model)
    rungs = []
    decode_one = eng_default._decode_one

    def ladder(*args, **kw):
        rungs.append(args[4])
        return decode_one(*args, **kw)

    eng_default._decode_one = ladder
    label, pcm, rate, _ = requests[0]
    m = PerformanceMetrics()
    t = time.perf_counter()
    res = eng_default.transcribe_pcm16(pcm, rate, RequestOptions(), m)
    wall = time.perf_counter() - t
    print(f"  [engine default gates] {label}: wall {wall:.3f} s, rungs t = "
          f"{', '.join(f'{x:.1f}' for x in rungs)}, {len(res)} segment(s) kept; stages ms: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in m.stages_ms.items())} [{card}]")
    require(any(x > 0.0 for x in rungs), "engine: the ladder never left t = 0")
    for st in eng_default.graphs.stats():
        print(f"  [engine default gates] graph class {st['key'][0]} rows {st['key'][2]}: "
              f"captured in {st['capture_s']:.2f} s, static buffers "
              f"{st['static_bytes'] / 2**20:.1f} MiB")
    for engine in (eng_greedy, eng_beam, eng_default):
        engine.shutdown()
    return requests, sequential


CONCURRENT = 8  # phase 7: parallel_requests and max_batch_size (the pool's slots)
EQUAL_TOKENS = 32  # phase 7: the graphed-vs-eager pool, the solo comparison and the abort run
INT8_TOKENS = 16  # phase 7: the int8 pool's run (K3 on the batcher)
PROFILE_TOKENS = 32  # phase 7: the profiled greedy set (idle share)


def concurrency_phase(torch, np, model, paths, card, requests, sequential) -> None:
    """Phase 7: concurrent requests on the card (see the module docstring)."""
    import dataclasses
    import threading

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.audio import parse_wav_robust, write_wav
    from sentiric_stt_whisper_service_tpu_torch.config import Settings
    from sentiric_stt_whisper_service_tpu_torch.models import (
        DecodeGraphs,
        decode_window,
        decoder_apply,
        encode_xa_kv_q,
        init_kv_cache,
    )
    from sentiric_stt_whisper_service_tpu_torch.models.graphs import StepLoop
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel, pad_or_trim
    from sentiric_stt_whisper_service_tpu_torch.runtime import (
        PerformanceMetrics,
        RequestOptions,
        SttEngine,
    )
    from sentiric_stt_whisper_service_tpu_torch.runtime.batcher import ContinuousBatcher

    relaxed = dict(quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
                   min_segment_avg_prob=0.0)
    dev, cfg = model.decoder.pos_emb.device, model.cfg
    base = Settings(device=dev.type, compute_type="int4", enable_vad=True,
                    enable_diarization=True, language="auto", no_timestamps=False,
                    model_filename="ggml-large-v3.bin", parallel_requests=CONCURRENT,
                    max_batch_size=CONCURRENT, request_queue_timeout_ms=600_000, **relaxed)
    keep = ("5 s", "12 s", "21 s", "30 s", "10 s at 8 kHz", "50 s sequential")
    reqs = [r for r in requests if r[0] in keep]
    rng = np.random.default_rng(SEED + 7)
    for k in range(2):
        buf = io.BytesIO()
        write_wav(buf, voiced_like(rng, 30.0))
        d = parse_wav_robust(buf.getvalue())
        reqs.append((f"30 s #{k + 2}", d.pcm_data, 16000, dict(condition_on_previous_text=True)))
    require(len(reqs) == CONCURRENT, f"phase 7 has {len(reqs)} requests")
    audio_s = sum(len(pcm) / rate for _, pcm, rate, _ in reqs)
    f8 = torch.float8_e4m3fn

    def run_concurrent(path, engine, beam, tokens=-1):
        """Every request in its own thread, started together; returns the
        set's wall and each request's wall (s)."""
        n = len(reqs)
        results, walls, errors = [None] * n, [None] * n, []
        metrics = [PerformanceMetrics() for _ in range(n)]
        start = threading.Barrier(n + 1)

        def go(i):
            _, pcm, rate, opts = reqs[i]
            try:
                start.wait(timeout=120)
                t = time.perf_counter()
                results[i] = engine.transcribe_pcm16(
                    pcm, rate, RequestOptions(beam_size=beam, max_decode_tokens=tokens, **opts),
                    metrics[i])
                walls[i] = time.perf_counter() - t
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{reqs[i][0]}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        start.wait(timeout=120)
        t0 = time.perf_counter()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        require(not any(th.is_alive() for th in threads), f"{path}: a request never returned")
        require(not errors, f"{path}: requests failed: {errors}")
        for (label, _, _, _), res in zip(reqs, results):
            require(bool(res), f"{path} {label}: no segment under relaxed gates")
            require(all(r.t0 >= 0 and r.t1 >= 0 for r in res)
                    and all(b.t0 >= a.t0 for a, b in zip(res, res[1:])),
                    f"{path} {label}: segment times out of order or negative")
        return wall, walls, metrics

    def report_set(path, seq_path, wall, walls, metrics, tokens):
        seq_audio, seq_wall, seq_walls = sequential[seq_path]
        for (label, _, _, _), w, m in zip(reqs, walls, metrics):
            alone = seq_walls.get(label)
            stages = ", ".join(f"{k} {v:.1f}" for k, v in m.stages_ms.items())
            print(f"  [{path}] {label}: wall {w:.3f} s"
                  f"{f' (phase 6, alone: {alone:.3f} s)' if alone is not None else ''}; stages ms: "
                  f"{stages} [{card}]")
        print(f"  [{path}] {len(reqs)} concurrent requests, {audio_s:.1f} audio-s in {wall:.3f} s: "
              f"{audio_s / wall:.2f} audio-s/s{'' if tokens < 0 else f' ({tokens}-token cap)'}; "
              f"phase 6 one at a time: {seq_audio:.1f} audio-s in {seq_wall:.2f} s, "
              f"{seq_audio / seq_wall:.2f} audio-s/s [{card}]")

    def chunk_stats(pool):
        """Wraps the pool's chunk to record (live slots, seconds) per chunk."""
        stats, chunk = [], pool._chunk

        def timed(live):
            t = time.perf_counter()
            out = chunk(live)
            stats.append((len(live), time.perf_counter() - t))
            return out

        pool._chunk = timed
        return stats

    def need(path, names):
        need_launched(paths, path, names)

    # The pools' and the gang's own launches, apart from the request threads'
    # (whose language detection launches K4 at B = 1).
    own = OwnLaunches(StepLoop)

    def owned(path, loops, names, absent=()):
        own.record(paths, path, loops, names, absent)

    def reset_counts():
        kernels.reset_launch_counts()
        own.counts.clear()

    # -- greedy through the batcher (int4 compute: K1, K2, K4 in the request
    # threads, K3 over the pool's int8 container) --------------------------
    eng = SttEngine(dataclasses.replace(base, beam_size=1), model_name="large-v3", params=model)
    print(f"  [concurrent_greedy] warmup(): {eng.warmup():.2f} s (the pool's step graphs "
          f"included) [{card}]")
    pool = eng._batchers[cfg.n_audio_ctx]
    print(f"  [concurrent_greedy] pool: {pool.S} slots, cache {pool.cache_len} rows, int8 "
          f"container (int4 compute) + fp8 self cache: {pool.pool_bytes / 2**20:.1f} MiB of state; {len(pool.bounds)} "
          f"step graphs (read bounds {pool.bounds}), graph pool grown by "
          f"{pool.graph_pool_bytes / 2**20:.1f} MiB [{card}]")
    stats = chunk_stats(pool)
    reset_counts()
    wall, walls, metrics = run_concurrent("concurrent_greedy", eng, 1)
    paths["concurrent_greedy"] = dict(kernels.LAUNCHES)
    report_set("concurrent_greedy", "engine_greedy", wall, walls, metrics, -1)
    sequential["concurrent_greedy"] = (audio_s, wall, {})  # phase 9 prints it beside its own
    need("concurrent_greedy", ("log_mel", "flash_attention", "decode_attention",
                               "decode_attention_i4"))
    owned("concurrent_greedy_pool", [pool._loop], ("decode_attention",), ("decode_attention_i4",))
    require(stats, "concurrent_greedy: the batcher ran no chunk")
    steps = pool.steps_per_sync
    by_live = {}
    for n_live, sec in stats:
        by_live.setdefault(n_live, []).append(sec * 1e3 / steps)
    print(f"  [concurrent_greedy] graphed step ms by live slots (median over chunks of {steps} "
          f"steps, the device read included): " + ", ".join(
              f"{k}: {statistics.median(v):.2f} ({len(v)} chunks)"
              for k, v in sorted(by_live.items())) + f" [{card}]")
    total_steps = steps * len(stats)
    print(f"  [concurrent_greedy] slots live per step: mean "
          f"{sum(n for n, _ in stats) * steps / total_steps:.2f} over {total_steps} steps; "
          f"launches {paths['concurrent_greedy']}")

    # The device's idle share over a capped set, under the profiler.
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        pwall, _, _ = run_concurrent("concurrent_greedy (profiled)", eng, 1, PROFILE_TOKENS)
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"  [concurrent_greedy] under the profiler, {PROFILE_TOKENS}-token cap: set wall "
          f"{pwall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, idle "
          f"{100 * (1 - busy_ms / (pwall * 1e3)):.1f} % [{card}]")
    del prof

    # Graphed pool = eager pool on the same admissions (ticks driven here),
    # each request's first-step logits against its solo prefill, and an abort.
    ids, sup = eng.ids, eng.suppress_mask
    sot = list(eng.tokenizer.sot_sequence("en"))
    sb = len(sot)
    windows = [pad_or_trim(voiced_like(rng, 30.0)) for _ in range(CONCURRENT)]

    def drive(pool_, abort_after=None):
        """The windows into a parked pool: one admission tick (its first-step
        logits read back), then ticks until every future resolves."""
        pool_._stop.set()
        pool_._wake.set()
        pool_._thread.join(timeout=10)
        polls = []

        def abort():
            polls.append(1)
            return len(polls) > abort_after

        futs = [pool_.submit(w, sot, 0, max_tokens=EQUAL_TOKENS,
                             should_abort=abort if (abort_after and i == 0) else None)
                for i, w in enumerate(windows)]
        late = pool_.submit(windows[0], sot, 0, max_tokens=EQUAL_TOKENS) if abort_after else None
        pool_._admit_queued()
        slot_of = {id(r.future): s for s, r in enumerate(pool_._slot_req) if r is not None}
        order = [slot_of[id(f)] for f in futs]  # request -> slot
        first = pool_.state.last_logits.clone()
        late_slot = None
        for _ in range(4 * EQUAL_TOKENS):
            pool_._worker_tick()
            if late is not None and late_slot is None:
                late_slot = next((s for s, r in enumerate(pool_._slot_req)
                                  if r is not None and r.future is late), None)
            if all(f.done() for f in futs) and (late is None or late.done()):
                break
        return futs, first, order, late, late_slot

    with torch.inference_mode():
        graphed_pool = ContinuousBatcher(cfg, model, ids, sup, max_slots=CONCURRENT,
                                         kv_bits=4, self_dtype=f8)
        eager_pool = ContinuousBatcher(cfg, model, ids, sup, max_slots=CONCURRENT,
                                       kv_bits=4, self_dtype=f8, graph=False)
        g_futs, first, order, _, _ = drive(graphed_pool)
        e_futs, _, _, _, _ = drive(eager_pool)
        eager_pool.shutdown()
        for i, (g, e) in enumerate(zip(g_futs, e_futs)):
            a, b = g.result(timeout=1), e.result(timeout=1)
            require(np.array_equal(a["tokens"], b["tokens"])
                    and np.array_equal(a["token_logprobs"], b["token_logprobs"])
                    and a["sum_logprob"] == b["sum_logprob"],
                    f"request {i}: the graphed pool's result differs from the eager pool's")
        print(f"  [pool, graphed vs eager] {CONCURRENT} windows admitted together, "
              f"{EQUAL_TOKENS} tokens: token ids, log-probabilities and sums equal bit for bit")
        diffs, prefixes, graphs = [], [], DecodeGraphs()
        for i, w in enumerate(windows):
            audio = torch.from_numpy(w[None]).to(dev)
            xa1 = encode_xa_kv_q(cfg, model, compute_log_mel(audio, n_mels=cfg.n_mels,
                                                             dtype=cfg.dtype), 8)
            prompt = torch.tensor([sot], device=dev)
            solo_logits, _ = decoder_apply(cfg, model, prompt, 0,
                                           init_kv_cache(cfg, 1, 4, dtype=f8, device=dev), xa1)
            ref_l, got_l = solo_logits[0, sb - 1], first[order[i]]
            diffs.append(((ref_l - got_l).abs().max().item(), ref_l.std().item(),
                          bool(ref_l.argmax() == got_l.argmax())))
            tinit = torch.full((1, cfg.n_text_ctx), ids.eot, dtype=torch.int64, device=dev)
            tinit[0, :sb] = prompt[0]
            solo = decode_window(cfg, model, xa1, tinit, sb, 0, ids, sup,
                                 max_len=sb + EQUAL_TOKENS, self_dtype=f8, graphs=graphs)
            want = solo.tokens[0, sb : int(solo.lengths[0])].cpu().numpy()
            got = g_futs[i].result(timeout=1)["tokens"]
            k = 0
            while k < min(len(want), len(got)) and want[k] == got[k]:
                k += 1
            prefixes.append(k)
        worst = max(d / sd for d, sd, _ in diffs)
        print(f"  [pool vs solo] first-step logits (pool: N = {CONCURRENT} encode and prefill; "
              f"solo: B = 1, the same int8 slab): max |diff| {max(d for d, _, _ in diffs):.4f}, at most "
              f"{worst:.3f} x the logits' std (bound 0.25), argmax agreeing in "
              f"{sum(a for _, _, a in diffs)} of {len(diffs)}; common token prefix with a solo "
              f"decode_window of {EQUAL_TOKENS} tokens: {prefixes}")
        require(worst <= 0.25, f"pool vs solo: first-step logits differ by {worst:.3f} x std")

        a_futs, _, order, late, late_slot = drive(graphed_pool, abort_after=2)
        require(a_futs[0].result(timeout=1) is None, "abort: the aborted request did not resolve None")
        require(all(f.result(timeout=1) is not None for f in a_futs[1:])
                and late.result(timeout=1) is not None, "abort: the others did not finish")
        require(late_slot == order[0], f"abort: the queued request went to slot {late_slot}, not "
                f"the aborted request's {order[0]}")
        print(f"  [pool, abort] the request in slot {order[0]} aborted after two polls "
              f"(resolved None); the ninth request took its slot while the other seven finished")

        graphed_pool.shutdown()
        del graphed_pool, eager_pool, graphs

    # -- greedy on an int8 pool (K3), built and captured under load -------
    eng8 = SttEngine(dataclasses.replace(base, beam_size=1, compute_type="int8"),
                     model_name="large-v3", params=model)
    reset_counts()
    wall8, walls8, _ = run_concurrent("concurrent_greedy_int8", eng8, 1, INT8_TOKENS)
    paths["concurrent_greedy_int8"] = dict(kernels.LAUNCHES)
    need("concurrent_greedy_int8", ("log_mel", "flash_attention", "decode_attention"))
    owned("concurrent_greedy_int8_pool", [eng8._batchers[cfg.n_audio_ctx]._loop],
          ("decode_attention",), ("decode_attention_i4",))
    print(f"  [concurrent_greedy_int8] no warmup (the pool is built and captured under load), "
          f"{INT8_TOKENS}-token cap: set wall {wall8:.3f} s, request walls "
          f"{', '.join(f'{w:.2f}' for w in walls8)} s; launches "
          f"{paths['concurrent_greedy_int8']} [{card}]")
    eng8.shutdown()
    eng.shutdown()

    # -- beam 5 through the gang (K1, K2, K5, K6) -------------------------
    engb = SttEngine(base, model_name="large-v3", params=model)
    print(f"  [concurrent_beam] warmup(): {engb.warmup():.2f} s (the gang's buckets "
          f"included) [{card}]")
    gang = engb._beam_gang
    gangs, decode = [], gang._decode

    def recording(members):
        gangs.append((len(members), gang.batch_bucket(len(members))))
        return decode(members)

    gang._decode = recording
    reset_counts()
    wallb, wallsb, metricsb = run_concurrent("concurrent_beam", engb, BEAM)
    paths["concurrent_beam"] = dict(kernels.LAUNCHES)
    report_set("concurrent_beam", "engine_beam", wallb, wallsb, metricsb, -1)
    sequential["concurrent_beam"] = (audio_s, wallb, {})
    need("concurrent_beam", ("log_mel", "flash_attention", "beam_attention",
                             "beam_cross_attention"))
    owned("concurrent_beam_gang", list(gang.graphs._loops.values()),
          ("beam_attention", "beam_cross_attention"))
    print(f"  [concurrent_beam] gangs formed (members -> bucket): "
          f"{', '.join(f'{m}->{b}' for m, b in gangs)}; launches {paths['concurrent_beam']}")
    for st in gang.graphs.stats():
        print(f"  [concurrent_beam] gang class B = {st['key'][2]}: {st['graphs']} graph(s), "
              f"captured in {st['capture_s']:.2f} s, static buffers "
              f"{st['static_bytes'] / 2**20:.1f} MiB, pool grown by "
              f"{st['pool_bytes'] / 2**20:.1f} MiB [{card}]")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    engb.shutdown()
    own.close()


STREAM_CHUNK_MS = 200  # phase 8: the wire chunk of a stream
STREAM_SECONDS = 6.0  # phase 8: a stream's voiced clip
CAP_SECONDS, CAP_CHUNK_S = 32.0, 4.0  # phase 8: the clip that passes the 30 s cap, its chunks
STREAMS = 4  # phase 8: concurrent streams (parallel_requests and max_batch_size)
SILERO_TOL = 1e-4  # phase 8: Silero on the card against its CPU version


def wav_chunks(np, x, chunk_ms: int) -> tuple[list, bytes]:
    """A clip as a port-written WAV cut into wire chunks of ``chunk_ms``: the
    first chunk carries the 44-byte header and one byte more, so it and the
    last are odd-sized and every sample in between straddles a cut."""
    from sentiric_stt_whisper_service_tpu_torch.audio import write_wav

    buf = io.BytesIO()
    write_wav(buf, x)
    raw = buf.getvalue()
    step = 16 * chunk_ms * 2
    cuts = list(range(44 + step + 1, len(raw), step))
    chunks = [raw[a:b] for a, b in zip([0] + cuts, cuts + [len(raw)])]
    require(any(len(c) % 2 for c in chunks), "no odd-sized chunk")
    return chunks, raw


def pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


def streaming_phase(torch, np, model, paths, card) -> None:
    """Phase 8: streaming sessions and the Silero VAD on the card (see the
    module docstring)."""
    import dataclasses
    import tempfile
    import threading

    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.config import Settings
    from sentiric_stt_whisper_service_tpu_torch.models.graphs import DecodeGraphs, StepLoop
    from sentiric_stt_whisper_service_tpu_torch.models.silero_vad import (
        SileroVad,
        write_silero_ggml,
    )
    from sentiric_stt_whisper_service_tpu_torch.runtime import (
        RequestOptions,
        StreamingSession,
        SttEngine,
        engine as eng_mod,
        streaming,
        vad,
    )

    relaxed = dict(quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
                   min_segment_avg_prob=0.0)
    dev = model.decoder.pos_emb.device
    base = Settings(device=dev.type, compute_type="int4", language="auto", no_timestamps=False,
                    model_filename="ggml-large-v3.bin", parallel_requests=1,
                    stream_buffer_samples=8000, stream_incremental=False,
                    stream_greedy_partials=True, **relaxed)
    require(base.beam_size == BEAM and base.enable_vad, "the stock settings moved")
    rng = np.random.default_rng(SEED + 8)
    clip = voiced_like(rng, STREAM_SECONDS)
    chunks, raw = wav_chunks(np, clip, STREAM_CHUNK_MS)

    # Graph captures of every DecodeGraphs (the engine's classes and the gang's).
    captures = []
    new_loop = DecodeGraphs._new_loop

    def counting(self, key, *a, **kw):
        captures.append(key)
        return new_loop(self, key, *a, **kw)

    DecodeGraphs._new_loop = counting

    def cap_of(samples: int, incremental: bool) -> int:
        """The token cap a tick over ``samples`` asks for, as the engine rounds it."""
        top = streaming.TICK_CAP_MAX if incremental else streaming.PARITY_CAP_MAX
        want = max(streaming.TICK_CAP_MIN,
                   int(samples / 16000 * streaming.TICK_TOKENS_PER_SECOND) + 8)
        return eng_mod.token_cap_bucket(min(top, want))

    def timed_ticks(session, incremental=False):
        """Wraps the session's tick: (wall s, buffered s, cap) per tick."""
        ticks, tick = [], session._tick

        def timed():
            n = session.buffer.size
            t = time.perf_counter()
            out = tick()
            ticks.append((time.perf_counter() - t, n / 16000, cap_of(n, incremental)))
            return out

        session._tick = timed
        return ticks

    def run_stream(session, chunks_):
        """Every chunk as fast as the session takes it, then EOS. Returns the
        events before EOS, the EOS finals, each feed's (wall s, events) and
        the EOS wall."""
        events, feeds = [], []
        for c in chunks_:
            t = time.perf_counter()
            out = session.feed(c)
            feeds.append((time.perf_counter() - t, out))
            events.extend(out)
        t = time.perf_counter()
        finals = session.feed(b"")
        return events, finals, feeds, time.perf_counter() - t

    def check_events(path, events, finals, session):
        for e in events:
            if not e.is_final:
                require(e.result.text.endswith(" "), f"{path}: a partial does not end in ' '")
        require(finals and all(e.is_final for e in finals), f"{path}: no finals on EOS")
        require(session.buffer.size == 0, f"{path}: the buffer is not empty after EOS")
        for e in events + finals:
            require(e.result.t0 >= 0 and e.result.t1 >= 0, f"{path}: negative time")
        done = [e.result.t0 for e in events + finals if e.is_final]
        require(done == sorted(done), f"{path}: finals out of order: {done}")

    def tick_line(path, ticks):
        walls = [w for w, _, _ in ticks]
        print(f"  [{path}] {len(ticks)} ticks (wall s @ buffered s, cap): " + ", ".join(
            f"{w:.3f}@{b:.1f}/{c}" for w, b, c in ticks))
        print(f"  [{path}] tick p50 {pct(walls, 0.5):.3f} s, p90 {pct(walls, 0.9):.3f} s "
              f"[{card}]")
        return walls

    # -- 1. stream_parity -----------------------------------------------
    eng = SttEngine(base, model_name="large-v3", params=model)
    print(f"  [stream_parity] warmup(): {eng.warmup():.2f} s, {len(captures)} graph classes "
          f"(window loops of {sorted(k[4] for k in captures if k[0] == 'greedy')} self-cache "
          f"rows: the tick caps' and the sampled rung's; beam "
          f"{sorted(k[5] for k in captures if k[0] == 'beam')}) [{card}]")
    captures.clear()
    session = StreamingSession(eng, RequestOptions())
    ticks = timed_ticks(session)
    kernels.reset_launch_counts()
    events, feeds = [], []  # per chunk: (start s, end s, ticked, events)
    for c in chunks:
        n, t = len(ticks), time.perf_counter()
        out = session.feed(c)
        feeds.append((t, time.perf_counter(), len(ticks) > n, out))
        events.extend(out)
    tick_counts = dict(kernels.LAUNCHES)
    pcm, lang = session.buffer.read(), session._detected_lang
    decoded = []  # each window's token ids: the finalize, then the direct request
    decode_one = eng._decode_one

    def recording(*args, **kw):
        res = decode_one(*args, **kw)
        if res is not None:
            decoded.append(np.asarray(res.tokens[0, : int(res.lengths[0])]))
        return res

    eng._decode_one = recording
    t = time.perf_counter()
    finals = session.feed(b"")
    eos_wall = time.perf_counter() - t
    paths["stream_parity"] = dict(kernels.LAUNCHES)
    final_ids, decoded[:] = list(decoded), []
    require(not captures, f"stream_parity: {len(captures)} graph class(es) captured in the "
            f"ticks or the finalize: {[k[:6] for k in captures]}")
    check_events("stream_parity", events, finals, session)
    require(all(not e.is_final for e in events), "stream_parity: a final before EOS")
    direct = eng.transcribe_pcm16(pcm, 16000, dataclasses.replace(RequestOptions(),
                                                                 language=lang))
    eng._decode_one = decode_one
    direct = [r for r in direct if r.text]
    require([(r.text, r.t0, r.t1, [k.text for k in r.tokens]) for r in direct]
            == [(e.result.text, e.result.t0, e.result.t1, [k.text for k in e.result.tokens])
                for e in finals]
            and len(decoded) == len(final_ids)
            and all(np.array_equal(a, b) for a, b in zip(decoded, final_ids)),
            "stream_parity: the EOS finals differ from transcribe_pcm16 of the same buffer")
    walls = tick_line("stream_parity", ticks)
    crossed = next(i for i, f in enumerate(feeds) if f[2])  # the chunk that crossed 500 ms
    first = next(i for i, f in enumerate(feeds) if f[3])  # the chunk that got the first partial
    tick_delta = {k: tick_counts[k] for k in ("log_mel", "flash_attention", "decode_attention_i4")}
    eos_delta = {k: paths["stream_parity"][k] - tick_counts[k]
                 for k in ("beam_attention", "beam_cross_attention")}
    require(all(tick_delta.values()), f"stream_parity: the ticks launched {tick_delta}")
    require(all(eos_delta.values()), f"stream_parity: the EOS finals launched {eos_delta}")
    print(f"  [stream_parity] {STREAM_SECONDS:.0f} s voiced WAV in {len(chunks)} chunks of "
          f"{STREAM_CHUNK_MS} ms, language auto (pinned {lang!r}), beam {BEAM} finals, greedy "
          f"partials: first partial {(feeds[first][1] - feeds[crossed][0]) * 1e3:.1f} ms after "
          f"the chunk that crossed 500 ms arrived (chunk {crossed}; the partial came with "
          f"chunk {first}); EOS -> last final {eos_wall:.3f} s "
          f"(stream_p50_final_latency, one stream) [{card}]")
    print(f"  [stream_parity] {sum(1 for e in events if not e.is_final)} partials, "
          f"{len(finals)} finals equal to transcribe_pcm16 of the same {len(pcm) / 16000:.2f} s "
          f"buffer (token ids of {len(final_ids)} window(s)); no graph captured in the ticks "
          f"or the finalize; tick launches {tick_delta}, EOS {eos_delta}")

    # -- 2. stream_incremental ------------------------------------------
    session = StreamingSession(eng, RequestOptions(), incremental=True)
    inc_ticks = timed_ticks(session, incremental=True)
    kernels.reset_launch_counts()
    events, fed_bytes = [], -44
    for c in chunks:
        events.extend(session.feed(c))
        fed_bytes += len(c)
        require(session.buffer.size == fed_bytes // 2 - session.trimmed_samples
                <= streaming.MAX_BUFFER_SAMPLES,
                "stream_incremental: the buffer is not the uncommitted tail")
    trimmed = session.trimmed_samples
    finals = session.feed(b"")
    paths["stream_incremental"] = dict(kernels.LAUNCHES)
    check_events("stream_incremental", events, finals, session)
    commits = [e for e in events if e.is_final]
    tick_line("stream_incremental", inc_ticks)
    print(f"  [stream_incremental] {len(commits)} commit(s) before EOS "
          f"{[(e.result.t0, e.result.t1) for e in commits]}, {trimmed} samples trimmed, "
          f"{len(finals)} final(s) on EOS")
    need_launched(paths, "stream_incremental", ("log_mel", "flash_attention",
                                                "decode_attention_i4"))

    # -- 3. stream_cap ----------------------------------------------------
    cap_chunks, _ = wav_chunks(np, voiced_like(rng, CAP_SECONDS), int(CAP_CHUNK_S * 1000))
    session = StreamingSession(eng, RequestOptions())
    cap_ticks = timed_ticks(session)
    events = []
    for c in cap_chunks[:-1]:
        events.extend(session.feed(c))
    require(all(not e.is_final for e in events), "stream_cap: a final before the cap")
    kernels.reset_launch_counts()
    t = time.perf_counter()
    flushed = session.feed(cap_chunks[-1])
    flush_wall = time.perf_counter() - t
    paths["stream_cap"] = dict(kernels.LAUNCHES)
    finals = [e for e in flushed if e.is_final]
    require(finals and session.buffer.size == 0, "stream_cap: the 30 s cap flushed no finals")
    need_launched(paths, "stream_cap", ("beam_attention", "beam_cross_attention"))
    tick_line("stream_cap", cap_ticks)
    print(f"  [stream_cap] {CAP_SECONDS:.0f} s in {CAP_CHUNK_S:.0f} s chunks: the tick past the "
          f"cap {flush_wall:.3f} s with the beam-{BEAM} re-decode, {len(finals)} final(s) up to "
          f"{finals[-1].result.t1 / 100:.2f} s; launches {paths['stream_cap']} [{card}]")
    session.feed(b"")
    eng.shutdown()

    # -- 4. concurrent_streams ------------------------------------------
    own = OwnLaunches(StepLoop)
    engc = SttEngine(dataclasses.replace(base, parallel_requests=STREAMS,
                                         max_batch_size=STREAMS, language="en",
                                         request_queue_timeout_ms=600_000),
                     model_name="large-v3", params=model)
    print(f"  [concurrent_streams] warmup(): {engc.warmup():.2f} s [{card}]")
    clips = [wav_chunks(np, voiced_like(rng, STREAM_SECONDS), STREAM_CHUNK_MS)[0]
             for _ in range(STREAMS)]
    results, errors = [None] * STREAMS, []
    start = threading.Barrier(STREAMS + 1)

    def go(i):
        try:
            s = StreamingSession(engc, RequestOptions(language="en"))
            tk = timed_ticks(s)
            start.wait(timeout=120)
            results[i] = (tk, *run_stream(s, clips[i]), s)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"stream {i}: {type(e).__name__}: {e}")

    kernels.reset_launch_counts()
    own.counts.clear()
    threads = [threading.Thread(target=go, args=(i,)) for i in range(STREAMS)]
    for th in threads:
        th.start()
    start.wait(timeout=120)
    t = time.perf_counter()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t
    require(not any(th.is_alive() for th in threads), "concurrent_streams: a stream hung")
    require(not errors, f"concurrent_streams: {errors}")
    paths["concurrent_streams"] = dict(kernels.LAUNCHES)
    need_launched(paths, "concurrent_streams", ("log_mel", "flash_attention",
                                                "beam_attention", "beam_cross_attention"))
    pool = engc._batchers[model.cfg.n_audio_ctx]
    own.record(paths, "concurrent_streams_pool", [pool._loop], ("decode_attention",),
               ("decode_attention_i4",))
    own.close()
    all_ticks = []
    for i, (tk, events, finals, _, eos_w, s) in enumerate(results):
        check_events(f"concurrent_streams {i}", events, finals, s)
        all_ticks.extend(w for w, _, _ in tk)
        print(f"  [concurrent_streams] stream {i}: {len(tk)} ticks, {len(finals)} final(s), "
              f"EOS -> last final {eos_w:.3f} s")
    print(f"  [concurrent_streams] {STREAMS} streams of {STREAM_SECONDS:.0f} s at once in "
          f"{wall:.3f} s: tick p50 {pct(all_ticks, 0.5):.3f} s, p90 {pct(all_ticks, 0.9):.3f} s "
          f"(one stream: p50 {pct(walls, 0.5):.3f}, p90 {pct(walls, 0.9):.3f}); pool "
          f"{pool.pool_bytes / 2**20:.1f} MiB; launches {paths['concurrent_streams']} [{card}]")
    engc.shutdown()
    DecodeGraphs._new_loop = new_loop

    # -- 5. silero --------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ggml-silero-v6.2.0.bin"
        write_silero_ggml(path, SileroVad.random_init("cpu", seed=SEED).params)
        require(vad.load_silero(path, device=dev.type), "silero: load_silero refused the file")
    gate = vad._vad_model
    require(isinstance(gate, SileroVad) and gate.device.type == dev.type,
            "silero: not on the engine's device")
    plain = SileroVad(gate.params, "cpu")
    audio30 = voiced_like(rng, 30.0)
    got, want = gate(audio30), plain(audio30)
    err = float(np.abs(got - want).max())
    require(got.shape == want.shape == (len(audio30) // 512,) and err <= SILERO_TOL,
            f"silero: card vs CPU max_abs_err {err:.3e} (tol {SILERO_TOL:.0e})")
    ms = time_ms(lambda: gate(audio30), iters=10)
    silent = np.zeros(48000, np.float32)
    decisions = [vad.is_speech_detected(x, 16000, base.vad_threshold, 250)
                 for x in (clip, silent)]
    eng = SttEngine(base, model_name="large-v3", params=model)
    res = eng.transcribe_pcm16((clip * 32767).astype(np.int16), 16000, RequestOptions(beam_size=1))
    eng.shutdown()
    vad.set_vad_model(None)
    require(bool(res), "silero: the request through the Silero gate returned nothing")
    print(f"  [silero] random init (seed {SEED}) written and loaded: 30 s clip ({len(got)} "
          f"frames) on the card vs the CPU's cell loop: max_abs_err {err:.3e} (tol "
          f"{SILERO_TOL:.0e}: fp32, TF32 off, sums in another order over {len(got)} steps); "
          f"{ms:.3f} ms per 30 s of audio (host copies included) [{card}]; gate at "
          f"{base.vad_threshold}: voiced {decisions[0]}, silent {decisions[1]}; one "
          f"transcribe_pcm16 through the gate: {len(res)} result(s), language "
          f"{res[0].language!r}")


SERVE_PARALLEL = 4  # phase 9: parallel_requests and max_batch_size
SERVE_CLIP_S = 12.0  # phase 9: the HTTP and unary requests' clip
SERVE_SET_S = (5.0, 12.0, 21.0, 30.0)  # phase 9: the four requests sent at once
SERVE_CANCEL_S = 30.0  # phase 9: the cancelled request's clip
SIX = ("log_mel", "flash_attention", "decode_attention", "decode_attention_i4",
       "beam_attention", "beam_cross_attention")


def serving_phase(torch, np, paths, card, sets) -> None:
    """Phase 9: the service on the card through its front ends (see the
    module docstring)."""
    import contextlib
    import importlib
    import logging
    import os
    import socket
    import threading
    import urllib.error
    import urllib.request

    import grpc

    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.audio import parse_wav_robust, write_wav
    from sentiric_stt_whisper_service_tpu_torch.config import Settings
    from sentiric_stt_whisper_service_tpu_torch.runtime import RequestOptions, streaming
    from sentiric_stt_whisper_service_tpu_torch.serving import main as serving_main
    from sentiric_stt_whisper_service_tpu_torch.serving.http_server import segments_json

    cli = importlib.import_module(f"{PKG}.cli.main")

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def wav_of(x) -> bytes:
        buf = io.BytesIO()
        write_wav(buf, x)
        return buf.getvalue()

    relaxed = dict(quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
                   min_segment_avg_prob=0.0)
    settings = Settings(device="auto", compute_type="int4", enable_vad=True, language="auto",
                        model_filename="ggml-large-v3.bin", parallel_requests=SERVE_PARALLEL,
                        max_batch_size=SERVE_PARALLEL, request_queue_timeout_ms=600_000,
                        host="127.0.0.1", grpc_port=free_port(), http_port=free_port(),
                        metrics_port=free_port(), **relaxed)
    require(settings.beam_size == BEAM, "the default beam size moved")
    os.environ["STT_WHISPER_SERVICE_WARMUP"] = "true"
    torch.cuda.reset_peak_memory_stats()
    threads_before = {t for t in threading.enumerate() if not t.daemon}
    t = time.perf_counter()
    engine, server, apps, _ = serving_main.serve(settings, random_init=True, block=False)
    print(f"  [serving] serve(): random init (seed 0), quantize, warmup() and three listeners "
          f"in {time.perf_counter() - t:.1f} s; {len(engine.graphs.stats())} graph classes "
          f"[{card}]")

    events = []  # the service's log events from here on: (event, level, message)

    class Capture(logging.Handler):
        def emit(self, record):
            events.append((getattr(record, "event", "LOG_EVENT"), record.levelname,
                           record.getMessage()))

    logging.getLogger().handlers = [Capture()]
    try:
        statuses = []  # every HTTP reply's status
        http = f"http://127.0.0.1:{settings.http_port}"
        addr = f"127.0.0.1:{settings.grpc_port}"

        def post(path, fields, tenant="smoke"):
            """A multipart POST: (status, JSON, wall s)."""
            boundary = "sstw-smoke-boundary"
            body = b""
            for name, value in fields:
                fname = '; filename="a.wav"' if isinstance(value, bytes) else ""
                data = value if isinstance(value, bytes) else str(value).encode()
                body += (f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"{fname}'
                         f"\r\n\r\n").encode() + data + b"\r\n"
            body += f"--{boundary}--\r\n".encode()
            headers = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
            if tenant:
                headers["X-Tenant-ID"] = tenant
            req = urllib.request.Request(http + path, data=body, headers=headers, method="POST")
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    status, reply = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                status, reply = e.code, json.loads(e.read())
            statuses.append(status)
            return status, reply, time.perf_counter() - t0

        def get(url):
            with urllib.request.urlopen(url, timeout=60) as r:
                statuses.append(r.status)
                return r.status, r.read().decode()

        def direct(pcm, **opts):
            """``transcribe_pcm16`` on the same engine with the servers' options
            (an abort poll that never fires): (results, wall s). Its launches are
            kept out of the path's counts."""
            snap = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.transcribe_pcm16(pcm, 16000, RequestOptions(should_abort=lambda: False,
                                                                     **opts))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kernels.LAUNCHES.update(snap)
            return res, wall

        def quiet(fn, *args):
            """A CLI call with its printout counted, not shown (main thread only)."""
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                result = fn(*args)
            return result, len(out.getvalue().splitlines())

        def words(res):
            return [(k.text, k.t0 / 100.0, k.t1 / 100.0) for k in res.tokens]

        rng = np.random.default_rng(SEED + 9)
        wav12 = wav_of(voiced_like(rng, SERVE_CLIP_S))
        pcm12 = parse_wav_robust(wav12).pcm_data
        want12, direct_wall = direct(pcm12)
        require(bool(want12), "serving: the direct request kept no segment")
        kernels.reset_launch_counts()

        # -- 1. HTTP -------------------------------------------------------------
        for route in ("/v1/transcribe", "/v1/audio/transcriptions"):
            status, reply, wall = post(route, [("file", wav12)])
            require(status == 200, f"serving: {route} replied {status}: {reply}")
            require(reply["text"] == "".join(r.text for r in want12)
                    and reply["language"] == want12[-1].language
                    and reply["segments"] == json.loads(json.dumps(segments_json(want12)))
                    and reply["duration"] == SERVE_CLIP_S,
                    f"serving: {route}'s reply differs from transcribe_pcm16 of the same PCM")
            print(f"  [serving] HTTP {route}: {len(reply['segments'])} segment(s) equal to a direct "
                  f"transcribe_pcm16; wall {wall:.3f} s against the direct call's "
                  f"{direct_wall:.3f} s (server cost {1e3 * (wall - direct_wall):.1f} ms) [{card}]")
        status, reply, _ = post("/v1/transcribe", [("file", wav12)], tenant=None)
        require(status == 400 and "tenant_id" in reply["error"], f"serving: no tenant gave {status}")
        status, _, _ = post("/v1/transcribe", [("language", "en")])
        require(status == 400, f"serving: no file gave {status}")
        status, body = get(http + "/health")
        require(status == 200 and json.loads(body)["model_ready"] is True, "serving: /health not ready")
        _, body = get(f"http://127.0.0.1:{settings.metrics_port}/metrics")
        require("stt_requests_total 4.0" in body
                and f"stt_audio_seconds_processed_total {2 * SERVE_CLIP_S}" in body,
                "serving: /metrics does not count the four requests and 24 audio-s")
        print("  [serving] HTTP: no tenant 400, no file 400, /health ready, /metrics counts 4 "
              "requests and 24.0 audio-s")

        # -- 2. gRPC unary and health ------------------------------------------
        with grpc.insecure_channel(addr) as ch:
            check = ch.unary_unary("/grpc.health.v1.Health/Check")
            require(check(b"", timeout=60) == bytes([0x08, 1]), "serving: health Check not SERVING")
            t0 = time.perf_counter()
            resp, lines = quiet(cli._unary, ch, wav12)
            wall = time.perf_counter() - t0
        r0 = want12[0]
        require(resp.transcription == r0.text and resp.language == r0.language
                and resp.speaker_id == r0.speaker_id and resp.duration == SERVE_CLIP_S
                and [(w.word, w.start, w.end) for w in resp.words] == words(r0),
                "serving: the unary reply differs from transcribe_pcm16 of the same PCM")
        print(f"  [serving] gRPC health SERVING; cli._unary: reply equal to the direct call's first "
              f"segment ({len(resp.words)} words, {lines} lines printed); wall {wall:.3f} s against "
              f"{direct_wall:.3f} s (server cost {1e3 * (wall - direct_wall):.1f} ms) [{card}]")

        # -- 3. gRPC stream at real time ---------------------------------------
        wav6 = wav_of(voiced_like(rng, STREAM_SECONDS))
        finalizing = []  # (buffer, pinned language) of each finalize
        finalize = streaming.StreamingSession.finalize

        def recording_finalize(self):
            finalizing.append((self.buffer.read().copy(), self._detected_lang))
            return finalize(self)

        streaming.StreamingSession.finalize = recording_finalize
        try:
            with grpc.insecure_channel(addr) as ch:
                (sent, received), _ = quiet(cli._stream, ch, wav6)
        finally:
            streaming.StreamingSession.finalize = finalize
        require(len(finalizing) == 1, f"serving: {len(finalizing)} finalizes in one stream")
        partials = [(t0, r) for t0, r in received if not r.is_final]
        finals = [(t0, r) for t0, r in received if r.is_final]
        require(finals and all(t0 >= sent[-1] for t0, _ in finals),
                "serving: a final came before EOS, or none came")
        require(all(t0 < finals[0][0] for t0, _ in partials), "serving: a partial after a final")
        pcm_s, lang = finalizing[0]
        want_s, _ = direct(pcm_s, language=lang)
        want_s = [r for r in want_s if r.text]
        require([(r.transcription, [(w.word, w.start, w.end) for w in r.words]) for _, r in finals]
                == [(r.text, words(r)) for r in want_s],
                "serving: the stream's finals differ from transcribe_pcm16 of the whole buffer")
        first = (f"{1e3 * (partials[0][0] - sent[0]):.1f} ms after the chunk that crossed 500 ms "
                 f"(chunk 0, sent at t = 0)" if partials else "none (the VAD gated every tick)")
        print(f"  [serving] cli._stream: {STREAM_SECONDS:.0f} s in {len(sent) - 1} chunks of "
              f"{cli.CHUNK_S} s at real time (sent over {sent[-1] - sent[0]:.2f} s), language auto "
              f"(pinned {lang!r}): {len(partials)} partials, none final; first partial {first}; "
              f"{len(finals)} final(s) after EOS, equal to transcribe_pcm16 of the "
              f"{len(pcm_s) / 16000:.2f} s buffer; EOS -> last final "
              f"{received[-1][0] - sent[-1]:.3f} s [{card}]")
        print(f"  [serving] stream timeline, s after chunk 0: EOS sent {sent[-1] - sent[0]:.2f}; "
              f"replies " + ", ".join(f"{t0 - sent[0]:.2f}{'F' if r.is_final else 'p'}"
                                      for t0, r in received))

        # -- 4. four requests at once: gRPC unary (beam 5: the gang), then HTTP
        # with beam_size 1 (greedy: the batcher's pool) ---------------------------
        set_wavs = [wav_of(voiced_like(rng, sec)) for sec in SERVE_SET_S]
        set_audio = sum(SERVE_SET_S)

        def at_once(call):
            results, errors = [None] * len(set_wavs), []
            start = threading.Barrier(len(set_wavs) + 1)

            def go(i):
                try:
                    start.wait(timeout=120)
                    results[i] = call(set_wavs[i])
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"{SERVE_SET_S[i]:.0f} s: {type(e).__name__}: {e}")

            threads = [threading.Thread(target=go, args=(i,)) for i in range(len(set_wavs))]
            for th in threads:
                th.start()
            start.wait(timeout=120)
            t0 = time.perf_counter()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t0
            require(not any(th.is_alive() for th in threads) and not errors,
                    f"serving: requests at once failed: {errors}")
            return results, wall

        def unary_call(wav):
            """``cli._unary``'s call without its printout (``quiet`` redirects the
            process's stdout, which threads must not do)."""
            with grpc.insecure_channel(addr) as ch:
                return cli._transcribe_call(ch)(cli.stt_pb2.WhisperTranscribeRequest(
                    audio_data=wav), metadata=cli._METADATA, timeout=600)

        replies, wall_g = at_once(unary_call)
        require(all(r.words and r.duration > 0 for r in replies), "serving: a unary reply is empty")
        replies_h, wall_h = at_once(lambda wav: post("/v1/transcribe", [("file", wav),
                                                                        ("beam_size", "1")]))
        require(all(st == 200 and rep["segments"] for st, rep, _ in replies_h),
                "serving: an HTTP reply of the set failed or is empty")
        p7 = {k: f"{a / w:.2f} audio-s/s ({w:.3f} s for {a:.1f} audio-s)"
              for k, (a, w, _) in sets.items() if k.startswith("concurrent")}
        print(f"  [serving] four requests at once ({', '.join(f'{x:.0f}' for x in SERVE_SET_S)} s): "
              f"gRPC unary, beam {BEAM} (the gang) {wall_g:.3f} s, {set_audio / wall_g:.2f} "
              f"audio-s/s; HTTP beam_size 1 (the batcher) {wall_h:.3f} s, "
              f"{set_audio / wall_h:.2f} audio-s/s; phase 7 (eight at once, engine direct): "
              f"greedy {p7.get('concurrent_greedy')}, beam {p7.get('concurrent_beam')} [{card}]")

        # -- 5. a cancelled unary call: the decode stops on the device ------------
        layers = engine.cfg.n_text_layer
        done, seen = threading.Event(), {}
        transcribe = engine.transcribe_pcm16

        def spy(*a, **kw):
            try:
                seen["results"] = transcribe(*a, **kw)
            finally:
                done.set()
            return seen["results"]

        engine.transcribe_pcm16 = spy
        k5_before = kernels.LAUNCHES["beam_attention"]
        try:
            with grpc.insecure_channel(addr) as ch:
                fut = cli._transcribe_call(ch).future(cli.stt_pb2.WhisperTranscribeRequest(
                    audio_data=wav_of(voiced_like(rng, SERVE_CANCEL_S))), metadata=cli._METADATA)
                deadline = time.perf_counter() + 120
                while (kernels.LAUNCHES["beam_attention"] == k5_before
                       and time.perf_counter() < deadline and not fut.done()):
                    time.sleep(0.002)
                t_cancel = time.perf_counter()
                fut.cancel()
                require(done.wait(120), "serving: the cancelled request never returned")
                t_back = time.perf_counter()
        finally:
            del engine.transcribe_pcm16
        steps = (kernels.LAUNCHES["beam_attention"] - k5_before) / layers
        budget = 224  # engine.SAMPLE_LEN: a window's sampled-token budget
        require(0 < steps < budget, f"serving: the cancelled decode ran {steps:.0f} of {budget} steps")
        print(f"  [serving] a cancelled unary call (30 s clip, beam {BEAM}): the decode stopped after "
              f"{steps:.0f} of {budget} steps ({kernels.LAUNCHES['beam_attention'] - k5_before} K5 "
              f"launches / {layers} layers), {1e3 * (t_back - t_cancel):.1f} ms after the cancel; "
              f"{len(seen.get('results') or [])} result(s) [{card}]")

        # -- 6. /debug/profile while a request runs ------------------------------
        # The profile starts first (it waits for no device work then), and a
        # request starts inside its recorded second, after the tracer's
        # lead-in; its stop waits for the request's decode in flight, so the
        # trace holds that decode.
        from sentiric_stt_whisper_service_tpu_torch.serving.device_trace import LEAD_IN_S

        captured = len(engine.graphs.stats())
        profiled, inside = [], []
        profiler = threading.Thread(target=lambda: profiled.append(
            post("/debug/profile?seconds=1", [])))
        worker = threading.Thread(target=lambda: inside.append(
            post("/v1/transcribe", [("file", wav12)])))
        profiler.start()
        time.sleep(LEAD_IN_S + 0.3)
        worker.start()
        profiler.join(timeout=600)
        worker.join(timeout=600)
        require(bool(profiled), "serving: /debug/profile never replied")
        status, reply, prof_wall = profiled[0]
        require(status == 200, f"serving: /debug/profile replied {status}")
        trace = Path(reply["trace_dir"]) / "trace.json"
        text = trace.read_text()
        named = [k for k in PROFILE_KERNELS if k in text]
        require(bool(named), "serving: the profile's trace names none of the port's kernels")
        require(bool(inside) and inside[0][0] == 200, "serving: the request inside the profile failed")
        written = [m for e, _, m in events if e == "PROFILE_WRITTEN"]
        require(len(written) == 1, f"serving: {len(written)} PROFILE_WRITTEN events")
        print(f"  [serving] /debug/profile?seconds=1 with a request started inside it: replied in "
              f"{prof_wall:.2f} s, a {trace.stat().st_size / 1e6:.1f} MB Chrome trace naming "
              f"{named}; graph classes captured meanwhile: "
              f"{len(engine.graphs.stats()) - captured} [{card}]")
        print(f"  [serving] the request inside the profile: wall {inside[0][2]:.3f} s against the "
              f"direct call's {direct_wall:.3f} s (the profile's cost to it "
              f"{inside[0][2] - direct_wall:.3f} s); the server: {written[0]} [{card}]")
        # The profile's hold of the device (the recorder's stop holds back
        # graph launches while it runs) and the request's loss, against
        # their targets: a 1 s trace holds the device at most 2 s, the
        # request loses at most 5 s.
        held = re.search(r"held the device(?:'s graph launches)? ([0-9.]+) s", written[0])
        hold_s = float(held.group(1)) if held else float("nan")
        loss_s = inside[0][2] - direct_wall
        print(f"  [serving] /debug/profile: hold {hold_s:.3f} s (target <= 2 s), the request's loss "
              f"{loss_s:.3f} s (target <= 5 s): "
              f"{'met' if hold_s <= 2.0 and loss_s <= 5.0 else 'missed'} [{card}]")

        paths["serving"] = dict(kernels.LAUNCHES)
        need_launched(paths, "serving", SIX)
        # Errors other than the tenant gate's own (one request sent without a
        # tenant on purpose): the stream servicer logs a failed tick and goes on.
        bad = [e[:2] for e in events
               if e[1] in ("ERROR", "CRITICAL") and e[0] != "MISSING_TENANT_ID"]
        require(not bad and all(st < 500 for st in statuses),
                f"serving: error events {bad[:5]} or 5xx replies {[st for st in statuses if st >= 500]}")
        counts = {}
        for name, _, _ in events:
            counts[name] = counts.get(name, 0) + 1
        print(f"  [serving] log events {counts}; HTTP statuses {sorted(set(statuses))}; launches "
              f"{paths['serving']}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:  # the service stops whatever failed, so the run can exit
        # -- 7. shutdown -----------------------------------------------------
        t0 = time.perf_counter()
        serving_main.shutdown(engine, server, apps)
    left = {t for t in threading.enumerate() if not t.daemon} - threads_before
    require(not left, f"serving: threads left after shutdown: {[t.name for t in left]}")
    require(not any(app.thread.is_alive() for app in apps), "serving: a listener's loop runs on")
    print(f"  [serving] shutdown in {time.perf_counter() - t0:.2f} s: no thread left")


SPEC_SECONDS = (12.0, 30.0)  # phase 11: the windows, each decoded alone (batch 1)
SPEC_EQUAL_TOKENS = 32  # phase 11: the graphed rounds against eager ones


def spec_phase(torch, np, model, paths, card, drift, requests, sequential) -> None:
    """Phase 11: speculative decoding (see the module docstring)."""
    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.config import Settings
    from sentiric_stt_whisper_service_tpu_torch.models import (
        DecodeGraphs,
        TokenIds,
        build_suppress_mask,
        config_for,
        decode_window,
        encoder_apply,
        init_params,
        precompute_xa_kv,
    )
    from sentiric_stt_whisper_service_tpu_torch.models.sampling import logit_processor
    from sentiric_stt_whisper_service_tpu_torch.models.speculative import (
        SpecStats,
        decode_window_spec,
    )
    from sentiric_stt_whisper_service_tpu_torch.models.whisper import (
        decoder_apply,
        decoder_verify,
        init_kv_cache,
    )
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel, pad_or_trim
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import fuse_decoder_qkv, quantize_params
    from sentiric_stt_whisper_service_tpu_torch.runtime import (
        PerformanceMetrics,
        RequestOptions,
        SttEngine,
    )
    from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

    dev = torch.device("cuda")
    cfg, dcfg = config_for("large-v3"), config_for("large-v3-turbo")
    t0 = time.perf_counter()
    with torch.inference_mode():
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 12)
        draft = fuse_decoder_qkv(quantize_params(init_params(dcfg, g)))
    torch.cuda.synchronize()
    print(f"  draft large-v3-turbo ({dcfg.n_text_layer} decoder layers, d {dcfg.n_text_state}): "
          f"random init + quantize + fuse {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    tok = fallback_tokenizer(cfg.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sup = torch.from_numpy(build_suppress_mask(cfg.n_vocab, ids, tok.non_speech_tokens)).to(dev)
    sot = tok.sot_sequence("en")
    sb = len(sot)
    tinit = torch.full((1, cfg.n_text_ctx), ids.eot, dtype=torch.int64, device=dev)
    tinit[0, :sb] = torch.tensor(sot, device=dev)
    f8 = torch.float8_e4m3fn
    graphs = DecodeGraphs()
    rng = np.random.default_rng(SEED + 12)
    windows = {f"{s:.0f} s": torch.from_numpy(pad_or_trim(speech_like(rng, s))[None]).to(dev)
               for s in SPEC_SECONDS}
    process = logit_processor(cfg.n_vocab, ids, sup, True)

    def encode(audio):
        """K1, K2 and both models' int4 slabs from one encode of the target."""
        mel = compute_log_mel(audio, n_mels=cfg.n_mels, dtype=cfg.dtype)
        xa = encoder_apply(cfg, model, mel)
        return precompute_xa_kv(cfg, model, xa, 4), precompute_xa_kv(dcfg, draft, xa, 4)

    def greedy(xa_t, _xa_d, budget=DECODE_TOKENS, stats=None):
        return decode_window(cfg, model, xa_t, tinit, sb, 0, ids, sup, max_len=sb + budget,
                             self_dtype=f8, graphs=graphs)

    def spec_with(d_cfg, d_model, own_slab):
        def run(xa_t, xa_d, budget=DECODE_TOKENS, stats=None, **kw):
            return decode_window_spec(cfg, model, xa_t, d_cfg, d_model, xa_t if own_slab else xa_d,
                                      tinit, sb, 0, ids, sup, max_len=sb + budget,
                                      gamma=SPEC_GAMMA, self_dtype=f8, graphs=graphs,
                                      stats=stats, **kw)
        return run

    runs = {"c": ("graphed decode_window, t = 0", greedy),
            "a": ("spec, the target as its own draft", spec_with(cfg, model, True)),
            "b": ("spec, the turbo draft", spec_with(dcfg, draft, False))}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def divergence(res, ref) -> Optional[int]:
        n = min(int(res.lengths[0]), int(ref.lengths[0]))
        diff = (res.tokens[0, sb:n] != ref.tokens[0, sb:n]).nonzero()
        if diff.numel():
            return sb + int(diff[0, 0])
        return None if int(res.lengths[0]) == int(ref.lengths[0]) else n

    def verify_margin(xa_t, tokens, d: int) -> float:
        """The top-two margin of the processed verify logits for position
        ``d`` after the common prefix: a plain prefill of positions < d - 1,
        then the verify pass from d - 1."""
        with torch.inference_mode():
            kv = init_kv_cache(cfg, 1, cfg.n_text_ctx, dtype=f8, device=dev)
            if d > 1:
                decoder_apply(cfg, model, tokens[:, : d - 1], 0, kv, xa_t)
            start = min(d - 1, cfg.n_text_ctx - SPEC_GAMMA - 1)
            logits = decoder_verify(cfg, model, tokens[:, start: start + SPEC_GAMMA + 1],
                                    torch.tensor([d - 1], device=dev), kv, xa_t)
            proc = process(logits[:, d - 1 - start], tokens, torch.tensor([d], device=dev),
                           torch.tensor([sb], device=dev))
            top = proc[0].topk(2).values
        return float(top[0] - top[1])

    for label, audio in windows.items():
        with torch.inference_mode():
            xa_t, xa_d = encode(audio)
        results = {}
        for key in ("c", "a", "b"):
            name, fn = runs[key]
            before = len(graphs.stats())
            _, first_wall = timed(lambda: fn(xa_t, xa_d))
            for st in graphs.stats()[before:]:
                print(f"  [{label} {key}] captured {st['graphs']} graph(s) of a "
                      f"{'round' if st['key'][0] == 'spec' else 'step'} in "
                      f"{st['capture_s']:.2f} s (eager warm-up included); static buffers "
                      f"{st['static_bytes'] / 2**20:.1f} MiB, graph pool grown by "
                      f"{st['pool_bytes'] / 2**20:.1f} MiB; the capturing run's wall "
                      f"{first_wall:.3f} s [{card}]")
            stats = SpecStats()
            kernels.reset_launch_counts()
            # The path: the encode (K1, K2, both slabs) and the decode, together.
            res, wall = timed(lambda: fn(*encode(audio), stats=stats))
            counts = dict(kernels.LAUNCHES)
            results[key] = res
            n_tok = int(res.lengths[0]) - sb
            lp = res.token_logprobs[0, sb:sb + n_tok]
            require(bool(torch.isfinite(lp).all()) and n_tok > 0,
                    f"[{label} {key}] no finite tokens")
            line = (f"  [{label} {key}] {name}: {n_tok} tokens, wall {wall:.3f} s (encode "
                    f"included), {n_tok / wall:.1f} tokens/s")
            if key != "c":
                line += (f"; {stats.rounds} rounds, {stats.emitted / stats.rounds:.2f} tokens "
                         f"and {stats.accepted / stats.rounds:.2f} accepted drafts a round "
                         f"({stats.accepted} of {stats.rounds * SPEC_GAMMA} proposed)")
            print(line + f" [{card}]; launches {counts}")
            if label == "12 s":
                path = {"c": "spec_greedy", "a": "spec_self", "b": "spec_turbo"}[key]
                paths[path] = counts
                if key == "c":
                    need_launched(paths, path, ("log_mel", "flash_attention",
                                                "decode_attention_i4"))
                    continue
                need_launched(paths, path, ("log_mel", "flash_attention", "decode_attention_i4",
                                            "beam_cross_attention"),
                              absent=("decode_attention", "beam_attention"))
                replays, left = divmod(counts["beam_cross_attention"], cfg.n_text_layer)
                d_layers = (cfg if key == "a" else dcfg).n_text_layer
                require(left == 0 and counts["decode_attention_i4"] == replays * SPEC_GAMMA * d_layers,
                        f"{path}: K6 {counts['beam_cross_attention']} and K4 "
                        f"{counts['decode_attention_i4']} launches are not {cfg.n_text_layer} "
                        f"and {SPEC_GAMMA} x {d_layers} a round")
                require(replays >= stats.rounds, f"{path}: fewer round replays than rounds")
                print(f"  [{label} {key}] K6 {cfg.n_text_layer} and K4 {SPEC_GAMMA} x {d_layers} "
                      f"launches a round: {replays} rounds replayed for {stats.rounds} run")
        for key in ("a", "b"):
            d = divergence(results[key], results["c"])
            if d is None:
                print(f"  [{label} {key}] token for token equal to (c) over "
                      f"{int(results['c'].lengths[0]) - sb} tokens")
                continue
            margin = verify_margin(xa_t, results["c"].tokens, d)
            print(f"  [{label} {key}] equal to (c) up to position {d} ({d - sb} tokens); there "
                  f"the verify logits' top-two margin is {margin:.4f}, the step-vs-teacher-"
                  f"forced drift {drift:.4f}")
            require(margin <= 2 * drift,
                    f"[{label} {key}] diverges from (c) at position {d} with a margin "
                    f"{margin:.4f} above twice the drift {drift:.4f}")
        same_ab = divergence(results["a"], results["b"])
        print(f"  [{label}] (a) and (b): "
              f"{'equal' if same_ab is None else f'differ from position {same_ab}'}")
        if label == "12 s":  # the graphed rounds against eager ones, every field
            for key in ("a", "b"):
                with torch.inference_mode():
                    eager = runs[key][1](xa_t, xa_d, budget=SPEC_EQUAL_TOKENS, graph=False)
                    graphed = runs[key][1](xa_t, xa_d, budget=SPEC_EQUAL_TOKENS)
                for field in graphed._fields:
                    require(torch.equal(getattr(graphed, field), getattr(eager, field)),
                            f"[{label} {key}] graphed {field} differs from the eager rounds")
                print(f"  [{label} {key}] graphed rounds equal eager rounds in every field "
                      f"({SPEC_EQUAL_TOKENS}-token budget)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Through the engine: phase 6's greedy settings with the turbo draft.
    label, pcm, rate, opts = next(r for r in requests if r[0] == "12 s")
    relaxed = dict(quality_gate="off", logprob_threshold=-1e9, no_speech_threshold=1.0,
                   min_segment_avg_prob=0.0)
    settings = Settings(device="auto", compute_type="int4", enable_vad=True,
                        enable_diarization=True, language="auto", no_timestamps=False,
                        model_filename="ggml-large-v3.bin", parallel_requests=1, beam_size=1,
                        draft_model="large-v3-turbo", spec_gamma=SPEC_GAMMA, **relaxed)
    eng = SttEngine(settings, model_name="large-v3", params=model, random_init=True)
    require(eng.draft_cfg.n_text_layer == dcfg.n_text_layer, "engine: not the turbo draft")
    print(f"  [engine_spec] warmup(): {eng.warmup():.2f} s [{card}]")
    kernels.reset_launch_counts()
    m = PerformanceMetrics()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.transcribe_pcm16(pcm, rate, RequestOptions(beam_size=1, **opts), m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    paths["engine_spec"] = dict(kernels.LAUNCHES)
    stages = ", ".join(f"{k} {v:.1f}" for k, v in m.stages_ms.items())
    plain = sequential["engine_greedy"][2][label]
    print(f"  [engine_spec] {label}: wall {wall:.3f} s (phase 6's greedy engine: {plain:.3f} s), "
          f"{len(res)} segment(s), {sum(r.token_count for r in res)} tokens; speculative "
          f"{m.spec}; stages ms: {stages} [{card}]; launches {paths['engine_spec']}")
    require(bool(res) and m.spec.get("rounds", 0) > 0,
            "engine_spec: the request did not decode speculatively")
    need_launched(paths, "engine_spec", ("log_mel", "flash_attention", "decode_attention_i4",
                                         "beam_cross_attention"), absent=("beam_attention",))
    for st in eng.graphs.stats():
        print(f"  [engine_spec] graph class {st['key'][0]}: {st['graphs']} graph(s), captured in "
              f"{st['capture_s']:.2f} s, static buffers {st['static_bytes'] / 2**20:.1f} MiB, "
              f"pool grown by {st['pool_bytes'] / 2**20:.1f} MiB [{card}]")
    eng.shutdown()
    del eng, draft, graphs
    torch.cuda.empty_cache()


def training_batch(torch, np, cfg):
    """Phase 12's batch: two 30 s windows (their mel made by the returned
    function, K1), token ids from a seeded generator, the loss mask 0 on the
    prompt positions."""
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel, pad_or_trim

    rng = np.random.default_rng(SEED + 13)
    audio = torch.from_numpy(np.stack([pad_or_trim(speech_like(rng, 30.0))
                                       for _ in range(TRAIN_B)])).cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 13)
    tokens = torch.randint(0, cfg.n_vocab, (TRAIN_B, TRAIN_T), generator=g, device="cuda")
    mask = torch.ones((TRAIN_B, TRAIN_T - 1), device="cuda")
    mask[:, :TRAIN_PROMPT] = 0.0
    return (lambda: compute_log_mel(audio, n_mels=cfg.n_mels, dtype=cfg.dtype)), tokens, mask


def grad_errors(torch, got: dict, want: dict, blocks=None) -> dict:
    """Per parameter max |got - want| / max |want| (``want`` cut to each
    name's block by ``blocks``); fails where a gradient is all-zero or
    non-finite on one side only."""
    rels = {}
    for name, g in got.items():
        w = want[name] if blocks is None else blocks[name].local(want[name])
        a, b = g.float(), w.float()
        flags = torch.stack([torch.isfinite(a).all(), torch.isfinite(b).all(),
                             (a == 0).all(), (b == 0).all()]).tolist()
        require(flags[0] == flags[1] and flags[2] == flags[3],
                f"gradient of {name}: finite {flags[:2]}, all-zero {flags[2:]}")
        rels[name] = (a - b).abs().max() / b.abs().max().clamp(min=1e-30)
    return dict(zip(rels, torch.stack(list(rels.values())).tolist()))


def worst_by_group(rels: dict) -> dict:
    """The largest of ``rels`` (a ``grad_errors`` result) and its parameter,
    for the encoder's attention q/k/v leaves ("attention": FlashAttention's
    backward gives their gradients) and for the rest ("rest")."""
    groups = {"attention": [n for n in rels if ATTN_LEAF.fullmatch(n)]}
    groups["rest"] = [n for n in rels if n not in set(groups["attention"])]
    return {k: max((rels[n], n) for n in names) for k, names in groups.items()}


def attention_variants(torch):
    """The two stand-ins for ``whisper.FlashAttention`` in phase 12 (a): the
    plain path (``attention_reference`` under autograd), and a planted fault
    (K2 forward, a backward without its rowsum term: ds = p * dp)."""
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import (
        attention_reference,
        flash_attention,
    )

    class Plain:
        apply = staticmethod(attention_reference)

    class NoRowsum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v)

        @staticmethod
        def backward(ctx, grad_out):
            q, k, v = (t.float() for t in ctx.saved_tensors)
            g = grad_out.float()
            p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
            ds = p * (g @ v.transpose(-1, -2))
            return tuple(t.to(grad_out.dtype) for t in (
                ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ g))

    return Plain, NoRowsum


def k2_gradient_check(torch, cfg, model, mel, tokens, mask, fault: bool):
    """K2's gradient (``FlashAttention``) against the plain path's on
    ``model``: returns (``worst_by_group`` of K2's, of the planted fault's
    with ``fault`` else None, K2's forward launches, the two losses, every
    ``grad_errors`` of K2's)."""
    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.models import whisper as whisper_mod
    from sentiric_stt_whisper_service_tpu_torch.runtime import training

    plain, no_rowsum = attention_variants(torch)
    flash = whisper_mod.FlashAttention

    def grads_with(attention):
        whisper_mod.FlashAttention = attention
        try:
            return training.loss_and_grads(cfg, model, mel, tokens, mask)
        finally:
            whisper_mod.FlashAttention = flash

    loss_plain, grads_plain = grads_with(plain)
    kernels.reset_launch_counts()
    loss_k2, grads = grads_with(flash)
    k2_forward = kernels.LAUNCHES["flash_attention"]
    qkv = [f"encoder.blocks.{i}.attn.{w}.w" for i in range(cfg.n_audio_layer) for w in "qkv"]
    zero = [n for n in qkv if not bool(grads[n].abs().max() > 0)]
    require(not zero, f"K2 gradient: encoder attention weights without a gradient: {zero}")
    rels = grad_errors(torch, grads, grads_plain)
    del grads
    faulty = None
    if fault:
        faulty = worst_by_group(grad_errors(torch, grads_with(no_rowsum)[1], grads_plain))
    model.zero_grad(set_to_none=True)
    return worst_by_group(rels), faulty, k2_forward, (float(loss_k2), float(loss_plain)), rels


def training_phase(torch, np, paths, card) -> None:
    """Phase 12: training and the mesh (see the module docstring)."""
    import dataclasses
    import os
    import socket
    import tempfile

    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.models import config_for, init_params
    from sentiric_stt_whisper_service_tpu_torch.runtime import training

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()  # the earlier phases' models and graphs
    cfg = config_for("large-v3")
    g = torch.Generator(device="cuda")
    make_mel, tokens, mask = training_batch(torch, np, cfg)
    mel = make_mel()

    # K2's gradient path against the plain path's, before any step, on the
    # weights of TRAIN_GRAD_SEEDS seeds; the planted fault on the first.
    for i in range(TRAIN_GRAD_SEEDS):
        g.manual_seed(SEED + i)
        model = training.training_copy(init_params(cfg, g))
        worst, faulty, k2_forward, losses, rels = k2_gradient_check(
            torch, cfg, model, mel, tokens, mask, fault=i == 0)
        if i == 0:  # the main path trains the first seed's weights
            trained, n_params = model, sum(p.numel() for p in model.parameters())
            print(f"  (a) {n_params / 1e9:.3f} B parameters, bf16; mel {list(mel.shape)}, "
                  f"tokens {list(tokens.shape)}, {int(mask.sum())} target tokens")
        print(f"  (a) seed {SEED + i}: K2 gradient vs the plain path's, max |dg| / max |g| "
              f"over {len(rels)} parameters: median {statistics.median(rels.values()):.2e}; "
              f"encoder attention q/k/v largest {worst['attention'][0]:.3e} "
              f"({worst['attention'][1]}, bound {TRAIN_GRAD_TOL_ATTN}), the rest largest "
              f"{worst['rest'][0]:.3e} ({worst['rest'][1]}, bound {TRAIN_GRAD_TOL}); loss "
              f"{losses[0]:.5f} vs {losses[1]:.5f}; K2 launched {k2_forward} times in the "
              f"forward pass")
        require(worst["attention"][0] <= TRAIN_GRAD_TOL_ATTN,
                f"K2 gradient, seed {SEED + i}: {worst['attention'][1]} off by "
                f"{worst['attention'][0]:.3g} of its largest |g|")
        require(worst["rest"][0] <= TRAIN_GRAD_TOL,
                f"K2 gradient, seed {SEED + i}: {worst['rest'][1]} off by "
                f"{worst['rest'][0]:.3g} of its largest |g|")
        require(k2_forward == cfg.n_audio_layer,
                f"K2 launched {k2_forward} times in a training forward pass, not "
                f"{cfg.n_audio_layer}")
        if faulty is not None:
            print(f"  (a) seed {SEED + i}, the planted fault (K2's backward without its rowsum "
                  f"term): encoder attention q/k/v largest {faulty['attention'][0]:.3e} "
                  f"({faulty['attention'][1]}), the rest largest {faulty['rest'][0]:.3e} "
                  f"({faulty['rest'][1]})")
            require(faulty["attention"][0] > TRAIN_GRAD_TOL_ATTN,
                    f"the planted fault passes the K2 gradient check: "
                    f"{faulty['attention'][0]:.3g} <= {TRAIN_GRAD_TOL_ATTN}")
    model = trained
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # The main path: the mel (K1) and five AdamW steps.
    opt = training.make_optimizer(model, TRAIN_LR)
    state = training.TrainState(model, opt.state, 0)
    kernels.reset_launch_counts()
    mel = make_mel()
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = training.train_step(cfg, opt, state, mel, tokens, mask)
        losses.append(float(loss))
        walls.append(time.perf_counter() - t)
    paths["training"] = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    moments = sum(v.numel() * v.element_size() for st in state.opt_state.values()
                  for v in st.values() if torch.is_tensor(v) and v.dim())
    wall = statistics.median(walls[2:])
    targets = int(mask.sum())
    print(f"  (a) losses {', '.join(f'{x:.5f}' for x in losses)} at lr {TRAIN_LR}; step walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s [{card}]")
    print(f"  (a) step wall {wall:.4f} s (median of steps 3-5): {targets / wall:.1f} target "
          f"tokens/s, {TRAIN_B * 30.0 / wall:.1f} audio-s/s; peak device memory "
          f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB the earlier phases hold; AdamW state "
          f"{moments / 2**30:.2f} GiB, weights "
          f"{n_params * 2 / 2**30:.2f} GiB [{card}]; launches {paths['training']}")
    require(all(math.isfinite(x) for x in losses), f"training: a loss is not finite: {losses}")
    require(losses[-1] < losses[0], f"training: the loss did not fall: {losses}")
    need_launched(paths, "training", ("log_mel", "flash_attention"),
                  absent=("decode_attention", "decode_attention_i4", "beam_attention",
                          "beam_cross_attention", "flash_q8"))
    require(paths["training"]["flash_attention"] == TRAIN_STEPS * cfg.n_audio_layer,
            f"training: K2 launched {paths['training']['flash_attention']} times, not "
            f"{cfg.n_audio_layer} a step")
    training_breakdown(torch, cfg, opt, state, mel, tokens, mask, card)
    del state, model, opt, mel, trained
    torch.cuda.empty_cache()

    # (b) tp = 2 on the one card: two processes over gloo against this one.
    cfg_r = dataclasses.replace(cfg, n_audio_layer=TP_LAYERS, n_text_layer=TP_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        g.manual_seed(SEED + 14)
        full = training.training_copy(init_params(cfg_r, g))
        mel = make_mel()
        loss, grads = training.loss_and_grads(cfg_r, full, mel, tokens, mask)
        with torch.inference_mode():
            logits, decodes = tp_forward(torch, cfg_r, full, mel, tokens)
        torch.save({"mel": mel, "tokens": tokens, "mask": mask, "loss": loss,
                    "rows": {form: d["rows"] for form, d in decodes.items()},
                    "grads": {n: t.detach().cpu() for n, t in grads.items()}}, tmp / "ref.pt")
        del full, grads
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-worker",
                                   str(rank), str(port), str(tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=dict(os.environ, OMP_NUM_THREADS="4"))
                 for rank in range(2)]
        try:
            logs = [p.communicate(timeout=400)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            require(p.returncode == 0, f"tp worker {rank} exited {p.returncode}:\n{log[-4000:]}")
        outs = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    print(f"  (b) two tp ranks (gloo, one card): {time.perf_counter() - t0:.1f} s, process "
          f"start included")
    for rank, out in enumerate(outs):
        rel = abs(out["loss"] - float(loss)) / abs(float(loss))
        worst = max(out["grad_rels"], key=out["grad_rels"].get)
        print(f"  (b) rank {rank}: {out['heads']} heads; loss {out['loss']:.5f} vs unsharded "
              f"{float(loss):.5f} (rel {rel:.2e}, bound {TP_LOSS_RTOL}); gradient shards: max "
              f"|dg| / max |g| median {statistics.median(out['grad_rels'].values()):.2e}, "
              f"largest {out['grad_rels'][worst]:.2e} ({worst}, bound {TP_GRAD_TOL}); "
              f"loss_and_grads {out['step_s']:.3f} s [{card}]")
        require(rel <= TP_LOSS_RTOL, f"tp rank {rank}: loss off by {rel:.3g}")
        require(out["grad_rels"][worst] <= TP_GRAD_TOL,
                f"tp rank {rank}: gradient of {worst} off by {out['grad_rels'][worst]:.3g}")
        drift_check(f"(b) rank {rank} teacher-forced logits vs unsharded", logits,
                    out["logits"].to(logits.device), torch)
        for name, (err, tol, shape) in out["kernel_checks"].items():
            print(f"  (b) rank {rank} {name} at the rank's shapes {shape} (its last call in "
                  f"the decode): max_abs_err {err:.3e} against its plain version (tol "
                  f"{tol:.2e}: 2 bf16 steps at max |plain|, as phase 3)")
            require(err <= tol, f"tp rank {rank}: {name} max_abs_err {err:.3e} > tol {tol:.2e}")
        for form, ref in decodes.items():
            tp_decode_check(torch, rank, form, ref, out, card)
    paths["training_tp"] = outs[0]["launches"]
    print(f"  (b) launches (rank 0) {paths['training_tp']}")
    need_launched(paths, "training_tp", ("flash_attention", "decode_attention",
                                         "decode_attention_i4"))
    print(f"  phase 12 wall {time.perf_counter() - t_phase:.1f} s [{card}]")


def tp_decode_check(torch, rank, form, ref, out, card) -> None:
    """A tp rank's greedy decode against the unsharded one (``ref``): equal,
    or in each window that differs the unsharded logits' top-two margin at
    the first differing token within twice the largest difference of the
    two models' teacher-forced logits over the unsharded decode (``drift``):
    a flip that the models' difference explains."""
    got, want = out[f"tokens_{form}"], ref["tokens"]
    forced = out[f"forced_{form}"]
    require(bool(torch.isfinite(forced).all()), f"tp rank {rank}: {form} logits not finite")
    drift = (forced - ref["forced"]).abs().max().item()
    same = int((got == want).all(0).long().cumprod(0).sum())
    print(f"  (b) rank {rank} greedy, {form} slab: the first {same} of {TP_TOKENS} tokens "
          f"equal the unsharded decode's in every window; teacher-forced drift {drift:.4f}; "
          f"{out[f'decode_{form}_s']:.3f} s (unsharded {ref['s']:.3f} s) [{card}]")
    for b in range(got.shape[0]):
        differ = (got[b] != want[b]).nonzero()
        if not differ.numel():
            continue
        j = int(differ[0, 0])
        margin = ref["margins"][b, j].item()
        print(f"  (b) rank {rank} greedy, {form} slab, window {b}: differs from token {j}, "
              f"where the unsharded top-two margin is {margin:.4f} (bound twice the drift, "
              f"{2 * drift:.4f})")
        require(margin <= 2 * drift,
                f"tp rank {rank}: the {form} decode of window {b} differs at token {j} with a "
                f"margin {margin:.4f} above twice the drift {drift:.4f}")


def training_breakdown(torch, cfg, opt, state, mel, tokens, mask, card) -> None:
    """Where a training step's time goes (after the main path's counts are
    read): one step timed in its parts (forward, backward, AdamW; the host
    clock with a synchronise after each), then one under ``torch.profiler``:
    device busy against the wall (the idle share) and the kernels that take
    most of it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from sentiric_stt_whisper_service_tpu_torch.runtime import training

    model = state.params
    marks = [time.perf_counter()]
    loss = training.loss_fn(cfg, model, mel, tokens, mask)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    loss.backward()
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    opt.step()
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    parts = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    print(f"  (a) one step in parts: forward {parts[0]:.1f} ms, backward {parts[1]:.1f} ms, "
          f"AdamW {parts[2]:.1f} ms [{card}]")
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        training.train_step(cfg, opt, state, mel, tokens, mask)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t_us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t_us + e.time_range.elapsed_us(), count + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    print(f"  (a) one step under the profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"in {sum(c for _, c in by_name.values())} kernels, idle {100 * (1 - busy / wall):.1f} % "
          f"[{card}]; the top kernels:")
    for name, (t_us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {t_us / 1e3:8.2f} ms {count:6d}x  {name[:100]}")


def tp_forward(torch, cfg, model, mel, tokens, rows=None):
    """Inference of phase 12 (b)'s model, sharded or not: the teacher-forced
    logits of the training tokens (plain attention, a fresh cache), and for
    an int4 slab (K4) and an int8 slab (K3) a greedy window's decode: its
    sampled tokens, token rows and time, the teacher-forced logits that pick
    the sampled positions of ``rows[form]`` (default: its own rows) and
    their processed top-two margins."""
    from sentiric_stt_whisper_service_tpu_torch.models import (
        TokenIds,
        build_suppress_mask,
        decode_window,
    )
    from sentiric_stt_whisper_service_tpu_torch.models.sampling import logit_processor
    from sentiric_stt_whisper_service_tpu_torch.models.whisper import (
        decoder_apply,
        encoder_apply,
        init_kv_cache,
        precompute_xa_kv,
        text_heads,
    )
    from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

    dev = mel.device
    heads = text_heads(cfg, model)
    xa = encoder_apply(cfg, model, mel)
    kv = init_kv_cache(cfg, TRAIN_B, TRAIN_T, device=dev, n_head=heads)
    logits, _ = decoder_apply(cfg, model, tokens, 0, kv, precompute_xa_kv(cfg, model, xa))
    tok = fallback_tokenizer(cfg.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sup = torch.from_numpy(build_suppress_mask(cfg.n_vocab, ids, tok.non_speech_tokens)).to(dev)
    process = logit_processor(cfg.n_vocab, ids, sup, True)
    sot = tok.sot_sequence("en")
    sb = len(sot)
    tinit = torch.full((TRAIN_B, cfg.n_text_ctx), ids.eot, dtype=torch.int64, device=dev)
    tinit[:, :sb] = torch.tensor(sot, device=dev)
    decodes = {}
    for form, bits in (("int4", 4), ("int8", 8)):
        slab = precompute_xa_kv(cfg, model, xa, bits)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = decode_window(cfg, model, slab, tinit, sb, 0, ids, sup, max_len=sb + TP_TOKENS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        forced_on = res.tokens if rows is None else rows[form].to(dev)
        kv = init_kv_cache(cfg, TRAIN_B, sb + TP_TOKENS, device=dev, n_head=heads)
        forced, _ = decoder_apply(cfg, model, forced_on[:, :sb + TP_TOKENS - 1], 0, kv, slab)
        forced = forced[:, sb - 1:].float()
        margins = torch.stack([
            process(forced[:, j], forced_on, torch.tensor([sb + j], device=dev),
                    torch.tensor([sb], device=dev)).topk(2).values.diff(dim=-1)[:, 0].neg()
            for j in range(TP_TOKENS)], dim=1)
        decodes[form] = {"tokens": res.tokens[:, sb:sb + TP_TOKENS].cpu(), "rows": res.tokens,
                         "s": seconds, "forced": forced.cpu(), "margins": margins.cpu()}
    return logits.float(), decodes


def tp_worker(torch, rank: int, port: int, tmp: Path) -> int:
    """``--tp-worker``: one rank of phase 12 (b) (see ``training_phase``).
    Besides the phase's readings, K3 and K4 against their plain versions on
    their last call's inputs in this rank's decodes (its heads and rows)."""
    import dataclasses

    import torch.distributed as dist

    from sentiric_stt_whisper_service_tpu_torch import kernels, parallel
    from sentiric_stt_whisper_service_tpu_torch.models import config_for, init_params
    from sentiric_stt_whisper_service_tpu_torch.models import whisper as whisper_mod
    from sentiric_stt_whisper_service_tpu_torch.models.whisper import text_heads
    from sentiric_stt_whisper_service_tpu_torch.ops import decode_attention as da
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import unpack_nibbles_i8
    from sentiric_stt_whisper_service_tpu_torch.runtime import training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(tmp / "ref.pt")
    parallel.initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = parallel.make_mesh("1x2")
    cfg = dataclasses.replace(config_for("large-v3"), n_audio_layer=TP_LAYERS,
                              n_text_layer=TP_LAYERS)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 14)
    full = training.training_copy(init_params(cfg, g))
    blocks = parallel.param_shardings(mesh, full)
    model = parallel.shard_params(mesh, full)
    del full
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, grads = training.loss_and_grads(cfg, model, ref["mel"], ref["tokens"], ref["mask"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    rels = grad_errors(torch, grads, ref["grads"], blocks)

    last = {}  # kernel -> its last call's (q, slabs), q copied

    def keep(name, fn):
        def call(q, *slabs, **kw):
            last[name] = (q.clone(), slabs, kw)
            return fn(q, *slabs, **kw)
        return call

    k3, k4 = whisper_mod.decode_attention, whisper_mod.decode_attention_i4
    whisper_mod.decode_attention = keep("K3 decode_attention int8", k3)
    whisper_mod.decode_attention_i4 = keep("K4 decode_attention_i4", k4)
    try:
        with torch.inference_mode():
            logits, decodes = tp_forward(torch, cfg, model, ref["mel"], ref["tokens"], ref["rows"])
    finally:
        whisper_mod.decode_attention, whisper_mod.decode_attention_i4 = k3, k4
    launches = dict(kernels.LAUNCHES)
    checks = {}
    for name, (q, slabs, kw) in last.items():
        if name.startswith("K4"):
            got = k4(q, *slabs, **kw)
            k, v, ks, vs = slabs
            slabs = (unpack_nibbles_i8(k), unpack_nibbles_i8(v), ks, vs)
        else:
            got = k3(q, *slabs, **kw)
        want = da.decode_attention_reference(q, *slabs, **kw)
        err = (got.float() - want.float()).abs().max().item()
        checks[name] = (err, 2**-6 * want.float().abs().max().item(), tuple(q.shape))
    out = {"loss": float(loss), "grad_rels": rels, "logits": logits.cpu(),
           "heads": text_heads(cfg, model), "step_s": step_s, "launches": launches,
           "kernel_checks": checks}
    for form, d in decodes.items():
        out.update({f"tokens_{form}": d["tokens"], f"decode_{form}_s": d["s"],
                    f"forced_{form}": d["forced"]})
    torch.save(out, tmp / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


MESH_TOKENS = 32  # phase 13: RequestOptions.max_decode_tokens of every request
# Phase 13: the alignment pass's scores on a mesh against the unsharded ones
# are held to ALIGN_SLACK x the scores' own rounding sensitivity: how far they
# move when every element of the encoder output moves by one ulp. On random
# weights the cross-attention is nearly flat over the frames, so the z-scored
# scores move by O(1) under any rounding change;
# token times, the DTW path through them, move far, and are printed.
ALIGN_SLACK = 2.0
MESH_SHAPES = (("engine_tp", "1x2"), ("engine_sp", "1x1x2"))  # phase 13 (a), (b)
# Phase 13's requests on a 12 s clip: greedy on the lone path (language
# pinned, so the raw window decodes on the engine's own class), two at once
# with the language detected (each window's cross K/V from the detection's
# encode, through the batcher's pool), and beam 5 through the gang; (b)
# runs the lone request only.
MESH_REQUESTS = (("lone", dict(language="en", beam_size=1), 1),
                 ("pair", dict(language="auto", beam_size=1), 2),
                 ("beam", dict(language="en", beam_size=BEAM), 1))
# Phase 13 (c): the engine with phase 11's random large-v3-turbo draft
# (seed SEED + 12, gamma SPEC_GAMMA) on each mesh, the draft sharded like
# the target: the 12 s clip greedy alone, which takes the speculative route.
MESH_SPEC_REQUESTS = (("spec", dict(language="en", beam_size=1), 1),)


def mesh_settings(shape: str):
    """Phase 13's engine settings: phase 6's (int4 compute, VAD,
    diarization, token timestamps, relaxed gates) at two requests at a
    time, on the mesh ``shape``."""
    from sentiric_stt_whisper_service_tpu_torch.config import Settings

    return Settings(device="auto", compute_type="int4", enable_vad=True,
                    enable_diarization=True, language="auto", no_timestamps=False,
                    model_filename="ggml-large-v3.bin", parallel_requests=2, max_batch_size=2,
                    mesh_shape=shape, quality_gate="off", logprob_threshold=-1e9,
                    no_speech_threshold=1.0, min_segment_avg_prob=0.0)


def mesh_spec_settings(shape: str):
    """``mesh_settings`` with the large-v3-turbo draft at gamma SPEC_GAMMA."""
    import dataclasses

    return dataclasses.replace(mesh_settings(shape), draft_model="large-v3-turbo",
                               spec_gamma=SPEC_GAMMA)


def turbo_draft(torch):
    """Phase 11's random large-v3-turbo draft (seed SEED + 12) on the card,
    int8 weights, q/k/v unfused (an engine fuses or shards it)."""
    from sentiric_stt_whisper_service_tpu_torch.models import config_for, init_params
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import quantize_params

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 12)
    with torch.inference_mode():
        return quantize_params(init_params(config_for("large-v3-turbo"), g))


def mesh_requests(torch, engine, pcm, requests) -> dict:
    """``requests`` through ``engine.transcribe_pcm16`` (each label's
    requests at once, from threads): per label its walls, stage splits,
    speculative counts (``PerformanceMetrics.spec``), segments, each
    decode's (sample_begin, sampled row, average log-probability),
    recorded at ``_decode_one``, and each alignment pass's scores (the
    DTW's input), recorded at ``times_of_scores``."""
    import threading

    from sentiric_stt_whisper_service_tpu_torch.runtime import engine as eng_mod

    local = threading.local()
    decodes, scores = {}, {}
    decode_one, times_of_scores = engine._decode_one, eng_mod.times_of_scores

    def scored(window_scores, *a, **kw):
        scores.setdefault(local.label, []).append(window_scores.copy())
        return times_of_scores(window_scores, *a, **kw)

    def recording(xa_kv, init_tokens, sample_begin, *a, **kw):
        res = decode_one(xa_kv, init_tokens, sample_begin, *a, **kw)
        if res is not None:
            n = int(res.lengths[0])
            decodes.setdefault(local.label, []).append(
                (sample_begin, res.tokens[0][:n].copy(), float(res.avg_logprobs[0])))
        return res

    from sentiric_stt_whisper_service_tpu_torch.runtime import PerformanceMetrics, RequestOptions

    engine._decode_one = recording
    eng_mod.times_of_scores = scored
    out = {}
    try:
        for label, opts, n in requests:
            results = [None] * n

            def go(i, label=label, opts=opts):
                local.label = label
                m = PerformanceMetrics()
                t = time.perf_counter()
                res = engine.transcribe_pcm16(pcm, 16000, RequestOptions(
                    max_decode_tokens=MESH_TOKENS, **opts), m)
                torch.cuda.synchronize()
                results[i] = (time.perf_counter() - t, m.stages_ms, [
                    (r.text, r.t0, r.t1, r.language, [(k.text, k.t0, k.t1) for k in r.tokens])
                    for r in res], m.spec)

            threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            require(all(r is not None for r in results), f"phase 13 {label}: a request failed")
            out[label] = {"walls": [r[0] for r in results], "stages": [r[1] for r in results],
                          "segments": [r[2] for r in results], "spec": [r[3] for r in results],
                          "decodes": decodes.get(label, []), "scores": scores.get(label, [])}
    finally:
        del engine._decode_one
        eng_mod.times_of_scores = times_of_scores
    return out


def encoded_window(torch, cfg, model, pcm):
    """The encoder output [1, 1500, d] of the 12 s clip's window."""
    import numpy as np

    from sentiric_stt_whisper_service_tpu_torch.models.whisper import encoder_apply
    from sentiric_stt_whisper_service_tpu_torch.ops import N_SAMPLES, compute_log_mel

    window = np.zeros(N_SAMPLES, np.float32)
    x = np.asarray(pcm, np.int16).astype(np.float32)[:N_SAMPLES] / 32768.0
    window[: x.shape[0]] = x
    dev = model.decoder.pos_emb.device
    with torch.inference_mode():
        mel = compute_log_mel(torch.from_numpy(window[None]).to(dev), n_mels=cfg.n_mels,
                              dtype=cfg.dtype)
        return encoder_apply(cfg, model, mel)


def align_sensitivity(torch, cfg, model, pcm, rows, eot) -> list:
    """Per sampled row, max |diff| of the window's alignment scores (the
    engine's pass over the row without its EOT) when every element of the
    encoder output moves by one ulp (its lowest mantissa bit flipped): the
    scores' own rounding sensitivity."""
    import numpy as np

    from sentiric_stt_whisper_service_tpu_torch.models.timestamps import window_scores
    from sentiric_stt_whisper_service_tpu_torch.models.whisper import precompute_xa_kv

    enc = encoded_window(torch, cfg, model, pcm).contiguous()
    bits = {2: torch.int16, 4: torch.int32}[enc.element_size()]
    flipped = (enc.view(bits) ^ 1).view(enc.dtype)
    with torch.inference_mode():
        slabs = [precompute_xa_kv(cfg, model, x, 4) for x in (enc, flipped)]
        out = []
        for row in rows:
            toks = np.asarray(row, np.int64)
            toks = toks[toks != eot]
            a, b = (window_scores(cfg, model, slab, toks) for slab in slabs)
            out.append(float(np.abs(a - b).max()))
    return out


def forced_logits(torch, cfg, model, pcm, rows) -> list:
    """The teacher-forced logits [n - 1, V] of each sampled row over the
    12 s window's int4 cross K/V (the slab of every phase 13 path; the
    pool's int8 container holds the same values), with plain attention:
    the yardstick for a divergence (phase 12 (b)'s drift)."""
    from sentiric_stt_whisper_service_tpu_torch.models.whisper import (
        decoder_apply,
        init_kv_cache,
        precompute_xa_kv,
        text_heads,
    )

    import numpy as np

    dev = model.decoder.pos_emb.device
    enc = encoded_window(torch, cfg, model, pcm)
    with torch.inference_mode():
        slab = precompute_xa_kv(cfg, model, enc, 4)
        out = []
        for row in rows:
            t = torch.from_numpy(np.asarray(row, np.int64)[None, :-1]).to(dev)
            kv = init_kv_cache(cfg, 1, t.shape[1], device=dev, n_head=text_heads(cfg, model))
            logits, _ = decoder_apply(cfg, model, t, 0, kv, slab)
            out.append(logits[0].float().cpu())
    return out


def mesh_decode_check(torch, shape, label, yard, mesh, yard_forced, mesh_forced, margins_of):
    """A mesh engine's decodes of one request against the yardstick's:
    equal rows, or where one differs, for greedy the unsharded top-two
    margin at its first differing token within twice the drift (the largest
    difference of the two models' teacher-forced logits over the yardstick's
    sampled positions: phase 12 (b)'s rule), for beam 5 (which ranks whole
    hypotheses) the two chosen hypotheses' average log-probabilities within
    four times the drift (each position's log-probability moves by at most
    twice the drift). Returns (equal decodes, decodes)."""
    sb, y_row, y_avg = yard
    drift = (mesh_forced - yard_forced)[sb - 1:].abs().max().item()
    equal = 0
    for i, (sb_m, m_row, m_avg) in enumerate(mesh):
        require(sb_m == sb, f"{shape} {label}: sample_begin {sb_m} != {sb}")
        if len(m_row) == len(y_row) and (m_row == y_row).all():
            equal += 1
            continue
        n = min(len(m_row), len(y_row))
        j = next((p for p in range(sb, n) if m_row[p] != y_row[p]), n)
        if label == "beam":
            gap = abs(m_avg - y_avg)
            print(f"  {shape} {label}: the chosen hypothesis differs from token {j - sb}; "
                  f"average log-probabilities {m_avg:.5f} vs {y_avg:.5f} (gap {gap:.5f}, bound "
                  f"4 x drift {4 * drift:.5f})")
            require(gap <= 4 * drift, f"{shape} {label}: the beam's choice differs at an average "
                                      f"log-probability gap {gap:.5f} > 4 x drift {4 * drift:.5f}")
            continue
        margin = margins_of(j - sb)
        print(f"  {shape} {label} decode {i}: differs from token {j - sb}, where the unsharded "
              f"top-two margin is {margin:.4f} (bound twice the drift, {2 * drift:.4f})")
        require(margin <= 2 * drift,
                f"{shape} {label}: decode {i} differs at token {j - sb} with a margin "
                f"{margin:.4f} above twice the drift {drift:.4f}")
    return equal, len(mesh), drift


def mesh_phase(torch, np, model, paths, card) -> None:
    """Phase 13: the engine over a mesh on the one card (see the module
    docstring)."""
    import os
    import socket
    import tempfile

    from sentiric_stt_whisper_service_tpu_torch.models import TokenIds, build_suppress_mask
    from sentiric_stt_whisper_service_tpu_torch.models.sampling import logit_processor
    from sentiric_stt_whisper_service_tpu_torch.runtime import SttEngine
    from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    pcm = (voiced_like(rng, 12.0) * 32767).astype(np.int16)
    yard_engine = SttEngine(mesh_settings("1"), model_name="large-v3", params=model)
    cfg = yard_engine.cfg
    mesh_requests(torch, yard_engine, pcm, MESH_REQUESTS)  # its classes captured first
    yard = mesh_requests(torch, yard_engine, pcm, MESH_REQUESTS)
    yard_engine.shutdown()
    del yard_engine
    # (c)'s yardstick: the unsharded engine with the draft.
    yard_engine = SttEngine(mesh_spec_settings("1"), model_name="large-v3", params=model,
                            draft_params=turbo_draft(torch))
    mesh_requests(torch, yard_engine, pcm, MESH_SPEC_REQUESTS)  # its class captured first
    yard.update(mesh_requests(torch, yard_engine, pcm, MESH_SPEC_REQUESTS))
    yard_engine.shutdown()
    del yard_engine
    torch.cuda.empty_cache()
    rows = {label: yard[label]["decodes"][0][1]
            for label, _, _ in MESH_REQUESTS + MESH_SPEC_REQUESTS}
    yard_forced = dict(zip(rows, forced_logits(torch, cfg, model, pcm, list(rows.values()))))
    tok = fallback_tokenizer(cfg.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sensitivity = dict(zip(rows, align_sensitivity(torch, cfg, model, pcm,
                                                   list(rows.values()), ids.eot)))
    sup = torch.from_numpy(build_suppress_mask(cfg.n_vocab, ids, tok.non_speech_tokens))
    process = logit_processor(cfg.n_vocab, ids, sup, True)

    def margins(label):
        sb, row = yard[label]["decodes"][0][:2]
        forced = yard_forced[label][sb - 1:]
        tokens = torch.from_numpy(np.asarray(row, np.int64))[None]

        def margin_at(j):
            top = process(forced[j][None], tokens, torch.tensor([sb + j]),
                          torch.tensor([sb])).topk(2).values[0]
            return (top[0] - top[1]).item()

        return margin_at

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save({"pcm": pcm, "rows": rows}, tmp / "ref.pt")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--mesh-worker", str(rank), str(port), str(tmp)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=dict(os.environ, OMP_NUM_THREADS="4"))
                 for rank in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            require(p.returncode == 0, f"mesh worker {rank} exited {p.returncode}:\n{log[-4000:]}")
        outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    print(f"  two ranks (gloo, one card), both meshes: {time.perf_counter() - t0:.1f} s, "
          f"process start, engine builds and the kernel checks included [{card}]")
    for path, shape in MESH_SHAPES:
        labels = [lb for lb, _, _ in MESH_REQUESTS] if path == "engine_tp" else ["lone"]
        got = outs[0][path]
        for label in labels:
            y, m = yard[label], got["requests"][label]
            equal, total, drift = mesh_decode_check(
                torch, shape, label, y["decodes"][0], m["decodes"], yard_forced[label],
                got["forced"][label], margins(label))
            same_segments = all(segs == y["segments"][0] for segs in m["segments"])
            print(f"  [{path}] {label}: wall {', '.join(f'{w:.3f}' for w in m['walls'])} s "
                  f"(unsharded {', '.join(f'{w:.3f}' for w in y['walls'])} s); {equal} of "
                  f"{total} decodes equal the unsharded one's ({MESH_TOKENS}-token cap), "
                  f"teacher-forced drift {drift:.4f}; segments "
                  f"{'equal' if same_segments else 'differ'}; stages ms "
                  f"{', '.join(f'{k} {v:.1f}' for k, v in m['stages'][0].items())} [{card}]")
            if equal == total:  # then the segments too, and the alignment scores
                want, bound_ = y["segments"][0], ALIGN_SLACK * sensitivity[label]
                for segs, sc in zip(m["segments"], m["scores"]):
                    require([s_[:4] + ([k[0] for k in s_[4]],) for s_ in segs]
                            == [s_[:4] + ([k[0] for k in s_[4]],) for s_ in want],
                            f"{shape} {label}: equal decodes, other segments")
                    moved = max((max(abs(a[1] - b[1]), abs(a[2] - b[2]))
                                 for mine_, theirs_ in zip(segs, want)
                                 for a, b in zip(mine_[4], theirs_[4])), default=0)
                    gap = float(np.abs(sc - y["scores"][0]).max())
                    print(f"  {shape} {label}: alignment scores within {gap:.4f} of the "
                          f"unsharded ones; one ulp of the encoder output moves those by "
                          f"{sensitivity[label]:.4f} (bound {ALIGN_SLACK:g} x that, "
                          f"{bound_:.4f}); token times moved by up to {moved} cs [{card}]")
                    require(gap <= bound_, f"{shape} {label}: alignment scores off by "
                                           f"{gap:.4f} > {bound_:.4f}")
        for rank, out in enumerate(outs):
            mine = out[path]
            print(f"  [{path}] rank {rank}: {mine['heads']} decoder heads; peak device memory "
                  f"{mine['peak'] / 2**30:.2f} GiB (this process); launches {mine['launches']}")
            for name, (err, tol, shp) in mine["kernel_checks"].items():
                print(f"  [{path}] rank {rank} {name} at the rank's shapes q {shp[0]}, "
                      f"{shp[1]} (its last call): max_abs_err {err:.3e} against its plain "
                      f"version (tol {tol:.2e}, as phase 3)")
                require(err <= tol, f"{path} rank {rank}: {name} max_abs_err {err:.3e} > "
                                    f"tol {tol:.2e}")
        paths[path] = got["launches"]
        names = ("log_mel", "flash_attention", "decode_attention_i4") + (
            ("decode_attention", "beam_attention", "beam_cross_attention")
            if path == "engine_tp" else ())
        need_launched(paths, path, names)
        for rank, out in enumerate(outs):
            for name in names:
                require(out[path]["launches"][name] > 0, f"{path} rank {rank}: {name} was not "
                                                         "launched")
        ch = got["channel"]
        print(f"  [{path}] rank 0's replay channel on the lone request: {ch['decisions']} "
              f"decisions in {ch['decision_s'] * 1e3:.1f} ms, "
              f"{ch['decision_s'] * 1e3 / max(1, ch['steps']):.3f} ms a step of "
              f"{ch['decode_ms'] / max(1, ch['steps']):.1f} ms "
              f"({100 * ch['decision_s'] * 1e3 / max(ch['decode_ms'], 1e-9):.2f} % of the "
              f"decode); {ch['ops']} op messages in {ch['op_s'] * 1e3:.1f} ms (each waits for "
              f"rank 1 to finish the op before; both ranks' kernels share the one card) "
              f"[{card}]")
    for path, shape in MESH_SHAPES:  # (c): the engine with the draft
        spath = f"{path}_spec"
        got, y = outs[0][spath], yard["spec"]
        m = got["requests"]["spec"]
        equal, total, drift = mesh_decode_check(
            torch, shape, "spec", y["decodes"][0], m["decodes"], yard_forced["spec"],
            got["forced"]["spec"], margins("spec"))
        spec, ch = m["spec"][0], got["channel"]
        require(spec.get("rounds", 0) > 0, f"{spath}: the request did not decode speculatively")
        print(f"  [{spath}] the 12 s clip with the large-v3-turbo draft, gamma {SPEC_GAMMA}: wall "
              f"{m['walls'][0]:.3f} s (unsharded with the draft {y['walls'][0]:.3f} s); "
              f"{spec['rounds']} rounds, {spec['emitted']} tokens, {spec['accepted']} accepted "
              f"drafts (unsharded {y['spec'][0]}); {equal} of {total} decodes equal the "
              f"unsharded one's, teacher-forced drift {drift:.4f}; segments "
              f"{'equal' if m['segments'][0] == y['segments'][0] else 'differ'}; rank 0's "
              f"decision broadcasts {ch['decisions']} ({ch['decisions'] / spec['rounds']:.2f} a "
              f"round, {ch['decision_s'] * 1e3:.1f} ms); stages ms "
              f"{', '.join(f'{k} {v:.1f}' for k, v in m['stages'][0].items())} [{card}]")
        for rank, out in enumerate(outs):
            mine = out[spath]
            print(f"  [{spath}] rank {rank}: {mine['heads']} decoder heads, the draft's "
                  f"{mine['draft_heads']}; peak device memory {mine['peak'] / 2**30:.2f} GiB "
                  f"(this process); launches {mine['launches']} [{card}]")
            require(mine["draft_heads"] == mine["heads"], f"{spath} rank {rank}: the draft "
                    f"holds {mine['draft_heads']} heads, the target {mine['heads']}")
            for name, (err, tol, shp) in mine["kernel_checks"].items():
                print(f"  [{spath}] rank {rank} {name} at the rank's shapes q {shp[0]}, "
                      f"{shp[1]} (its last call): max_abs_err {err:.3e} against its plain "
                      f"version (tol {tol:.2e}, as phase 3)")
                require(err <= tol, f"{spath} rank {rank}: {name} max_abs_err {err:.3e} > "
                                    f"tol {tol:.2e}")
            for name in ("K4 decode_attention_i4", "K6 beam_cross_attention_i4"):
                shp = mine["kernel_checks"].get(name, (0, 0, None))[2]
                require(shp is not None and shp[0][1] == mine["heads"],
                        f"{spath} rank {rank}: {name} was not held at the rank's "
                        f"{mine['heads']} heads: {shp}")
        paths[spath] = got["launches"]
        need_launched(paths, spath, ("log_mel", "flash_attention", "decode_attention_i4",
                                     "beam_cross_attention"))
    for rank, out in enumerate(outs):
        checked = out["engine_sp"]["kernel_checks"]
        shp = checked["K2 flash_attention"][2] if "K2 flash_attention" in checked else None
        require(shp is not None and 2 * shp[0][2] == shp[1][2] == cfg.n_audio_ctx,
                f"engine_sp rank {rank}: K2's last call was not a rank's half of the rows "
                f"against every key: {shp}")
    print(f"  phase 13 wall {time.perf_counter() - t_phase:.1f} s [{card}]")


def mesh_worker(torch, rank: int, port: int, tmp: Path) -> int:
    """``--mesh-worker``: one rank of phase 13 (see ``mesh_phase``). For each
    mesh it builds the engine on its shard; rank 0 runs the requests and the
    others follow; then every rank computes the teacher-forced logits of the
    yardstick's rows on its shard (one op of the channel) and holds K2-K6
    against their plain versions on their last call's inputs."""
    import dataclasses

    import torch.distributed as dist

    from sentiric_stt_whisper_service_tpu_torch import kernels, parallel
    from sentiric_stt_whisper_service_tpu_torch.models import config_for, init_params
    from sentiric_stt_whisper_service_tpu_torch.models import whisper as whisper_mod
    from sentiric_stt_whisper_service_tpu_torch.models.whisper import text_heads
    from sentiric_stt_whisper_service_tpu_torch.ops import beam_attention as ba
    from sentiric_stt_whisper_service_tpu_torch.ops import decode_attention as da
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import attention_reference
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import quantize_params, unpack_nibbles_i8
    from sentiric_stt_whisper_service_tpu_torch.runtime import SttEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(tmp / "ref.pt", weights_only=False)
    parallel.initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    kernels.lib()
    cfg = config_for("large-v3")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    with torch.inference_mode():
        full = quantize_params(init_params(cfg, g))  # phase 4's model, q/k/v unfused

    last = {}  # kernel -> (its function, q copied, the other inputs, keywords)
    patched = {"K2 flash_attention": "flash_attention",
               "K3 decode_attention int8": "decode_attention",
               "K4 decode_attention_i4": "decode_attention_i4",
               "K5 beam_attention": "beam_attention",
               "K6 beam_cross_attention_i4": "beam_cross_attention_i4"}
    originals = {attr: getattr(whisper_mod, attr) for attr in patched.values()}

    def keep(name, fn):
        def call(q, *rest, **kw):
            last[name] = (fn, q.clone(), rest, kw)
            return fn(q, *rest, **kw)
        return call

    def plain(name, q, rest, kw):
        if name.startswith("K2"):
            return attention_reference(q, *rest)
        if name.startswith("K3"):
            return da.decode_attention_reference(q, *rest, **kw)
        if name.startswith("K4"):
            k, v, ks, vs = rest
            return da.decode_attention_reference(q, unpack_nibbles_i8(k), unpack_nibbles_i8(v),
                                                 ks, vs, **kw)
        if name.startswith("K5"):
            k, v, anc, K = rest
            return ba.beam_attention_reference(q, k, v, anc, K, **kw)
        k, v, ks, vs = rest
        return ba.beam_cross_attention_reference(q, unpack_nibbles_i8(k), unpack_nibbles_i8(v),
                                                 ks, vs, **kw)

    def serve_mesh(path, settings, requests, draft=None) -> dict:
        """One engine over the mesh: rank 0 runs ``requests`` (the first
        alone, with the channel's counts around it), then the yardstick
        rows' teacher-forced logits as one op, and closes; the others
        follow. Every rank then holds the kernels against their plain
        versions on their last call's inputs."""
        last.clear()
        for name, attr in patched.items():
            setattr(whisper_mod, attr, keep(name, originals[attr]))
        torch.cuda.reset_peak_memory_stats()
        try:
            engine = SttEngine(settings, model_name="large-v3", params=full, draft_params=draft)
            mine = {"heads": text_heads(cfg, engine.params)}
            if draft is not None:
                mine["draft_heads"] = text_heads(engine.draft_cfg, engine.draft_params)

            def forced_op(pcm, rows, own=None, mine=mine, engine=engine):
                mine["launches"] = dict(kernels.LAUNCHES)  # the path's, before this pass
                return forced_logits(torch, cfg, engine.params, pcm, rows)

            engine._replay.register("forced", forced_op)
            kernels.reset_launch_counts()
            if engine.is_leader:
                if path.startswith("engine_sp"):  # graphed: its classes captured first
                    mesh_requests(torch, engine, ref["pcm"], requests)
                stats = engine._replay.stats
                before = dataclasses.astuple(stats)
                first = requests[0][0]
                alone = mesh_requests(torch, engine, ref["pcm"], requests[:1])
                mine["channel"] = {"ops": stats.ops - before[0],
                                   "op_s": stats.op_seconds - before[1],
                                   "decisions": stats.decisions - before[2],
                                   "decision_s": stats.decision_seconds - before[3],
                                   "decode_ms": alone[first]["stages"][0].get("decode", 0.0),
                                   "steps": MESH_TOKENS}
                mine["requests"] = {**alone, **mesh_requests(torch, engine, ref["pcm"],
                                                              requests[1:])}
                engine.shutdown()
                labels = [lb for lb, _, _ in requests]
                forced = engine._replay.call("forced", ref["pcm"],
                                             [ref["rows"][lb] for lb in labels])
                mine["forced"] = dict(zip(labels, forced))
                engine.close()
            else:
                engine.follow()
        finally:
            for attr, fn in originals.items():
                setattr(whisper_mod, attr, fn)
        checks = {}
        for name, (fn, q, rest, kw) in last.items():
            got, want = fn(q, *rest, **kw), plain(name, q, rest, kw)
            steps = 2 ** -5 if name[:2] in ("K2", "K6") else 2 ** -6
            err = (got.float() - want.float()).abs().max().item()
            checks[name] = (err, steps * want.float().abs().max().item(),
                            [tuple(q.shape), tuple(rest[0].shape)])
        mine["kernel_checks"] = checks
        mine["peak"] = torch.cuda.max_memory_allocated()
        del engine
        last.clear()
        torch.cuda.empty_cache()
        return mine

    turbo = turbo_draft(torch)
    out = {}
    for path, shape in MESH_SHAPES:
        requests = MESH_REQUESTS if path == "engine_tp" else MESH_REQUESTS[:1]
        out[path] = serve_mesh(path, mesh_settings(shape), requests)
        out[f"{path}_spec"] = serve_mesh(f"{path}_spec", mesh_spec_settings(shape),
                                         MESH_SPEC_REQUESTS, draft=turbo)
    torch.save(out, tmp / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def probe_phase(torch, paths, card) -> None:
    """Phase 10: the int8 attention probe (see the module docstring)."""
    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_attention import attention_reference
    from sentiric_stt_whisper_service_tpu_torch.ops.flash_q8 import flash_q8_plain
    from sentiric_stt_whisper_service_tpu_torch.tools import bench_flash_int8 as probe

    require(probe.shape_from_env() == P1_SHAPE, "the probe's shape is not its default")
    kernels.reset_launch_counts()
    rows = probe.main()
    paths["probe_flash_int8"] = dict(kernels.LAUNCHES)
    require([r["variant"] for r in rows] == list(probe.VARIANTS), "probe: variants missing")
    q, k, v = probe.make_inputs(P1_SHAPE, "cuda")
    ref = probe.fp32_reference(q, k, v)
    for r in rows:
        kernel = "flash_attention" if r["variant"] == "base" else "flash_q8"
        require(r["launches"].get(kernel, 0) >= 1, f"probe {r['variant']}: {kernel} not launched")
        plain = (attention_reference(q, k, v) if r["variant"] == "base"
                 else flash_q8_plain(q, k, v, r["variant"]))
        p_rms, p_max = probe.rel_errors(plain, ref)
        require(r["rel_rms_err"] <= 2 * p_rms and r["rel_max_err"] <= 2 * p_max,
                f"probe {r['variant']}: error {r['rel_rms_err']:.4g} / {r['rel_max_err']:.4g} x "
                f"std against its plain version's {p_rms:.4g} / {p_max:.4g}")
        print(f"  [probe_flash_int8] {r['variant']}: {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s; "
              f"error against fp32 attention RMS {r['rel_rms_err']:.5f}, max "
              f"{r['rel_max_err']:.5f} x std (plain version: {p_rms:.5f}, {p_max:.5f}) [{card}]")
    print(f"  [probe_flash_int8] launches {paths['probe_flash_int8']}")


def need_launched(paths, path, names, absent=()) -> None:
    """Each kernel of ``names`` launched on ``path``, none of ``absent``."""
    for name in names:
        require(paths[path][name] > 0, f"{path}: kernel {name} was not launched")
    for name in absent:
        require(paths[path][name] == 0, f"{path}: kernel {name} was launched")


class OwnLaunches:
    """The launches that each graphed ``StepLoop``'s replays add, per loop: a
    class-level wrap of ``StepLoop.advance`` (``close()`` undoes it), so that
    a pool's or a gang's own step graphs are counted apart from the eager
    launches of the threads beside them."""

    def __init__(self, step_loop):
        import collections

        self._cls, advance = step_loop, step_loop.advance
        self._advance = advance
        self.counts = collections.defaultdict(collections.Counter)  # id(loop) -> launches
        counts = self.counts

        def counted(loop, bound):
            advance(loop, bound)
            if loop.graphs is not None:
                counts[id(loop)].update(loop.graphs[bound][1])

        step_loop.advance = counted

    def record(self, paths, path, loops, names, absent=()) -> None:
        """The launches of ``loops`` since ``counts`` was cleared as path
        ``path``; each of ``names`` launched, none of ``absent``."""
        from sentiric_stt_whisper_service_tpu_torch import kernels

        paths[path] = {k: sum(self.counts[id(lp)][k] for lp in loops) for k in kernels.LAUNCHES}
        need_launched(paths, path, names, absent)
        print(f"  [{path}] launches of its own step graphs: {paths[path]}")

    def close(self) -> None:
        self._cls.advance = self._advance


def profile_slices(torch, cfg, model, audio, timed, card) -> None:
    """Where the time goes in each slice (int4 cross slab; the greedy one
    also with the int8 slab, whose cross read is K3): stage times
    (CUDA-synchronised host clock), then kernel time, device launches and
    idle share per decode step from torch.profiler, as the difference of an
    8- and a 40-token run (32 steps), and the kernels that take most of it;
    each eagerly and as replays of the step's CUDA graph (captured before
    the trace). Then the graphed greedy slice's wall at four intervals
    between reads of the device."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from sentiric_stt_whisper_service_tpu_torch.models import encode_xa_kv_q, encoder_apply
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel

    def wall_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t) * 1e3)
        return best

    with torch.inference_mode():
        mel = compute_log_mel(audio, n_mels=cfg.n_mels, dtype=cfg.dtype)
        t_mel = wall_ms(lambda: compute_log_mel(audio, n_mels=cfg.n_mels, dtype=cfg.dtype))
        t_enc = wall_ms(lambda: encoder_apply(cfg, model, mel))
        t_xa = wall_ms(lambda: encode_xa_kv_q(cfg, model, mel, 4)) - t_enc
    print(f"  stages, best of 3 [{card}]: log-mel {t_mel:.2f} ms, encoder {t_enc:.2f} ms, "
          f"int4 cross K/V {t_xa:.2f} ms (encode_xa_kv_q minus the encoder)")

    short, long_ = 8, 40
    f8 = torch.float8_e4m3fn
    for label, bits, self_dtype, beam in (("greedy, fp8 self cache", 4, f8, 0),
                                          ("greedy, int8 slab, fp8 self cache", 8, f8, 0),
                                          (f"beam {BEAM}, bf16 self cache", 4, None, BEAM)):
        for mode in ("eager", "graphed"):
            runs = {}
            for n in (short, long_):
                if mode == "graphed":  # the class's capture, outside the trace
                    timed(bits, self_dtype, n, beam)
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    _, _, wall = timed(bits, self_dtype, n, beam, graph=mode == "graphed")
                by_name = {}
                for e in prof.events():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        t_us, count = by_name.get(e.name, (0.0, 0))
                        by_name[e.name] = (t_us + e.time_range.elapsed_us(), count + 1)
                busy = sum(t for t, _ in by_name.values()) / 1e3
                launches = sum(c for _, c in by_name.values())
                runs[n] = (wall * 1e3, busy, launches, by_name)
                print(f"  [{label}, {mode}] {n} tokens under the profiler: wall "
                      f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms ({launches} device "
                      f"events), idle {100 * (1 - busy / (wall * 1e3)):.1f} %")
            steps = long_ - short
            (w0, b0, l0, _), (w1, b1, l1, names) = runs[short], runs[long_]
            print(f"  [{label}, {mode}] per decode step ({long_} minus {short} tokens): wall "
                  f"{(w1 - w0) / steps:.2f} ms, device busy {(b1 - b0) / steps:.3f} ms, "
                  f"{(l1 - l0) / steps:.0f} device events, idle "
                  f"{100 * (1 - (b1 - b0) / (w1 - w0)):.1f} % [{card}]")
            ranked = sorted(names.items(), key=lambda kv: -kv[1][0])
            print(f"    the {long_}-token run's top kernels, then the port's own:")
            for name, (t_us, count) in ranked[:8] + [r for r in ranked[8:] if any(
                    o in r[0] for o in PROFILE_KERNELS)]:
                print(f"    {t_us / 1e3:9.2f} ms {count:7d}x {t_us / count:8.2f} us  {name[:90]}")

    # The graphed greedy loop's reads of the device: every SYNC_STEPS steps
    # (the host stalls once each), at the slice's budget; best of 2 walls.
    from sentiric_stt_whisper_service_tpu_torch.models import sampling

    default = sampling.SYNC_STEPS
    timed(4, f8, DECODE_TOKENS)  # the class's capture
    try:
        for every in (1, 4, 16, 64):
            sampling.SYNC_STEPS = every
            wall = min(timed(4, f8, DECODE_TOKENS)[2] for _ in range(2))
            print(f"  [greedy, fp8 self cache, graphed] {DECODE_TOKENS} tokens, device read every "
                  f"{every} steps: wall {wall:.3f} s (best of 2) [{card}]")
    finally:
        sampling.SYNC_STEPS = default


def drift_check(label, reference, stepwise, torch) -> float:
    """Stepwise logits (the kernels) against teacher-forced ones (plain
    attention): max |diff| within a quarter of the logits' spread and the
    argmax agreeing on 90 % of positions. Returns max |diff|."""
    require(bool(torch.isfinite(reference).all()) and bool(torch.isfinite(stepwise).all()),
            f"{label}: non-finite logits")
    diff = (reference - stepwise).abs().max().item()
    spread = reference.std().item()
    agree = (reference.argmax(-1) == stepwise.argmax(-1)).float().mean().item()
    print(f"  {label}, {reference.shape[1]} positions: max |diff| {diff:.4f} "
          f"(logit std {spread:.3f}), argmax agreement {agree:.3f}")
    require(diff <= 0.25 * spread and agree >= 0.9,
            f"{label}: logits differ by {diff:.4f} (bound 0.25 x std {spread:.3f}), "
            f"argmax agreement {agree:.3f} (bound 0.9)")
    return diff


if __name__ == "__main__":
    sys.exit(main())
