#!/usr/bin/env python3
"""Two measurements of threads sharing one NVIDIA GPU, behind two choices of
the port's concurrent paths.

Usage, from the root of a checkout on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA:

    python3 chip_threads.py

Large-v3 at full width with random weights (seed 0), int8 weights and fused
qkv, as in ``chip_smoke.py``:

1. reads of the card: 2000 small eager launches from this thread, alone and
   while another thread replays a continuous batcher's step graph (S = 8
   slots, int4 pool, fp8 self cache; 4 steps, then a read of the slots'
   positions), the read a blocking ``.cpu()`` or ``models/graphs.to_host``
   (an event wait). This is why the serving paths read the card through
   ``to_host``;
2. the request-side eager stages of seven 30 s windows (log-mel, encode to
   the int4 carrier, language detection, a 200-token alignment pass): one
   after another, from a thread each at once, and from a thread each one at
   a time under one lock. This is why the engine runs its request threads'
   eager stages one at a time on the card (its ``_eager`` lock).

Each reading is printed beside the card's name and power limit. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

from chip_smoke import CONCURRENT, PKG, ROOT, SEED, card_line, voiced_like

WINDOWS = 7  # the 16 kHz requests of chip_smoke.py phase 7
LAUNCHES = 2000


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / PKG / "__init__.py").is_file():
        print(f"FAIL: package {PKG} not found in {ROOT}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from sentiric_stt_whisper_service_tpu_torch import kernels
    from sentiric_stt_whisper_service_tpu_torch.models import (
        TokenIds,
        build_suppress_mask,
        config_for,
        detect_language,
        encode_xa_kv_q,
        init_params,
    )
    from sentiric_stt_whisper_service_tpu_torch.models.graphs import to_device, to_host
    from sentiric_stt_whisper_service_tpu_torch.models.timestamps import compute_token_times
    from sentiric_stt_whisper_service_tpu_torch.ops import compute_log_mel, pad_or_trim
    from sentiric_stt_whisper_service_tpu_torch.ops.quant import fuse_decoder_qkv, quantize_params
    from sentiric_stt_whisper_service_tpu_torch.runtime.batcher import ContinuousBatcher
    from sentiric_stt_whisper_service_tpu_torch.tokenizer import fallback_tokenizer

    card = card_line()
    print(f"== card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build()
    dev = torch.device("cuda")
    cfg = config_for("large-v3")
    with torch.inference_mode():
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        model = fuse_decoder_qkv(quantize_params(init_params(cfg, g)))
    tok = fallback_tokenizer(cfg.n_vocab)
    ids = TokenIds.from_tokenizer(tok)
    sup = torch.from_numpy(build_suppress_mask(cfg.n_vocab, ids, tok.non_speech_tokens)).to(dev)
    sp = tok.special
    sot = list(tok.sot_sequence("en"))
    rng = np.random.default_rng(SEED + 7)
    firsts = [pad_or_trim(voiced_like(rng, 30.0)) for _ in range(WINDOWS)]

    # 1. Eager launches beside a replaying pool, read two ways.
    with torch.inference_mode():
        pool = ContinuousBatcher(cfg, model, ids, sup, max_slots=CONCURRENT, kv_bits=4,
                                 self_dtype=torch.float8_e4m3fn)
    x = torch.ones(64, device=dev)

    def launches_s():
        t = time.perf_counter()
        y = x
        for _ in range(LAUNCHES):
            y = y * 1.0001
        y.sum().item()
        return time.perf_counter() - t

    def replaying(read, stop):
        with torch.inference_mode():
            while not stop.is_set():
                for _ in range(pool.steps_per_sync):
                    pool._loop.advance(pool.bounds[-1])
                read(pool.state.pos)

    launches_s()
    timings = [("alone", launches_s())]
    for label, read in (("a blocking .cpu()", lambda t: t.cpu()), ("to_host", to_host)):
        stop = threading.Event()
        th = threading.Thread(target=replaying, args=(read, stop))
        th.start()
        time.sleep(0.2)
        timings.append((f"beside replays read with {label}", launches_s()))
        stop.set()
        th.join(timeout=60)
    pool.shutdown()
    del pool
    print(f"== 1. {LAUNCHES} eager launches: "
          + "; ".join(f"{k} {v:.3f} s" for k, v in timings) + f" [{card}]")

    # 2. The request-side eager stages of seven windows, three ways.
    align_seq = np.asarray(sot + [100 + i for i in range(200)], np.int64)

    def eager_stages(i, lock=contextlib.nullcontext()):
        with lock, torch.inference_mode():
            mel = compute_log_mel(to_device(firsts[i][None], dev), n_mels=cfg.n_mels,
                                  dtype=cfg.dtype)
            xa = encode_xa_kv_q(cfg, model, mel, 4)
            to_host(detect_language(cfg, model, xa, sp.sot, sp.language_begin, sp.num_languages))
            compute_token_times(cfg, model, xa, align_seq, len(sot), cfg.n_audio_ctx)

    def all_threads(lock=contextlib.nullcontext()):
        ths = [threading.Thread(target=eager_stages, args=(i, lock)) for i in range(WINDOWS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)

    eager_stages(0)
    for label, fn in (("one after another", lambda: [eager_stages(i) for i in range(WINDOWS)]),
                      (f"from {WINDOWS} threads at once", all_threads),
                      (f"from {WINDOWS} threads one at a time",
                       lambda: all_threads(threading.Lock()))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"== 2. eager stages (log-mel, encode, detect, 200-token alignment) of {WINDOWS} "
              f"windows, {label}: {time.perf_counter() - t:.3f} s [{card}]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
