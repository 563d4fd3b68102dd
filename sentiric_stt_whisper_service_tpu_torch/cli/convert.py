"""Checkpoint conversion tool.

``python -m sentiric_stt_whisper_service_tpu_torch.cli.convert <in> <out>``

Converts between the formats the port loads, as the JAX package's
``cli/convert.py`` does:

  * HF safetensors → whisper.cpp GGML .bin (f32 or f16), so that
    whisper.cpp deployments can take fine-tuned HF checkpoints;
  * GGML .bin → safetensors (quantized variants dequantized to f32): the
    parameter tree flattened to dotted names (``checkpoint.flatten_tree``),
    the layout ``checkpoint.restore_params`` reads.

Any other pair of suffixes exits with code 2.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Whisper checkpoint converter")
    ap.add_argument("input", help="input checkpoint (.safetensors or .bin)")
    ap.add_argument("output", help="output checkpoint (.bin or .safetensors)")
    ap.add_argument("--ftype", choices=["f32", "f16"], default="f16",
                    help="GGML tensor type when writing .bin")
    args = ap.parse_args(argv)

    import torch

    from ..checkpoint import flatten_tree, load_ggml, load_safetensors, write_ggml
    from ..checkpoint import write_safetensors
    from ..models.params import to_numpy_tree
    from ..tokenizer import fallback_tokenizer

    if args.input.endswith(".safetensors") and args.output.endswith(".bin"):
        cfg, model = load_safetensors(args.input, dtype=torch.float32)
        # GGML carries its vocab; without sibling files, byte-level ranks
        # (exact ids, lossy only for display of merged pieces).
        tok = fallback_tokenizer(cfg.n_vocab)
        vocab = [bytes(piece) for piece, _ in sorted(tok.ranks.items(), key=lambda kv: kv[1])]
        with open(args.output, "wb") as f:
            write_ggml(f, cfg, model, vocab, ftype=1 if args.ftype == "f16" else 0)
        print(f"wrote GGML {args.ftype}: {args.output}")
        return 0

    if args.input.endswith(".bin") and args.output.endswith(".safetensors"):
        _, model, _, _ = load_ggml(args.input, dtype=torch.float32)
        flat = flatten_tree(to_numpy_tree(model))
        write_safetensors(args.output, flat)
        print(f"wrote safetensors ({len(flat)} tensors): {args.output}")
        return 0

    print("unsupported conversion (need .safetensors->.bin or .bin->.safetensors)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
