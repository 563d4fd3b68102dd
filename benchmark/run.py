"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, this folder and the
port (``sentiric_stt_whisper_service_tpu_torch``), on a machine with as
many CUDA cards as the cell asks for. The last line of standard output is
the result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``; ``compared`` last: each number the
comparison with the reference read, beside its limit). The same numbers
end standard error. Exits non-zero, with no result, without the cards,
with the port missing, or when a module of JAX or of the JAX package was
loaded.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
# Kernel and compiler caches inside the checkout, at fixed paths.
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        log(f"no cell {args.workload!r} in BENCHMARK.json: {sorted(cells)}")
        return 2
    cell = cells[args.workload]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = harness.load_json(ROOT / config_entry["file"])
    workload = harness.load_json(ROOT / "benchmark" / "workloads" / f"{cell['name']}.json")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    result = harness.run_cell(config, workload,
                              harness.cell_metrics(spec, cell["name"], bool(args.trace)),
                              args.seed, args.seconds, bool(args.trace), "cuda", T_PROC, log)
    found = harness.banned_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    result.pop("readings", None)
    for name, c in result["compared"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
