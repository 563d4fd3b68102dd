"""The readings that a cell's limits are set from: for each seed, a short
window of the cell's own traffic, then the numbers compared for the
program and for the control (the reference computed one precision below
the configuration's, int4 weights for int8, put in the program's place:
at each position of the same prompts and served tokens, the token it puts
first, and its log-probability of the served one; in a beam cell also the
``beam_not_first`` of the control's own beam search and of the
reference's with each fault of ``reference.BEAM_FAULTS`` planted). One
process for all seeds, on the card:

    python3 benchmark/families/whisper/control.py --workload <cell> --seconds <s> --seeds a,b,c

(``--control-seeds a,b``: the seeds on which the control is read too).
Prints one JSON line per seed and a last line with the largest program
reading and the smallest control and fault reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    from benchmark import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    config_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = harness.load_json(ROOT / config_entry["file"])
    workload = harness.load_json(ROOT / "benchmark" / "workloads" / f"{cell['name']}.json")
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = harness.run_cell(config, workload, [], seed, args.seconds, False, "cuda", t,
                               lambda m: print(m, file=sys.stderr, flush=True),
                               control=seed in control_seeds)
        r = res["readings"]
        line = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"], **r}
        print(json.dumps(line), flush=True)
        for name in ("token_gap", "logprob_err", "beam_not_first"):
            worst[name] = max(worst.get(name, 0.0), r[name])
        for name in r:
            if name.startswith(("control_", "fault_")):
                least[name] = min(least.get(name, float("inf")), r[name])
    print(json.dumps({"program_max": worst, "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
