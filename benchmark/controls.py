"""The readings that set the limits of `correct`, on the card at a cell's
own size, many seeds in one process (the kernels built once):

    python3 benchmark/controls.py --workload <cell> --seeds 1-12 \
        --control-seeds 101-103 [--fault-seeds 201-203 [--faults half_batch]] [--seconds 3]

For each seed one run of the cell as the benchmark makes it (set-up, a
short window, the comparison with the reference), in one of three modes:
`sound` (the program as the configuration states it), `control` (the port's
TF32 route, `control=True` in `harness/runner.py`) and, for each fault
that the cell's traffic can have (`faults.py`), that fault planted.  One
JSON line a run on standard output, then one summary line: for each
compared number the largest sound reading (`lower`), the smallest control
reading and the smallest reading of each fault.  The benchmark's own runs
never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import faults  # noqa: E402
from harness import device, runner  # noqa: E402
from harness.registry import Registry  # noqa: E402


def seeds(text):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def reading(workload, seed, seconds, mode):
    t0 = time.perf_counter()
    planted = contextlib.nullcontext() if mode in ("sound", "control") else faults.plant(mode)
    with planted:
        result, _, _ = runner.run_cell(ROOT, workload, seed, seconds, False, "cuda", t0,
                                       control=mode == "control")
    return {"workload": workload, "mode": mode, "seed": seed, "correct": result["correct"],
            "attempted": result["attempted"], "failed": result["failed"],
            "checks": {c["name"]: c["value"] for c in result["checks"]},
            "seconds": time.perf_counter() - t0}


def summary(lines):
    out = {}
    for line in lines:
        for name, value in line["checks"].items():
            slot = out.setdefault(name, {})
            if line["mode"] == "sound":
                slot["lower"] = max(slot.get("lower", 0.0), value)
            else:
                key = f"{line['mode']}_min"
                slot[key] = min(slot.get(key, float("inf")), value)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--faults", default=None,
                   help="comma-separated faults to plant (default: every fault of the traffic's kind)")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    device.require_cards(1)
    device.use_checkout_caches(ROOT)
    kind = Registry(ROOT).traffic(Registry(ROOT).cell(args.workload)["traffic"])["kind"]
    plan = [("sound", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    planted = args.faults.split(",") if args.faults else faults.BY_KIND[kind]
    plan += [(f, s) for f in planted for s in args.fault_seeds]
    lines = []
    for mode, seed in plan:
        line = reading(args.workload, seed, args.seconds, mode)
        lines.append(line)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "card": device.card_line(), "summary": summary(lines)}),
          flush=True)


if __name__ == "__main__":
    main()
