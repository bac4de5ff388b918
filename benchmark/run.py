"""The benchmark of the PyTorch and CUDA port (`stheno_tpu_torch`): one run of
one cell of `BENCHMARK.json`, in this process, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Set-up, then `--seconds` of the cell's
traffic, then (with `--trace 1`) a profiled sub-window, then the check of
what the timed path produced against the plain reference.  The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the end-to-end metrics without tracing, the per-layer ones with
it), `device`, with tracing `breakdown`, and last `checks`, each compared
number beside its limit; the same numbers close standard error.

Exits 2, printing no result, without enough CUDA devices; 3 when the
program under test is not this checkout's or when JAX, Flax or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import device  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code, msg):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _finite(value):
    """A number as JSON can hold it: a non-finite one as its name."""
    return value if math.isfinite(value) else repr(value)


def check_lines(checks):
    return [f"check {c['name']} {c['value']!r} limit {c['limit']!r}" for c in checks]


def main(argv=None):
    args = parse(argv)
    import torch

    from harness.registry import Registry

    cell = Registry(ROOT).cell(args.workload)
    try:
        device.require_cards(cell["chips"])
    except device.NoCard as err:
        fail(2, str(err))
    device.use_checkout_caches(ROOT)
    torch.set_num_threads(4)
    try:
        import stheno_tpu_torch
    except ImportError as err:
        fail(3, f"the program under test is missing: {err}")
    if ROOT not in Path(stheno_tpu_torch.__file__).resolve().parents:
        fail(3, f"the program under test is not this checkout's: {stheno_tpu_torch.__file__}")
    from harness import runner

    runner.phase("imports", T_START)
    result, run, ctx = runner.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                       "cuda", T_START)
    metrics = runner.read_metrics(ctx, run, bool(args.trace))
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
           "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": result["correct"], "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        tr = run["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["card"] = device.card_line()
    line["checks"] = {c["name"]: {"value": _finite(c["value"]), "limit": c["limit"]} for c in result["checks"]}
    for text in check_lines(result["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    # Last, after every reader and helper has run: what the process holds now.
    foreign = device.foreign_modules()
    if foreign:
        fail(3, f"modules that no run may load were loaded: {', '.join(foreign)}")
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
