"""What the port's tracer costs when it is on: units of one benchmark cell
(`BENCHMARK.json`, `benchmark/`) in blocks, alternately inside
`stheno_tpu_torch.utils.logging.recording()` and outside it, each block
timed on the host's clock up to a synchronise.  Pairs alternate which mode
runs first.

    python3 scripts/tracing_cost.py --workload flagship16k.train --seed 7 --units 8 --pairs 6

Set-up is the cell's own (its driver's `setup`, on the card unless
`--device cpu`), followed by one unit in each mode, whose spans, once
read, leave the tracer's timing events for reuse.  Prints one JSON line: the card, each block's mode
and milliseconds a unit, each mode's median, and the spans a unit recorded.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=8, help="units a block")
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default="{}", help="JSON overrides of the cell (sizes, for a CPU rehearsal)")
    args = p.parse_args(argv)

    import torch
    from harness import runner
    from harness.registry import Registry

    from stheno_tpu_torch.utils import logging as tracer

    ctx = runner.Context(Registry(ROOT), args.workload, args.seed, args.device, json.loads(args.overrides))
    blocks = []
    with runner.precision_scope(ctx.cfg["gemm_precision"]):
        st = ctx.driver.setup(ctx)
        ctx.driver.unit(ctx, st)
        with tracer.recording():
            ctx.driver.unit(ctx, st)
        ctx.sync()
        tracer.clear()
        with tracer.recording():  # timing events made outside the timed blocks
            ctx.driver.unit(ctx, st)
        ctx.sync()
        warm = len(tracer.spans())
        for i in range(args.pairs):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                t0 = time.perf_counter()
                if on:
                    with tracer.recording():
                        for _ in range(args.units):
                            ctx.driver.unit(ctx, st)
                else:
                    for _ in range(args.units):
                        ctx.driver.unit(ctx, st)
                ctx.sync()
                blocks.append({"on": on, "ms": (time.perf_counter() - t0) * 1e3 / args.units})
    spans = len(tracer.spans()) - warm
    med = {mode: statistics.median(b["ms"] for b in blocks if b["on"] == (mode == "on")) for mode in ("off", "on")}
    card = torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu"
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": card, "units": args.units,
                      "blocks": blocks, "median_ms": med, "cost": med["on"] / med["off"] - 1.0,
                      "spans_a_unit": spans / (args.pairs * args.units)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
