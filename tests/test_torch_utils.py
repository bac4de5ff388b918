"""The port's `utils.cost` and `utils.logging` against the JAX package's:
the FLOPs of a GEMM and of a logpdf's products (the reference reads XLA's
cost model, the port counts while it runs), the printed summary line,
`log_scalars`' cadence and sink, and `Trace`'s written profile."""

import io
import json

import jax.numpy as jnp
import numpy as np
import torch

from stheno_tpu.utils.cost import cost_analysis as jax_cost_analysis
from stheno_tpu_torch.utils import cost_analysis, cost_summary
from stheno_tpu_torch.utils.logging import Trace, log_scalars
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_gemm_flops_match_the_reference():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(64, 48)), rng.normal(size=(48, 32))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    port = cost_analysis(lambda: ta @ tb)
    ref = jax_cost_analysis(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(b))
    assert port["flops"] == float(ref["flops"]) == 2 * 64 * 48 * 32
    assert port["flops_by_op"] == {"aten.mm": 2 * 64 * 48 * 32}
    # the two operands read once and the product written once, in f64
    assert port["bytes accessed"] == (64 * 48 + 48 * 32 + 64 * 32) * 8


def test_cost_summary_prints_the_roofline_line():
    buf = io.StringIO()
    a = torch.ones(128, 128)
    ca = cost_summary(lambda: a @ a, peak_flops=1e12, hbm_bw=1e9, name="mm", file=buf)
    line = buf.getvalue()
    assert line.startswith("[cost] mm") and "flops=4.19e+06" in line
    assert "model-memory-bound" in line and ca["flops"] == 2 * 128**3


def test_log_scalars_every_n_steps():
    seen = []
    for i in range(7):
        log_scalars("fit", step=i, every=3, sink=lambda tag, s, v: seen.append((tag, s, v)),
                    loss=torch.tensor(float(i)))
    assert [(t, s) for t, s, _ in seen] == [("fit", 0), ("fit", 3), ("fit", 6)]
    assert float(seen[1][2]["loss"]) == 3.0


def test_trace_writes_a_profile(tmp_path):
    with Trace("region", dir=str(tmp_path)) as tr:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert tr.profile is not None
    events = json.loads((tmp_path / "region.json").read_text())["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
