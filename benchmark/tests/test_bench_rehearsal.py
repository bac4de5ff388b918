"""The whole run of every cell, rehearsed on the CPU at a tiny size on the
port's plain versions (the harness's look for a card skipped): it comes out
correct, and it comes out not correct with each fault the cell's traffic
can have planted underneath the timed path (`faults.py`).  The command
itself refuses to run without a card, and nothing a run loads is JAX or
the JAX package."""

import json
import subprocess
import sys
import time
import types

import faults
import pytest
from harness import device, runner
from harness.registry import Registry

from conftest import BENCH, ROOT

#: Each cell cut to a size the CPU runs in a second; widths as configured.
TINY = {
    "flagship16k.train": {"config": {"n": 256}},
    "vfe131k.train": {"config": {"n": 2048, "m_per_latent": 32, "half_width": 32.0}},
    "flagship16k.query": {"config": {"n": 256}, "traffic": {"points": 64}},
    "flagship16k.predict": {"config": {"n": 256}, "traffic": {"points": 32, "pool": 4}},
}
SEED = 2**31 + 977


def rehearse(cell, seed=SEED, root=ROOT, overrides=None):
    result, run, ctx = runner.run_cell(root, cell, seed, 0.3, False, "cpu", time.perf_counter(),
                                       overrides or TINY[cell])
    return result, run, ctx


def test_every_cell_is_rehearsed():
    assert sorted(TINY) == sorted(w["name"] for w in Registry(ROOT).spec["workloads"])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    result, run, ctx = rehearse(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert sorted(c["name"] for c in result["checks"]) == sorted(ctx.limits)
    names = [m["name"] for m in ctx.reg.metrics(cell, traced=False)]
    assert names[0] == "setup_s" and len(names) >= 2
    for name in names:  # every end-to-end metric finds its reading
        assert ctx.reg.reader(name).read(run) is not None


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(TINY)
                                        for f in faults.BY_KIND[Registry(ROOT).traffic(
                                            Registry(ROOT).cell(c)["traffic"])["kind"]]])
def test_fault_is_caught(cell, fault):
    with faults.plant(fault):
        result, _, _ = rehearse(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["flagship16k.query", "vfe131k.train"])
def test_same_seed_same_inputs(cell):
    import torch

    def inputs(seed):
        ctx = runner.Context(Registry(ROOT), cell, seed, "cpu", TINY[cell])
        data = ctx.programme.make_data(ctx.cfg, ctx.gen, ctx.device)
        return [*data.values(), torch.rand(3, generator=ctx.gen)]

    for a, b in zip(inputs(SEED), inputs(SEED)):
        assert torch.equal(a, b)
    assert not torch.equal(inputs(SEED)[0], inputs(SEED + 1)[0])


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is for machines without one")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "flagship16k.train",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""


def test_no_run_loads_jax():
    """A rehearsal of every cell in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or stheno_tpu (compared whole)."""
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}, {str(BENCH / 'tests')!r}]\n"
        "from test_bench_rehearsal import TINY, rehearse\n"
        "from harness import device\n"
        "for cell in TINY: rehearse(cell)\n"
        "print(json.dumps(device.foreign_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    foreign, loaded = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert foreign == []
    assert "stheno_tpu_torch" in loaded


def test_foreign_names_are_compared_whole():
    assert device.foreign_modules(["stheno_tpu_torch", "stheno_tpu_torch.entry", "jaxtyping"]) == []
    assert device.foreign_modules(["stheno_tpu.ops", "jax.numpy"]) == ["jax", "stheno_tpu"]


@pytest.mark.parametrize("loaded,code", [(None, 0), ("jax", 3), ("stheno_tpu.ops", 3)])
def test_command_refuses_what_a_reader_loads(monkeypatch, capsys, loaded, code):
    """The command's look for JAX comes after every metric's reader has run:
    a reader that loads a foreign module leaves the run with exit code 3 and
    no result (the look for a card skipped, the cell rehearsed on the CPU)."""
    import torch

    from harness.registry import load_module

    assert device.foreign_modules() == []
    cmd = load_module(BENCH / "run.py", "command")
    rehearse_cell = runner.run_cell
    monkeypatch.setattr(device, "require_cards", lambda n: None)
    monkeypatch.setattr(device, "use_checkout_caches", lambda root: None)
    monkeypatch.setattr(device, "card_line", lambda: "no card (rehearsal)")
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: "no card (rehearsal)")
    monkeypatch.setattr(runner, "run_cell", lambda root, cell, seed, seconds, trace, dev, t0: rehearse_cell(
        root, cell, seed, 0.3, trace, "cpu", t0, TINY[cell]))
    reader = Registry.reader

    def loading_reader(self, name):
        mod = reader(self, name)
        if name != "setup_s" or loaded is None:
            return mod

        class Loads:
            @staticmethod
            def read(run):
                monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
                return mod.read(run)
        return Loads

    monkeypatch.setattr(Registry, "reader", loading_reader)
    argv = ["--workload", "flagship16k.query", "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    if code:
        with pytest.raises(SystemExit) as exit_:
            cmd.main(argv)
        assert exit_.value.code == code
    else:
        assert cmd.main(argv) == 0
    out, err = capsys.readouterr()
    if code:
        assert out == ""
        assert loaded.split(".")[0] in err.strip().splitlines()[-1]
    else:
        line = json.loads(out.strip().splitlines()[-1])
        assert line["correct"] and set(line["metrics"]) == {"setup_s", "request_p95_ms", "points_per_s"}
