"""The NUTS measurement tools (`stheno_tpu_torch.nuts_bench`, `nuts_pool`)
on the CPU at N = 64, 2 chains, 20 + 20, max_depth 5: the JSON line has the
reference script's keys; a segmented run takes the unsegmented run's draws
bit for bit; `--chain-batches 2` equals two `--batch-offset` runs pooled;
and the reference `scripts/nuts_pool.py` reads the port's files and prints
the port's pooled line field for field."""

import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from stheno_tpu_torch import nuts_bench, nuts_pool
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--n", "64", "--chains", "2", "--warmup", "20", "--samples", "20",
         "--max-depth", "5"]
DRAWS = ("draws_v", "draws_l", "draws_noise", "div")


def _keys_of(script, start, end):
    """The keys of the dict literal the reference script prints, between
    two markers of its source."""
    src = (REPO / "scripts" / script).read_text()
    block = src[src.index(start):src.index(end, src.index(start))]
    return set(re.findall(r'^\s*"(\w+)":', block, flags=re.M))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("nuts_bench")
    out = {}
    for name, extra in (("b0", ["--batch-offset", "0"]), ("b1", ["--batch-offset", "1"]),
                        ("seg", ["--segment", "6", "--warmup-segment", "7"]),
                        ("cb2", ["--chain-batches", "2", "--segment", "8", "--single-pass"])):
        path = d / f"{name}.npz"
        line = nuts_bench.main(SMALL + extra + ["--save-draws", str(path)])
        out[name] = (line, np.load(path), path)
    return out


def test_the_json_line_has_the_reference_keys(runs):
    want = _keys_of("nuts_bench.py", "out = {", "\n    }")
    for line, _, _ in runs.values():
        assert set(line) == want | {"device"}
        assert line["device"] == "cpu" and line["n"] == 64 and line["samples"] == 20
    assert runs["b0"][0]["n_sampling_calls"] == 1 and runs["seg"][0]["n_sampling_calls"] == 4
    assert runs["cb2"][0]["chains"] == 4 and runs["cb2"][0]["chain_batches"] == 2


def test_saved_draws_have_the_reference_keys_and_shapes(runs):
    _, z, _ = runs["b0"]
    assert set(z.files) == {"div", "dt", "t_warm", "null_s", "n_sampling_calls", "n", "chains",
                            "samples", "warmup", "draws_v", "draws_l", "draws_noise"}
    for k in DRAWS:
        assert z[k].shape == (2, 20)
    assert np.all(z["draws_v"] > 0) and np.all(np.isfinite(z["draws_l"]))


def test_segmented_equals_unsegmented_bit_for_bit(runs):
    for k in DRAWS:
        np.testing.assert_array_equal(runs["seg"][1][k], runs["b0"][1][k])


def test_chain_batches_equal_offset_runs_pooled(runs, capsys):
    pooled = nuts_pool.main([str(runs["b0"][2]), str(runs["b1"][2])])
    cb2 = runs["cb2"][1]
    for k in DRAWS:
        np.testing.assert_array_equal(cb2[k], np.concatenate([runs["b0"][1][k], runs["b1"][1][k]]))
    assert pooled["chains"] == 4 and pooled["batches_pooled"] == 2
    for k in ("rhat_max", "divergence_rate"):
        assert pooled[k] == runs["cb2"][0][k]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == pooled
    assert set(pooled) == _keys_of("nuts_pool.py", "out = {", "\n    }")


def test_the_reference_pool_reads_the_ports_files(runs, monkeypatch):
    spec = importlib.util.spec_from_file_location("reference_nuts_pool", REPO / "scripts" / "nuts_pool.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    paths = [str(runs["b0"][2]), str(runs["b1"][2])]
    monkeypatch.setattr(sys, "argv", ["nuts_pool.py", *paths])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    theirs = json.loads(buf.getvalue().strip().splitlines()[-1])
    with contextlib.redirect_stdout(io.StringIO()):
        ours = nuts_pool.main(paths)
    # The draws are float32.  The reference's ESS comes back in float64 (its
    # last steps promote under x64) and its R̂ sums in XLA's order, where the
    # port stays in float32 in torch's order: ESS agrees to about 1e-6
    # relative, R̂ to about 1e-7.  The fields rounded from them differ by one
    # unit of their last place where the wall-clock `dt` puts a value by a
    # rounding boundary; every other field is equal.
    last_place = {"ess_per_s": 0.01, "ess_per_s_device": 0.01, "rhat_max": 1e-4}
    assert {k: v for k, v in theirs.items() if k not in last_place} == {
        k: v for k, v in ours.items() if k not in last_place}
    for k, unit in last_place.items():
        assert abs(theirs[k] - ours[k]) <= 1.001 * unit, (k, theirs[k], ours[k])


def test_pool_checks_its_files(runs, tmp_path):
    with pytest.raises(SystemExit, match="usage"):
        nuts_pool.main([])
    z = dict(np.load(runs["b0"][2]))
    z["samples"] = np.asarray(19)
    bad = tmp_path / "bad.npz"
    np.savez(bad, **z)
    with pytest.raises(SystemExit, match="mismatch"):
        nuts_pool.main([str(runs["b0"][2]), str(bad)])
