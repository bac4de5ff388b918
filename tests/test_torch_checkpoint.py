"""The port's sampler checkpoints: a round trip of the samplers' states
(exact: numpy keeps every bit), the refusal of a structure that differs
from the `like` tree in a path, a shape, a dtype or the number of leaves,
`checkpoint_step`, and the structure record, whose paths are the JAX
package's for the same tree."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stheno_tpu.inference import checkpoint as jc
from stheno_tpu_torch.inference import (
    ChainState,
    SMCCheckpoint,
    checkpoint_step,
    load_checkpoint,
    save_checkpoint,
)
from stheno_tpu_torch.inference import checkpoint as tc
from stheno_tpu_torch.inference.hmc import DualAveragingState, WarmupState, WelfordState
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _states(seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, dtype=torch.float64):
        return torch.as_tensor(rng.normal(size=shape)).to(dtype)

    chain = ChainState(t(3, 4), t(3), t(3, 4), t(3).abs(), t(3, 4).abs())
    warm = WarmupState(t(3, 4), t(3), t(3, 4), DualAveragingState(t(3), t(3), t(3), t(3), t(3)),
                       WelfordState(t(3), t(3, 4), t(3, 4)), t(3, 4, dtype=torch.float32))
    smc = SMCCheckpoint(t(16, 3), t(16), t(), t(), torch.tensor(2, dtype=torch.int32),
                        torch.full((5,), float("nan"), dtype=torch.float64))
    return {"chain": chain, "warmup": warm, "smc": smc,
            "tree": {"b": [t(2), t(2, 2)], "a": (t(1), torch.arange(3))}}


@pytest.mark.parametrize("name", ["chain", "warmup", "smc", "tree"])
def test_round_trip_is_exact(name, tmp_path):
    tree = _states()[name]
    path = str(tmp_path / name)
    save_checkpoint(path, tree, step=7)
    back = load_checkpoint(path, tree)
    assert type(back) is type(tree)
    for (p, a), (q, b) in zip(tc.tree_leaves_with_path(tree), tc.tree_leaves_with_path(back)):
        assert p == q and a.dtype == b.dtype and a.device == b.device
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert checkpoint_step(path) == 7


def test_structure_mismatch_is_refused(tmp_path):
    """The reference test's cases: same arity with another key, a shape,
    and a dtype; and a leaf count."""
    tree = {"a": torch.arange(3.0), "b": torch.ones(3)}
    path = str(tmp_path / "ckpt_bad")
    save_checkpoint(path, tree)
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, {"a": torch.arange(3.0), "c": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"a": torch.arange(4.0), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(path, {"a": torch.arange(3.0), "b": torch.ones(3, dtype=torch.int32)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, {"a": torch.arange(3.0)})
    back = load_checkpoint(path, tree)
    np.testing.assert_array_equal(back["a"].numpy(), np.arange(3.0))


def test_checkpoint_step(tmp_path):
    assert checkpoint_step(str(tmp_path / "missing")) is None
    save_checkpoint(str(tmp_path / "nostep"), {"a": torch.zeros(2)})
    assert checkpoint_step(str(tmp_path / "nostep")) is None
    save_checkpoint(str(tmp_path / "step"), {"a": torch.zeros(2)}, step=300)
    assert checkpoint_step(str(tmp_path / "step")) == 300


def test_structure_record_matches_the_reference(tmp_path):
    """The same tree, as tensors and as JAX arrays, gives the same record
    (paths in flatten order, shapes and dtypes)."""
    from stheno_tpu.inference.hmc import ChainState as JChainState

    rng = np.random.default_rng(3)
    arrays = [rng.normal(size=s) for s in ((2, 3), (2,), (2, 3), (2,), (2, 3))]
    nested = {"z": [rng.normal(size=2), rng.normal(size=(1, 2))], "a": rng.normal(size=4)}
    for j_tree, t_tree in (
            (JChainState(*map(jnp.asarray, arrays)), ChainState(*map(torch.as_tensor, arrays))),
            ({"z": [jnp.asarray(a) for a in nested["z"]], "a": jnp.asarray(nested["a"])},
             {"z": [torch.as_tensor(a) for a in nested["z"]], "a": torch.as_tensor(nested["a"])})):
        assert tc._structure_record(t_tree) == jc._structure_record(j_tree)
    save_checkpoint(str(tmp_path / "c"), ChainState(*map(torch.as_tensor, arrays)))
    with open(os.path.join(tmp_path, "c", "meta.json")) as fh:
        assert [e["path"] for e in json.load(fh)["structure"]] == [".q", ".logp", ".grad", ".eps",
                                                                   ".inv_mass"]
