"""The port's profiling utilities (utils/profiling.py) on the CPU: the
Chrome trace with a named span, the NaN check that names the operation and
ends with its block, `check_finite` against the JAX package's on the same
NaN-holding state, and the timer."""

import json
import os

import numpy as np
import pytest
import torch

from multimodalmusig_tpu.utils import profiling as jprof

from multimodalmusig_tpu_torch.models import mmctm as tm
from multimodalmusig_tpu_torch.parallel import _ranks
from multimodalmusig_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    logdir = os.path.join(tmp_path, "trace")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("cavi-step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "cavi-step" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "cavi-step" for e in prof.key_averages())


def test_debug_nans_names_the_op_and_ends_with_its_block():
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match=r"aten\.div.*1 NaN values.*\(2,\)"):
        with profiling.debug_nans():
            x / x
    assert torch.isnan(x / x).sum() == 1  # the check ended with the block
    with profiling.debug_nans(enable=False):
        assert torch.isnan(x / x).sum() == 1
    with profiling.debug_nans():  # finite work passes through untouched
        assert torch.equal(x + 1, torch.tensor([1.0, 2.0]))


def _state():
    config = tm.MMCTMConfig(K=(2, 3), V=(4, 5), D=6, dtype=torch.float64)
    X = tuple(torch.ones(6, v, dtype=torch.float64) for v in config.V)
    return tm.init_with_alpha(torch.Generator().manual_seed(0), config, X, [0.1, 0.1],
                              restarts=2, device="cpu")


@pytest.mark.parametrize("field, index", [("gamma", 1), ("lam", None), ("Sigma", None)])
def test_check_finite_names_the_leaf_as_the_jax_function_does(field, index):
    """The same NaN-holding state (a NamedTuple of tensors, and of numpy
    arrays for the JAX function) gives the same message in both packages."""
    state = _state()
    profiling.check_finite(state)
    leaf = getattr(state, field)
    bad = leaf[index] if index is not None else leaf
    bad[0, 0, 0] = float("nan")
    bad[1, -1, -1] = float("inf")
    with pytest.raises(FloatingPointError) as got:
        profiling.check_finite(state, "model")
    with pytest.raises(FloatingPointError) as want:
        jprof.check_finite(_ranks.tree_map(lambda t: t.numpy(), state), "model")
    assert str(got.value) == str(want.value)
    assert f"model.{field}" in str(got.value) and ": 2/" in str(got.value)


def test_check_finite_ignores_integer_and_boolean_leaves():
    profiling.check_finite({"n": torch.tensor([1, 2]), "done": torch.tensor([True]),
                            "ll": np.array([-1.0])})


def test_timer_measures_the_block():
    with profiling.Timer() as t:
        torch.ones(128, 128) @ torch.ones(128, 128)
    with profiling.Timer(torch.ones(1)) as t2:
        pass
    assert t.elapsed > 0 and t2.elapsed >= 0 and t2.device.type == "cpu"
