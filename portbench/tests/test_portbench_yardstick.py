"""The benchmark's frozen counts equal chip_smoke.py's, at the shapes of
PERF.md's kernel tables."""

import importlib.util
import os

import pytest

from portbench import spec, yardstick


@pytest.fixture(scope="module")
def smoke():
    path = os.path.join(spec.ROOT, "chip_smoke.py")
    s = importlib.util.spec_from_file_location("chip_smoke_for_yardstick", path)
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


ETA = [(100, 560, (7, 7), 3, 4, 1, 4), (1000, 560, (7, 7), 3, 4, 1, 4),
       (100, 2800, (7, 7, 5), 3, 4, 1, 4), (100, 560, (20, 20), 3, 4, 1, 4),
       (1, 560, (20, 20), 7, 10, 2, 8), (100, 560, (64, 64), 3, 4, 1, 4)]
THETA = [(100, 560, 96, 7), (100, 560, 48, 7), (100, 560, 96, 20), (100, 560, 96, 64),
         (100, 560, 96, 128), (1000, 560, 96, 20), (100, 2800, 96, 20), (1, 560, 96, 20)]


@pytest.mark.parametrize("args", ETA)
def test_eta_bound(smoke, args):
    assert yardstick.eta_bound(*args) == smoke.eta_bound(*args)
    assert yardstick.eta_bound(*args, lam_prev=True) == smoke.eta_bound(*args, lam_prev=True)


@pytest.mark.parametrize("args", THETA)
def test_theta_bound(smoke, args):
    assert yardstick.theta_bound(*args) == smoke.theta_bound(*args)


@pytest.mark.parametrize("MK", [14, 19, 32, 40, 128])
def test_solve_flops(smoke, MK):
    assert yardstick.solve_flops(MK, 3, 4, 1) == smoke.solve_flops(MK, 3, 4, 1)
    assert yardstick.bound(1e6, 1e9) == smoke.bound(1e6, 1e9)
    assert (yardstick.PEAK_F32_FLOPS, yardstick.PEAK_BYTES_PER_S) == (
        smoke.PEAK_F32_FLOPS, smoke.PEAK_BYTES_PER_S)


def test_bound_at_the_published_shapes():
    """PERF.md's B3 and B4 bounds at the BRCA shape, in ms."""
    assert yardstick.eta_bound(100, 560, (7, 7), 3, 4, 1, 4)[0] == pytest.approx(0.013936, abs=5e-7)
    ms, by = yardstick.theta_bound(100, 560, 96, 7)
    assert ms == pytest.approx(0.003464, abs=5e-7) and by == "operations"


def test_step_flops_counts_the_kernels():
    budgets = {"n_iter": 3, "cg_iter": 4, "polish_iter": 1, "nu_n_iter": 4}
    per_lane = yardstick.step_flops_per_lane(560, (7, 7), (96, 48), budgets)
    kernels = (yardstick.eta_flops(1, 560, (7, 7), **budgets)
               + yardstick.theta_flops(1, 560, 96, 7) + yardstick.theta_flops(1, 560, 48, 7))
    assert kernels < per_lane < 1.2 * kernels



def test_a_step_is_credited_at_the_frozen_budgets():
    assert yardstick.STEP_BUDGETS == {"n_iter": 3, "cg_iter": 4, "polish_iter": 1,
                                      "nu_n_iter": 4}
    assert (yardstick.step_flops_per_lane(2780, (7, 7, 5), (96, 48, 83))
            == yardstick.step_flops_per_lane(2780, (7, 7, 5), (96, 48, 83),
                                             yardstick.STEP_BUDGETS))
