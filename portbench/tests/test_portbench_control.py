"""The control on the card: the reference put in the program's place one
precision below it comes out as not correct, where the program's own run
is correct. At the BRCA configuration's published sizes (D = 560, K = (7,
7)) with 16 restarts, a size that a test run holds; the cells' own sizes
are read by `python3 -m portbench.readings --control` (PERF.md).

    python3 -m pytest portbench/tests -m cuda"""

import numpy as np
import pytest

from portbench import check, corpus, harness, spec
from portbench.instrument import Recorder


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483711, 2147483712, 2147483713])
def test_the_control_is_not_correct(cuda_card, seed, tmp_path):
    bench = spec.load_benchmark()
    r = spec.resolve(bench, "brca_mmctm_k7.two_stage_r100")
    config, entry = r["config"], r["entry"]
    traffic = dict(r["traffic"], kwargs={"restarts": 16})
    prog = harness.program(entry)
    recorder = Recorder(prog, entry.HOOKS)
    recorder.install()
    try:
        data = corpus.load(config)
        job = entry.Job(prog, config, traffic, data, str(tmp_path), "cuda", recorder.span)
        recorder.begin_fit(np.random.default_rng(seed))
        assert job.run(harness.fit_seed(seed, 0))
        sample = recorder.end_fit()
    finally:
        recorder.uninstall()
    program = check.numbers(entry, [sample], data["X"], config, "cuda")
    control = check.numbers(entry, [sample], data["X"], config, "cuda", control=True)
    required = check.required(entry)
    assert check.judge(program, config["limits"], required)[0], program
    assert not check.judge(control, config["limits"], required)[0], control
