"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with a CUDA
card. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `checks`: each compared number with its limit); the checks are
also the last lines of standard error. Without a card, without the
package under test, or if the run loads JAX or the JAX package, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "multimodalmusig_tpu_torch"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if importlib.util.find_spec(PACKAGE) is None:
        print(f"portbench: the package under test ({PACKAGE}) is not in this checkout",
              file=sys.stderr)
        return 4
    # one process, one host thread: the card does the work, and idle
    # worker threads only add noise to the host's dispatch
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")

    import torch

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

    from . import harness, spec

    resolved = spec.resolve(spec.load_benchmark(ROOT), args.workload)
    chips = int(resolved["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(resolved, args.seed, args.seconds, args.trace,
                                  device="cuda", t_start=T_START)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 5
    for name, (value, limit) in result["checks"].items():
        verdict = "ok" if None not in (value, limit) and value <= limit else "FAIL"
        print(f"check {name} {value!r} limit {limit!r} {verdict}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
