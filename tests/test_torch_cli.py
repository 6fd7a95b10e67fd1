"""The port's CLI, `python -m multimodalmusig_tpu_torch.cli`, on the CPU:
a subprocess run on the bundled BRCA-EU counts with every output (the
checkpoint read by both packages, the TSVs parsed), the refusal to fall back
to the CPU without a card, the argument errors, sample alignment by name and
`--auto-compact` with `--progress`."""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodalmusig_tpu.utils import io as jio
from multimodalmusig_tpu.utils.hermetic import scrubbed_env

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch import cli
from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

from conftest import requires_brca_data

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("model.npz", "mean.tsv", "cov.tsv", "cor.tsv", "sigs.tsv", "props.tsv")


def _table(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    return rows[0], rows[1:]


def _output_args(directory):
    return [a for name in OUTPUTS
            for a in (f"--{name.split('.')[0]}", str(directory / name))]


@requires_brca_data
def test_cli_subprocess_on_the_bundled_counts(tmp_path):
    """Best-of-4 at K = (7, 7), 30 iterations per stage, on the CPU: rc 0,
    each stage reported once (no boundary without a schedule), and every
    output parses."""
    snv, sv = (mt.brca_counts_path(f) for f in ("brca-eu_snv_counts.tsv",
                                                "brca-eu_sv_counts.tsv"))
    env = scrubbed_env()
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "multimodalmusig_tpu_torch.cli", snv, sv, "-k", "7", "7",
         "-m", "SNV", "SV", "--device", "cpu", "--restarts", "4", "--maxiter", "30",
         "--progress", "--verbose", *_output_args(tmp_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "each is reported once, when it ends" in proc.stderr
    progress = [line for line in proc.stderr.splitlines() if "restarts completed" in line]
    assert progress == ["run-mmctm: stage 1: 4/4 restarts completed",
                        "run-mmctm: stage 2: 1/1 restarts completed"]
    assert "Log-likelihoods: [" in proc.stdout

    counts, terms, samples = zip(*(read_counts_tsv(f) for f in (snv, sv)))
    MK = 14
    assert np.loadtxt(tmp_path / "mean.tsv").shape == (MK,)
    cov, cor = np.loadtxt(tmp_path / "cov.tsv"), np.loadtxt(tmp_path / "cor.tsv")
    assert cov.shape == cor.shape == (MK, MK)
    np.testing.assert_allclose(np.diag(cor), 1.0, rtol=1e-6)

    head, rows = _table(tmp_path / "sigs.tsv")
    assert head == ["modality", "topic", "value", "term", "probability"]
    assert len(rows) == 7 * 96 + 7 * 48
    assert [r[3] for r in rows[:96]] == list(terms[0]) and rows[-1][3] == terms[1][-1]
    sums = {}
    for mod, k, _, _, p in rows:
        sums[(mod, k)] = sums.get((mod, k), 0.0) + float(p)
    np.testing.assert_allclose(list(sums.values()), 1.0, rtol=1e-12)

    head, rows = _table(tmp_path / "props.tsv")
    assert head == ["topic"] + list(samples[0])
    assert [r[0] for r in rows] == [f"{m}-{k}" for m in ("SNV", "SV") for k in range(1, 8)]
    props = np.array([[float(x) for x in r[1:]] for r in rows])
    np.testing.assert_allclose(props[:7].sum(axis=0), 1.0, rtol=1e-6)
    np.testing.assert_allclose(props[7:].sum(axis=0), 1.0, rtol=1e-6)

    port = mt.load_model(str(tmp_path / "model.npz"), device="cpu")
    ref = jio.load_model(str(tmp_path / "model.npz"))
    assert port.K == ref.K == [7, 7] and port.D == ref.D == 560
    assert port.ll == ref.ll and np.isfinite(port.ll).all()
    np.testing.assert_array_equal(port.state.lam[0].numpy(), np.asarray(ref.state.lam))
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "mean.tsv"), port.mu)


def _tiny_tsvs(directory, order=None, drop=None):
    """Two count files over 8 samples, the second's columns in `order` and
    without sample `drop`."""
    rng = np.random.default_rng(4)
    names = [f"s{i}" for i in range(8)]
    paths = []
    for m, V in enumerate((6, 5)):
        counts = rng.poisson(4.0, (V, 8))
        cols = list(range(8)) if m == 0 or order is None else list(order)
        cols = [c for c in cols if m == 0 or names[c] != drop]
        path = directory / f"m{m}.tsv"
        with open(path, "w") as f:
            f.write("\t".join(["term"] + [names[c] for c in cols]) + "\n")
            for v in range(V):
                f.write("\t".join([f"t{m}_{v}"] + [str(counts[v, c]) for c in cols]) + "\n")
        paths.append(str(path))
    return paths


def _run(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


BASE = ["-k", "2", "2", "-m", "A", "B", "--device", "cpu", "--restarts", "2", "--maxiter", "6"]


def test_cuda_without_a_card_exits_and_names_the_cpu_flag(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = _tiny_tsvs(tmp_path)
    rc, _, err = _run(paths + ["-k", "2", "2", "-m", "A", "B", "--props",
                               str(tmp_path / "p.tsv")], capsys)
    assert rc != 0 and "--device cpu" in err
    assert not (tmp_path / "p.tsv").exists()
    assert cli.build_parser().get_default("device") == "cuda"


@pytest.mark.parametrize("extra, message", [
    (["--chunk-iters", "5", "--compact-at", "3"], "mutually exclusive"),
    (["--auto-compact", "--compact-at", "3"], "mutually exclusive"),
    (["--auto-compact", "--chunk-iters", "5"], "mutually exclusive"),
    (["-k", "2"], "Number of count files must match"),
    (["-m", "A"], "Number of modality labels must match"),
], ids=["chunk and compact", "auto and compact", "auto and chunk", "k count", "labels"])
def test_argument_errors_return_1(tmp_path, capsys, extra, message):
    rc, _, err = _run(_tiny_tsvs(tmp_path) + BASE + extra, capsys)
    assert rc == 1 and message in err


def test_samples_are_aligned_by_name(tmp_path, capsys):
    """A second file with its sample columns shuffled gives the same
    proportions as one in the first file's order; a missing sample is an
    error that names it."""
    outs = []
    for name, order in (("aligned", None), ("shuffled", [3, 0, 7, 1, 6, 2, 5, 4])):
        d = tmp_path / name
        d.mkdir()
        rc, _, err = _run(_tiny_tsvs(d, order) + BASE + ["--props", str(d / "props.tsv")],
                          capsys)
        assert rc == 0, err
        outs.append((d / "props.tsv").read_bytes())
    assert outs[0] == outs[1]
    rc, _, err = _run(_tiny_tsvs(tmp_path, drop="s5") + BASE, capsys)
    assert rc == 1 and "missing sample columns ['s5']" in err


def test_auto_compact_reports_its_schedule_and_progress(tmp_path, capsys):
    rc, _, err = _run(_tiny_tsvs(tmp_path) + ["-k", "2", "2", "-m", "A", "B", "--device", "cpu",
                                              "--restarts", "8", "--pilot-restarts", "3",
                                              "--maxiter", "12", "--auto-compact", "--progress"],
                      capsys)
    assert rc == 0, err
    assert "run-mmctm: auto-compact schedule (" in err
    progress = [line for line in err.splitlines() if "restarts completed" in line]
    assert progress[0] == "run-mmctm: stage 1: 3/8 restarts completed"
    assert "run-mmctm: stage 1: 8/8 restarts completed" in progress
    assert progress[-1] == "run-mmctm: stage 2: 1/1 restarts completed"
    assert "each is reported once" not in err
