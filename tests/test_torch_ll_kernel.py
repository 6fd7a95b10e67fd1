"""The per-modality mixture log-likelihoods (ops/ll_kernel.py): the route
rule (`ctm_base._ll_route`), the `lls.kernel` and `lls.plain` counters, the
plain route bit for bit against the expression it took over, the wrapper's
checks and its launch geometry, on the CPU. Then, on a card, the CUDA
kernel against the float64 plain expression at the cells' shapes and at
the largest the wrapper takes, its zero-count, NaN-lane and zero-mixture
semantics, its repeat and graph-replay bits, its launches, and a fit's
route.

The card tests are marked `cuda` and skip without a card. The file imports
no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_ll_kernel.py -m cuda --noconftest -o addopts="" -p no:cacheprovider

Tolerance on the card: rtol 1e-6 on each (lane, modality) sum against the
float64 expression on the same float32 inputs, half of `correct`'s
`step_ll` limit (2e-6, portbench/configs): the kernel forms each mixture
with K fused multiply-adds and takes full-precision logf, about 1e-7 of
each term, and sums in float64."""

import math

import numpy as np
import pytest
import torch

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base
from multimodalmusig_tpu_torch.models import mmctm as tm
from multimodalmusig_tpu_torch.ops import ll_kernel as llk
from multimodalmusig_tpu_torch.ops.special import safe_xlogy
from multimodalmusig_tpu_torch.utils import graphs, profiling

torch.set_num_threads(2)

RTOL = 1e-6

BRCA = ((7, 7), (96, 48))
PCAWG = ((7, 7, 5), (96, 48, 83))


def _inputs(seed, R, D, K, V, dtype=torch.float32, device="cpu"):
    """Random counts with about a third of the cells zero, softmax props
    and row-normalized ϕ, per modality."""
    rng = np.random.default_rng(seed)
    X, props, phi = [], [], []
    for k, v in zip(K, V):
        counts = rng.poisson(3.0, (D, v)) * (rng.random((D, v)) > 0.3)
        X.append(counts.astype(np.float64))
        props.append(torch.softmax(torch.as_tensor(rng.standard_normal((R, D, k)) * 2.0), -1))
        g = rng.gamma(0.5, 1.0, (R, k, v)) + 1e-3
        phi.append(torch.as_tensor(g / g.sum(-1, keepdims=True)))

    def cast(ts):
        return [torch.as_tensor(t).to(dtype=dtype, device=device) for t in ts]

    return cast(X), cast(props), cast(phi)


def _replaced_expression(X, props, phi):
    """`mmctm.modality_loglikelihoods` as it was before the route: the
    expression the plain route keeps."""
    M = len(X)
    sums = [safe_xlogy(X[m], props[m] @ phi[m]).sum(dim=(-2, -1)) for m in range(M)]
    return torch.stack([sums[m] / X[m].sum() for m in range(M)], dim=-1)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_type, dtype, K, V, route", [
    ("cpu", torch.float32, (7, 7), (96, 48), "plain"),
    ("cpu", torch.float64, (7, 7), (96, 48), "plain"),
    ("cuda", torch.float64, (7, 7), (96, 48), "plain"),
    ("cuda", torch.float32, (7, 7), (96, 48), "kernel"),
    ("cuda", torch.float32, (7, 7, 5), (96, 48, 83), "kernel"),
    ("cuda", torch.float32, (128,), (128,), "kernel"),
    ("cuda", torch.float32, (129, 7), (96, 48), "plain"),
    ("cuda", torch.float32, (7, 7), (96, 129), "plain"),
    ("cuda", torch.float32, (1,) * 16, (5,) * 16, "kernel"),
    ("cuda", torch.float32, (1,) * 17, (5,) * 17, "plain"),
])
def test_the_route_depends_on_device_dtype_and_the_kernels_limits(device_type, dtype, K, V,
                                                                  route):
    assert ctm_base._ll_route(device_type, dtype, K, V) == route


@pytest.mark.parametrize("shapes", [BRCA, PCAWG], ids=["brca", "pcawg"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_plain_route_keeps_the_bits_of_the_expression_it_replaces(shapes, dtype):
    X, props, phi = _inputs(7, 3, 41, *shapes, dtype=dtype)
    got = tm.modality_loglikelihoods(X, props, phi)
    assert got.dtype == dtype and got.shape == (3, len(X))
    assert torch.equal(got, _replaced_expression(X, props, phi))
    sums = torch.stack(llk.mixture_lls_plain(X, props, phi), dim=-1)
    assert torch.equal(sums / torch.stack([x.sum() for x in X]), got)


def test_the_counters_count_each_call_once_by_its_route(monkeypatch):
    X, props, phi = _inputs(1, 2, 9, *BRCA)
    profiling.reset()
    try:
        with profiling.tracing():
            for _ in range(3):
                tm.modality_loglikelihoods(X, props, phi)
            counts = dict(profiling.totals()["counts"])
            assert counts.get("lls.plain") == 3 and "lls.kernel" not in counts
            # a call routed to the kernel counts as such and reaches the
            # wrapper (a stand-in here, as the kernel runs only on a card)
            calls = []

            def kernel(*args):
                calls.append(args)
                return torch.stack(llk.mixture_lls_plain(*args), dim=-1)

            monkeypatch.setattr(ctm_base, "_ll_route", lambda *a: "kernel")
            monkeypatch.setattr(llk, "mixture_lls", kernel)
            got = tm.modality_loglikelihoods(X, props, phi)
            counts = profiling.totals()["counts"]
            assert counts["lls.kernel"] == 1 and counts["lls.plain"] == 3 and len(calls) == 1
        assert torch.equal(got, _replaced_expression(X, props, phi))
        tm.modality_loglikelihoods(X, props, phi)  # not recording: not counted
        assert profiling.totals()["counts"]["lls.kernel"] == 1 and len(calls) == 2
    finally:
        profiling.reset()


class _Replay:
    """A CUDA graph's semantics on the CPU (tests/test_torch_lane_freeze.py):
    each replay runs the chain again on the capture's inputs and writes its
    outputs into the capture's outputs."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        on, profiling.ON = profiling.ON, False  # a real replay runs no Python
        try:
            for o, n in zip(graphs.leaves(self.out), graphs.leaves(self.fn(*self.args))):
                if o is not n:
                    o.copy_(n)
        finally:
            profiling.ON = on

    def reset(self):
        self.fn = self.args = self.out = None


def test_a_graphed_tail_counts_its_lls_at_capture_and_not_at_replay(monkeypatch):
    def record(fn, args, device):
        out = fn(*args)
        return _Replay(fn, args, out), out

    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_record", record)
    rng = np.random.default_rng(0)
    docs = [[mt.make_count_matrix(rng.poisson(2.0, v).astype(np.float64)) for v in (10, 8)]
            for _ in range(20)]
    model = mt.MMCTM([2, 3], [0.1, 0.1], [10, 8], docs, device="cpu")
    state = tm.init_with_alpha(torch.Generator().manual_seed(1), model.config, model.Xdense,
                               [0.1, 0.1], restarts=4, device="cpu")
    X = model.Xdense
    step = tm.fit_step_fn(X, ctm_base.counts_per_doc(X), model.config)
    carry = ctm_base.make_cavi_carry(state, model.config, 12)
    profiling.reset()
    try:
        with profiling.tracing():
            ctm_base.run_cavi_from(carry, 12, 0.0, step)
        counts = profiling.totals()["counts"]
    finally:
        profiling.reset()
    steps = counts["loop.steps"]
    assert steps >= 3 and counts["graph.captures.tail"] == 1
    assert counts["graph.replays.tail"] == steps - 2
    # the warm-up step and the capture
    assert counts["lls.plain"] == 2 and "lls.kernel" not in counts


def _meta(t):
    return t.to("meta")


@pytest.mark.parametrize("case", ["props 2-D", "X rows", "phi shape", "lists", "no modality",
                                  "cpu", "device", "mixed devices", "dtype", "K limit",
                                  "V limit", "M limit"])
def test_the_wrappers_checks_raise(case):
    X, props, phi = _inputs(2, 2, 8, *BRCA)
    meta = [list(map(_meta, ts)) for ts in (X, props, phi)]
    err = ValueError
    if case == "props 2-D":
        props = [p[0] for p in props]
    elif case == "X rows":
        X = [X[0][:-1], X[1]]
    elif case == "phi shape":
        phi = [phi[0][:, :, :-1], phi[1]]
    elif case == "lists":
        phi = phi[:1]
    elif case == "no modality":
        X, props, phi = [], [], []
    elif case == "cpu":  # the plain version's, never the kernel's
        pass
    elif case == "device":  # a device other than the CPU and CUDA
        X, props, phi = meta
    elif case == "mixed devices":
        X, props, phi = X, meta[1], meta[2]
    elif case == "dtype":
        X, props, phi = ([t.double() for t in ts] for ts in meta)
        err = TypeError
    elif case == "K limit":
        X, props, phi = (list(map(_meta, ts)) for ts in _inputs(2, 1, 4, (129,), (5,)))
    elif case == "V limit":
        X, props, phi = (list(map(_meta, ts)) for ts in _inputs(2, 1, 4, (3,), (129,)))
    elif case == "M limit":
        X, props, phi = (list(map(_meta, ts)) for ts in _inputs(2, 1, 4, (1,) * 17, (2,) * 17))
    with pytest.raises(err):
        llk.mixture_lls(X, props, phi)


@pytest.mark.parametrize("R, D, M", [(100, 560, 2), (1000, 560, 2), (100, 2780, 3), (1, 560, 2),
                                     (1, 2780, 3), (3, 37, 1), (64, 112, 2), (7, 1, 1)])
def test_the_launch_geometry_covers_the_documents_and_lanes(R, D, M):
    geo = llk.launch_geometry(R, D, M)
    docs = geo.docs_per_block
    assert docs % 4 == 0 and 4 <= docs <= llk.MAX_BLOCK_DOCS
    lanes, blocks, m = geo.grid  # one restart lane a block
    assert lanes == R and m == M
    assert blocks == -(-D // docs) and (blocks - 1) * docs < D <= blocks * docs
    # the fewest blocks of at most MAX_BLOCK_DOCS documents, evenly filled
    assert blocks == -(-D // llk.MAX_BLOCK_DOCS) and blocks * docs - D < 4 * blocks


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ll kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _float64_sums(X, props, phi):
    return torch.stack(llk.mixture_lls_plain([t.double() for t in X], [t.double() for t in props],
                                             [t.double() for t in phi]), dim=-1)


def _assert_close(got, want):
    want = want.to(got.device)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    rel = ((got.double() - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    assert rel <= RTOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("R, D, shapes", [
    (100, 560, BRCA), (1000, 560, BRCA), (100, 2780, PCAWG), (1, 560, BRCA), (1, 2780, PCAWG),
    (3, 37, ((128, 1), (128, 7))), (2, 130, ((64, 128), (5, 33))), (5, 3, ((2,), (3,))),
])
def test_kernel_matches_the_float64_expression(cuda, R, D, shapes):
    X, props, phi = _inputs(R * D, R, D, *shapes, device=cuda)
    before = llk.LAUNCHES
    got = llk.mixture_lls(X, props, phi)
    assert llk.LAUNCHES == before + 1
    _assert_close(got, _float64_sums(X, props, phi))


@pytest.mark.cuda
def test_kernel_at_the_largest_shapes_the_wrapper_takes(cuda):
    K, V = (llk.LL_MAX_K,) * 2, (llk.LL_MAX_V,) * 2
    X, props, phi = _inputs(11, 9, 300, K, V, device=cuda)
    _assert_close(llk.mixture_lls(X, props, phi), _float64_sums(X, props, phi))
    X, props, phi = _inputs(12, 2, 20, (1,) * llk.LL_MAX_M, (3,) * llk.LL_MAX_M, device=cuda)
    _assert_close(llk.mixture_lls(X, props, phi), _float64_sums(X, props, phi))


@pytest.mark.cuda
def test_kernel_keeps_safe_xlogys_semantics(cuda):
    R, D = 6, 150
    X, props, phi = _inputs(5, R, D, *PCAWG, device=cuda)
    X[0][17] = 0.0                       # a document with no counts in modality 0
    X[1].zero_()                         # a modality with no counts at all
    clean = llk.mixture_lls(X, props, phi)
    _assert_close(clean[:, 0], _float64_sums(X, props, phi)[:, 0])
    assert torch.equal(clean[:, 1], torch.zeros(R, device=cuda))
    # a dead lane: NaN props give NaN where the lane has counts, and leave
    # every other lane's bits alone
    for p in props:
        p[2] = float("nan")
    dead = llk.mixture_lls(X, props, phi)
    assert torch.isnan(dead[2, 0]) and torch.isnan(dead[2, 2]) and dead[2, 1] == 0
    keep = torch.arange(R, device=cuda) != 2
    assert torch.equal(dead[keep], clean[keep])
    # a zero mixture at a nonzero count gives −inf
    v = int(torch.nonzero(X[2][5]).flatten()[0])
    phi[2][4, :, v] = 0.0
    zero = llk.mixture_lls(X, props, phi)
    assert zero[4, 2].item() == -math.inf
    assert torch.equal(zero[4, :2], clean[4, :2])


@pytest.mark.cuda
def test_kernel_repeats_its_bits(cuda):
    X, props, phi = _inputs(3, 100, 2780, *PCAWG, device=cuda)
    a = llk.mixture_lls(X, props, phi)
    b = llk.mixture_lls(X, props, phi)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    # a lane's bits do not depend on the lanes beside it
    c = llk.mixture_lls(X, [p[:7] for p in props], [f[:7] for f in phi])
    assert torch.equal(c, a[:7])


@pytest.mark.cuda
def test_a_graph_replay_equals_the_eager_call(cuda):
    X, props, phi = map(tuple, _inputs(4, 100, 560, *BRCA, device=cuda))
    fn = tm.modality_loglikelihoods
    with graphs.segment(cuda) as seg:
        chain = seg.chain("ll", fn)
        eager = fn(X, props, phi)
        chain.warm = True
        captured = chain(X, props, phi).clone()
        assert chain.graph is not None
        # new inputs are copied into the capture's and replayed
        X2, props2, phi2 = map(tuple, _inputs(8, 100, 560, *BRCA, device=cuda))
        replayed = chain(X2, props2, phi2).clone()
        torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert torch.equal(replayed, fn(X2, props2, phi2))


@pytest.mark.cuda
def test_a_call_is_two_device_kernels(cuda):
    X, props, phi = _inputs(6, 100, 560, *BRCA, device=cuda)
    llk.mixture_lls(X, props, phi)  # built and loaded
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            llk.mixture_lls(X, props, phi)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "mixture_ll" in e.name
             and e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("mixture_ll_kernel" in n for n in names) == 3, names
    assert sum("mixture_ll_finish" in n for n in names) == 3, names


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take_on_the_card(cuda):
    X, props, phi = _inputs(2, 2, 8, *BRCA, device=cuda)
    with pytest.raises(TypeError):
        llk.mixture_lls(X, [p.double() for p in props], phi)
    X2, props2, phi2 = _inputs(2, 2, 8, (129,), (4,), device=cuda)
    with pytest.raises(ValueError):
        llk.mixture_lls(X2, props2, phi2)
    with pytest.raises(ValueError):
        llk.mixture_lls([x.cpu() for x in X], props, phi)


@pytest.mark.cuda
def test_a_fit_on_the_card_takes_the_kernel_every_step(cuda):
    rng = np.random.default_rng(0)
    docs = [[mt.make_count_matrix(rng.poisson(3.0, v).astype(np.float64)) for v in (96, 48)]
            for _ in range(60)]
    profiling.reset()
    try:
        with profiling.tracing():
            mt.fit_mmctm_restarts([7, 7], [0.1, 0.1], docs, [96, 48], restarts=8, maxiter=20)
        counts = profiling.totals()["counts"]
    finally:
        profiling.reset()
    assert counts.get("lls.kernel", 0) > 0 and "lls.plain" not in counts
