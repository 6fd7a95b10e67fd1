"""Checkpoints and TSV writers of the PyTorch port against the JAX package's
(multimodalmusig_tpu/utils/io.py), in float64 on the reference's MMCTM and
IMMCTM fixture (tests/test_immctm.py).

Each package loads the other's checkpoint with the states equal to the last
bit (the .npz holds float64 arrays either way). A fit resumed from a
checkpoint follows the JAX package's resumed fit at rtol 1e-10, the
trajectory standard of tests/test_trajectory_oracle.py. The mean, cov and
cor files are byte-identical to the JAX writers'; the signature and
proportion tables have the same headers and labels and values equal to
rtol 1e-12, all written from the same float64 state."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models.ilda import ILDA as JaxILDA
from multimodalmusig_tpu.models.immctm import IMMCTM as JaxIMMCTM
from multimodalmusig_tpu.models.lda import LDA as JaxLDA
from multimodalmusig_tpu.models.mmctm import MMCTM as JaxMMCTM
from multimodalmusig_tpu.utils import io as jio

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.utils import io as tio

from test_immctm import ALPHA, FEATURES, K, X

torch.set_num_threads(2)

KINDS = ["MMCTM", "IMMCTM"]


def _leaves(state):
    """Every array of a (nested) state, in field order."""
    if isinstance(state, tuple):
        return [leaf for x in state for leaf in _leaves(x)]
    return [state]


def _assert_same_state(port_state, jax_state):
    """The port's one-lane state against a JAX state: equal, with the lane
    dimension the only difference."""
    assert type(port_state)._fields == type(jax_state)._fields
    got, want = _leaves(port_state), _leaves(jax_state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == (1,) + tuple(np.shape(w))
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def jax_models():
    """The JAX package's models, 5 iterations into their fits."""
    mm = JaxMMCTM(K, ALPHA, X)
    mm.fit(maxiter=5, verbose=False)
    im = JaxIMMCTM(K, ALPHA, FEATURES, X)
    im.fit(maxiter=5, verbose=False)
    assert mm.config.dtype == jnp.float64 and im.config.dtype == jnp.float64
    return {"MMCTM": mm, "IMMCTM": im}


def _port_model(kind):
    if kind == "MMCTM":
        return mt.MMCTM(K, ALPHA, X, dtype=torch.float64, device="cpu")
    return mt.IMMCTM(K, ALPHA, FEATURES, X, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, jax_models, kind):
    jm = jax_models[kind]
    path = str(tmp_path / "model.npz")
    jio.save_model(path, jm)
    pm = mt.load_model(path, device="cpu")
    assert type(pm).__name__ == kind and pm.device.type == "cpu"
    assert pm.config.dtype == torch.float64
    assert (pm.K, pm.V, pm.alpha) == (jm.K, jm.V, jm.alpha)
    assert (pm.converged, pm.elbo, pm.ll) == (jm.converged, jm.elbo, list(jm.ll))
    for p_doc, j_doc in zip(pm.X, jm.X):
        for p, j in zip(p_doc, j_doc):
            np.testing.assert_array_equal(p, j)
    _assert_same_state(pm.state, jm.state)


@pytest.mark.parametrize("kind", KINDS)
def test_resumed_fit_follows_the_resumed_jax_fit(tmp_path, jax_models, kind):
    """A checkpoint taken 5 iterations into a JAX fit, resumed for 3 more in
    each package."""
    path = str(tmp_path / "model.npz")
    jio.save_model(path, jax_models[kind])
    jm = jio.load_model(path)
    want = jm.fit(maxiter=3, verbose=False)
    pm = mt.load_model(path, device="cpu")
    got = pm.fit(maxiter=3)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(pm.ll, jm.ll, rtol=1e-10)
    np.testing.assert_allclose(pm.elbo, jm.elbo, rtol=1e-10)
    np.testing.assert_allclose(pm.state.lam[0].numpy(), np.asarray(jm.state.lam), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_loads_in_jax_and_in_the_port(tmp_path, kind):
    pm = _port_model(kind)
    pm.fit(maxiter=5)
    path = str(tmp_path / "model.npz")
    mt.save_model(path, pm)
    jm = jio.load_model(path)
    assert type(jm).__name__ == kind and jm.config.dtype == jnp.float64
    assert (jm.K, jm.V, jm.alpha) == (pm.K, pm.V, pm.alpha)
    assert (jm.converged, jm.elbo, jm.ll) == (pm.converged, pm.elbo, pm.ll)
    _assert_same_state(pm.state, jm.state)
    again = mt.load_model(path, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(again.state), _leaves(pm.state)))


def test_float32_checkpoint_keeps_its_dtype(tmp_path):
    pm = mt.MMCTM(K, ALPHA, X, device="cpu")
    path = str(tmp_path / "model.npz")
    mt.save_model(path, pm)
    assert jio.load_model(path).config.dtype == jnp.float32
    loaded = mt.load_model(path, device="cpu")
    assert loaded.config.dtype == torch.float32 and loaded.state.lam.dtype == torch.float32
    assert not loaded.converged and loaded.ll is None


@pytest.mark.parametrize("make", [
    lambda: JaxLDA(2, 0.1, 0.1, [np.array([[1, 5], [2, 8]]), np.array([[1, 2], [2, 5]])]),
    lambda: JaxILDA(2, 0.1, 0.1, FEATURES[0],
                    [np.array([[1, 5], [2, 8]]), np.array([[1, 2], [2, 5]])]),
], ids=["LDA", "ILDA"])
def test_lda_and_ilda_checkpoints_wait_for_their_port(tmp_path, make):
    """The port has LDA and ILDA now: a JAX checkpoint of either loads as
    the port's model with the same state (tests/test_torch_lda.py and
    tests/test_torch_ilda.py hold the cross-loads of fitted models); any
    other object still cannot be checkpointed."""
    path = str(tmp_path / "model.npz")
    jm = make()
    jio.save_model(path, jm)
    pm = mt.load_model(path, device="cpu")
    assert type(pm).__name__ == type(jm).__name__ and pm.device.type == "cpu"
    _assert_same_state(pm.state, jm.state)
    with pytest.raises(TypeError, match="cannot checkpoint"):
        mt.save_model(path, object())


@pytest.fixture(scope="module")
def writer_models(tmp_path_factory, jax_models):
    """The JAX MMCTM and the port's, loaded from its checkpoint: one float64
    state."""
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    jio.save_model(path, jax_models["MMCTM"])
    return jax_models["MMCTM"], mt.load_model(path, device="cpu")


@pytest.mark.parametrize("name", ["mean", "cov", "cor"])
def test_matrix_writers_are_byte_identical_to_jax(tmp_path, writer_models, name):
    jm, pm = writer_models
    getattr(jio, f"write_{name}")(tmp_path / "jax.tsv", jm)
    getattr(tio, f"write_{name}")(tmp_path / "port.tsv", pm)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    np.testing.assert_array_equal(tio.cov2cor(pm.Sigma), jio.cov2cor(jm.Sigma))


def _table(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    return rows[0], rows[1:]


@pytest.mark.parametrize("name", ["sigs", "props"])
def test_tables_match_jax(tmp_path, writer_models, name):
    """Written without pandas: the same header and labels as the JAX
    package's pandas tables, and the same probabilities."""
    jm, pm = writer_models
    modalities = ["SNV", "SV"]
    if name == "sigs":
        extra = ([[f"t{v}" for v in range(4)], [f"s{v}" for v in range(4)]], modalities)
        n_labels = 4  # modality, topic, value, term
    else:
        extra = (["samp1", "samp2"], modalities)
        n_labels = 1  # topic
    getattr(jio, f"write_{name}")(tmp_path / "jax.tsv", jm, *extra)
    getattr(tio, f"write_{name}")(tmp_path / "port.tsv", pm, *extra)
    (g_head, g_rows), (w_head, w_rows) = _table(tmp_path / "port.tsv"), _table(tmp_path / "jax.tsv")
    assert g_head == w_head and len(g_rows) == len(w_rows) == (2 * 4 + 3 * 4 if name == "sigs"
                                                               else 5)
    assert [r[:n_labels] for r in g_rows] == [r[:n_labels] for r in w_rows]
    got = np.array([[float(x) for x in r[n_labels:]] for r in g_rows])
    want = np.array([[float(x) for x in r[n_labels:]] for r in w_rows])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if name == "props":
        assert g_rows[0][0] == "SNV-1" and g_rows[-1][0] == "SV-3"
        np.testing.assert_allclose(got[:2].sum(axis=0), 1.0, rtol=1e-12)
