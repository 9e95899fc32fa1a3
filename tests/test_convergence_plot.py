"""Convergence visualization side-effect test (analogue of the reference's
tests/test_convergence.py, which writes convergence_plot.png)."""

import numpy as np
import pytest

from nbmf_mm_jax import NBMF
from nbmf_mm_jax.utils import generate_synthetic_binary_data


def test_convergence_plot(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X, _, _ = generate_synthetic_binary_data(
        n_samples=50, n_features=40, n_components=4, random_state=0
    )
    model = NBMF(n_components=4, max_iter=150, tol=1e-7, random_state=0).fit(X)
    hist = np.asarray(model.loss_curve_)
    assert len(hist) == model.n_iter_
    assert np.all(np.diff(hist) <= 1e-12)

    fig, ax = plt.subplots()
    ax.plot(hist)
    ax.set_xlabel("sweep")
    ax.set_ylabel("negative MAP objective / observed entry")
    out = tmp_path / "convergence_plot.png"
    fig.savefig(out)
    plt.close(fig)
    assert out.exists() and out.stat().st_size > 0
