"""Parity against the original paper author's stored artifacts.

``outputs/magron2022/<ds>/NBMF-MM_model.npz`` (in the reference mount) holds
the original implementation's final factors and loss curve.  Evaluating OUR
objective at THEIR factors pins the loss definition itself:

    Magron's loss == corrected-masked Bernoulli NLL + Beta(alpha, beta)
    prior on H, per observed *training* entry

which is exactly ``mask_mode="corrected"`` here — i.e. the corrected mode is
the paper-exact objective, and the reference repo's asymmetric "parity"
masking is a deviation from the original paper (consistent with the masked
monotonicity findings; see docs/design.md).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

# Default: the artifacts vendored under data/magron2022/ (reference
# outputs/magron2022/, copied verbatim) so the pins run in a standalone
# clone; NBMF_MAGRON_OUTPUTS still overrides.
_VENDORED = os.path.join(
    os.path.dirname(__file__), "..", "data", "magron2022"
)
_ART = os.environ.get("NBMF_MAGRON_OUTPUTS", _VENDORED)

pytestmark = pytest.mark.skipif(
    not os.path.isdir(_ART), reason="Magron artifacts unavailable"
)


def _load(ds):
    path = os.path.join(_ART, ds, "NBMF-MM_model.npz")
    if not os.path.exists(path):
        pytest.skip(f"no artifact for {ds}")
    z = np.load(path, allow_pickle=True)
    return z["W"], z["H"], z["hyper_params"], z["loss"]


def _split(ds):
    from experiments.data import load_dataset_and_splits

    return load_dataset_and_splits(ds)


@pytest.mark.parametrize("ds", ["animals"])  # only animals' true split is committed
def test_objective_matches_magron_stored_loss(ds):
    from nbmf_mm_jax.ops.updates import map_objective, precompute_masked_terms

    W, H, (k, alpha, beta), loss_curve = _load(ds)
    Y, train_mask, _, _ = _split(ds)
    # Their H is stored (n, k); internal layout wants (k, n) / (k, m).
    Ym, Ym2, Yc = precompute_masked_terms(
        jnp.asarray(Y), jnp.asarray(train_mask), mask_mode="corrected"
    )
    n_obs = float(np.count_nonzero(train_mask))
    loss = float(
        map_objective(
            jnp.asarray(W.T), jnp.asarray(H.T), Ym, Yc,
            alpha=float(alpha), beta=float(beta), n_obs=n_obs, eps=1e-8,
        )
    )
    # 1e-6 per-entry tolerance (the original uses the same eps=1e-8 floors).
    assert abs(loss - float(loss_curve[-1])) < 1e-6, (loss, loss_curve[-1])


def test_magron_loss_curve_shape():
    """Their stored loss curve is monotone decreasing — the same guarantee
    our corrected mode carries (sanity link between the two objectives)."""
    _, _, _, loss_curve = _load("animals")
    assert np.all(np.diff(loss_curve) <= 1e-10)
