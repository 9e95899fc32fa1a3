#!/usr/bin/env python
"""Validate the algorithmic guarantees on synthetic data, both orientations
(the nbmf_mm_jax analogue of the reference's ``examples/
validate_implementation.py`` / ``validate_magron_implementation.py``):
monotone MAP descent, simplex constraints, box constraints, masked training.

Exit code 0 iff every check passes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from experiments._env import force_platform  # noqa: E402

force_platform()  # correctness checks need CPU + float64 (see _env.py)

from nbmf_mm_jax import NBMF  # noqa: E402
from nbmf_mm_jax.utils import generate_synthetic_binary_data  # noqa: E402


def check(label, ok):
    print(f"  [{'PASS' if ok else 'FAIL'}] {label}")
    return bool(ok)


def validate(orientation: str, masked: bool) -> bool:
    X, _, _ = generate_synthetic_binary_data(
        n_samples=80, n_features=60, n_components=5, random_state=0
    )
    mask = None
    if masked:
        mask = (np.random.default_rng(1).random(X.shape) < 0.85).astype(float)

    model = NBMF(
        n_components=5, orientation=orientation, max_iter=200, tol=1e-7, random_state=0
    ).fit(X, mask=mask)
    hist = np.asarray(model.objective_history_)
    ok = True
    title = f"{orientation}{' masked' if masked else ''}"
    print(f"{title}: {model.n_iter_} iters, final loss {model.loss_:.6f}")
    if masked:
        # The reference's exact masked semantics (mask_mode="parity") are NOT
        # a true MM scheme: its W update majorizes the fully-masked objective
        # while the monitored loss counts unobserved entries as zeros in the
        # (1-Y) term (reference _solver.py:43,53,154), so tiny late-stage
        # increases occur — in the reference too (verified: 58 violations of
        # up to 1.9e-6 on this config with the reference implementation).
        # Its own masked test only checks 30 iterations
        # (tests/test_one_step_and_masking.py:32-54); we pin that contract
        # here, and check the corrected mode for the full guarantee below.
        ok &= check(
            "monotone MAP descent, first 30 sweeps (reference masked contract)",
            np.all(np.diff(hist[:30]) <= 1e-12),
        )
        corrected = NBMF(
            n_components=5, orientation=orientation, max_iter=200, tol=1e-7,
            random_state=0, mask_mode="corrected",
        ).fit(X, mask=mask)
        ok &= check(
            "monotone MAP descent, all sweeps (mask_mode='corrected')",
            np.all(np.diff(np.asarray(corrected.objective_history_)) <= 1e-12),
        )
    else:
        ok &= check(
            "monotone MAP descent (<= 1e-12 increase)", np.all(np.diff(hist) <= 1e-12)
        )
    ok &= check("finite losses", np.all(np.isfinite(hist)))
    if orientation == "beta-dir":
        ok &= check("W rows on simplex", np.allclose(model.W_.sum(axis=1), 1.0, atol=1e-9))
        ok &= check("H in [0,1]", np.all((model.components_ >= 0) & (model.components_ <= 1)))
        ok &= check("H continuous", len(np.unique(model.components_)) > 50)
    else:
        ok &= check(
            "H cols on simplex", np.allclose(model.components_.sum(axis=0), 1.0, atol=1e-9)
        )
        ok &= check("W in [0,1]", np.all((model.W_ >= 0) & (model.W_ <= 1)))
        ok &= check("W continuous", len(np.unique(model.W_)) > 50)
    return ok


def main():
    ok = True
    for orientation in ("beta-dir", "dir-beta"):
        for masked in (False, True):
            ok &= validate(orientation, masked)
    print("\nALL CHECKS PASSED" if ok else "\nSOME CHECKS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
