"""Checkpoint / resume support.

The reference has no library-level checkpointing — its closest primitives are
the ``W_init``/``H_init`` warm-start parameters (``_solver.py:68-69,126-129``)
and ad-hoc ``np.savez`` in the example scripts
(``examples/reproduce_magron2022.py:138-144``).  Here checkpointing is
first-class (SURVEY.md §5): the full solver state — factors, loss history,
iteration count, seed, hyperparameters — round-trips through a single
``.npz`` file, and ``resume_fit`` continues optimization from a checkpoint
via the warm-start path.

An Orbax-backed variant is provided for multi-host/async use when
``orbax.checkpoint`` is importable; the ``.npz`` format needs only NumPy.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_model",
    "load_model",
    "resume_fit",
]

_FORMAT_VERSION = 1


def save_checkpoint(path, W, H, losses, n_iter, *, seed=None, hyperparams=None):
    """Persist solver state to ``path`` (``.npz``).  ``hyperparams`` is an
    arbitrary JSON-serializable dict (alpha, beta, orientation, ...)."""
    meta = {
        "format_version": _FORMAT_VERSION,
        "seed": None if seed is None else int(seed),
        "hyperparams": hyperparams or {},
    }
    np.savez(
        path,
        W=np.asarray(W),
        H=np.asarray(H),
        losses=np.asarray(losses, dtype=np.float64),
        n_iter=np.asarray(int(n_iter)),
        meta=np.asarray(json.dumps(meta)),
    )


def load_checkpoint(path):
    """Load a checkpoint saved by :func:`save_checkpoint`.

    Returns a dict with keys ``W, H, losses, n_iter, seed, hyperparams``.
    """
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        if meta.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(f"checkpoint from a newer format: {meta}")
        return {
            "W": data["W"],
            "H": data["H"],
            "losses": [float(x) for x in data["losses"]],
            "n_iter": int(data["n_iter"]),
            "seed": meta.get("seed"),
            "hyperparams": meta.get("hyperparams", {}),
        }


def save_model(path, model):
    """Checkpoint a fitted :class:`~nbmf_mm_jax.NBMF` estimator."""
    from .validation import check_is_fitted

    check_is_fitted(model, ["components_"])
    hp = {
        "n_components": model.n_components,
        "alpha": model.alpha,
        "beta": model.beta,
        "orientation": model.orientation,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "projection": getattr(model, "projection", "normalize"),
        "mask_mode": getattr(model, "mask_mode", "parity"),
    }
    save_checkpoint(
        path,
        model.W_,
        model.components_,
        model.loss_curve_,
        model.n_iter_,
        seed=model.random_state,
        hyperparams=hp,
    )


def load_model(path):
    """Restore a fitted estimator from :func:`save_model` output."""
    from ..models.estimator import NBMFMM

    ckpt = load_checkpoint(path)
    hp = ckpt["hyperparams"]
    model = NBMFMM(
        n_components=hp.get("n_components", ckpt["W"].shape[1]),
        alpha=hp.get("alpha", 1.2),
        beta=hp.get("beta", 1.2),
        max_iter=hp.get("max_iter", 2000),
        tol=hp.get("tol", 1e-5),
        orientation=hp.get("orientation", "beta-dir"),
        projection=hp.get("projection", "normalize"),
        mask_mode=hp.get("mask_mode", "parity"),
        random_state=ckpt["seed"],
    )
    model.W_ = ckpt["W"]
    model.components_ = ckpt["H"]
    model.loss_curve_ = ckpt["losses"]
    model.objective_history_ = model.loss_curve_
    model.n_iter_ = ckpt["n_iter"]
    model.loss_ = ckpt["losses"][-1] if ckpt["losses"] else np.inf
    model.reconstruction_err_ = model.loss_
    return model


def resume_fit(path, X, mask=None, **overrides):
    """Continue fitting from a checkpoint: warm-start the solver with the
    stored factors (the checkpoint analogue of the reference's
    ``W_init``/``H_init`` path) and return a fitted estimator whose
    ``loss_curve_`` is the concatenated history."""
    from ..models.estimator import NBMFMM

    ckpt = load_checkpoint(path)
    hp = dict(ckpt["hyperparams"])
    hp.update(overrides)
    model = NBMFMM(
        n_components=hp.get("n_components", ckpt["W"].shape[1]),
        alpha=hp.get("alpha", 1.2),
        beta=hp.get("beta", 1.2),
        max_iter=hp.get("max_iter", 2000),
        tol=hp.get("tol", 1e-5),
        orientation=hp.get("orientation", "beta-dir"),
        projection=hp.get("projection", "normalize"),
        mask_mode=hp.get("mask_mode", "parity"),
        random_state=ckpt["seed"],
        W_init=ckpt["W"],
        H_init=ckpt["H"],
    )
    model.fit(X, mask=mask)
    prior = ckpt["losses"]
    model.loss_curve_ = prior + model.loss_curve_
    model.objective_history_ = model.loss_curve_
    model.n_iter_ += ckpt["n_iter"]
    return model


def fit_checkpointed(model, X, path, mask=None, every: int = 100):
    """Fit ``model`` on ``X`` in segments of ``every`` sweeps, writing a
    checkpoint after each segment (restartable long fits; the on-device loop
    itself never leaves the chip, so checkpoints happen at segment
    boundaries).  Warm starting continues the same MM trajectory (up to
    rounding from the idempotent re-normalization at segment starts); the
    relative-change stopping test restarts its one-iteration warmup at each
    boundary, so stopping can differ by up to one segment.
    """
    import copy

    total = model.max_iter
    seg_model = copy.deepcopy(model)
    losses: list = []
    W_init, H_init = model.W_init, model.H_init
    done = 0
    while done < total:
        seg_model.max_iter = min(every, total - done)
        seg_model.W_init, seg_model.H_init = W_init, H_init
        seg_model.fit(X, mask=mask)
        losses.extend(seg_model.loss_curve_)
        done += seg_model.n_iter_
        save_checkpoint(
            path, seg_model.W_, seg_model.components_, losses, done,
            seed=model.random_state,
            hyperparams={"alpha": model.alpha, "beta": model.beta,
                         "orientation": seg_model.orientation,
                         "n_components": model.n_components},
        )
        # Converged inside the segment (stopped before the cap)?
        if seg_model.n_iter_ < seg_model.max_iter:
            break
        W_init, H_init = seg_model.W_, seg_model.components_
        # Restart selection happens in segment 1; later segments continue
        # the chosen restart from its factors (solve() rejects n_init > 1
        # combined with explicit warm-start inits).
        seg_model.n_init = 1
    seg_model.loss_curve_ = losses
    seg_model.objective_history_ = losses
    seg_model.n_iter_ = done
    seg_model.max_iter = total
    seg_model.W_init, seg_model.H_init = model.W_init, model.H_init
    return seg_model


# ------------------------------------------------------------------- Orbax
def save_checkpoint_orbax(directory: str, state: dict, *, step: int = 0) -> Optional[str]:
    """Async-capable Orbax checkpoint (multi-host friendly).  Returns the
    checkpoint path, or ``None`` when orbax is unavailable."""
    try:
        import orbax.checkpoint as ocp
    except Exception:  # pragma: no cover
        return None
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    ckptr = ocp.PyTreeCheckpointer()
    ckptr.save(path, state, force=True)
    return path


def load_checkpoint_orbax(path: str) -> dict:
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer().restore(path)
