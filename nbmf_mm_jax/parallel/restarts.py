"""Restart parallelism: ``n_init`` random restarts batched into one solve.

The reference README documents an ``n_init`` parameter (``README.md:134,144``)
that its code never implements (the constructor has no such argument,
``_base.py:63-66``).  Here it is a first-class capability: the whole
``lax.while_loop`` solver is ``vmap``-ed over a leading restart axis, so all
restarts advance in lockstep inside a single compiled program — the batched
sweeps become one batched matmul stream, and no host round-trips happen
until every restart has converged.

Correctness under ``vmap`` relies on the solver body's freeze semantics
(converged lanes select their old carry; see
:func:`nbmf_mm_jax.solver.driver._solve_core`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["vmapped_solve"]


def vmapped_solve(core, data, inits, hypers, keep_all: bool = False):
    """Run ``core`` (the staged single-init solver) over a batch of inits.

    ``inits = (W0, H0)`` carry a leading ``n_init`` axis; ``data`` arrays and
    ``hypers`` scalars are broadcast.  Returns ``(best_result, best_index,
    all_final_losses, all_results)`` where ``best_result`` matches the
    single-init output structure for the restart with the lowest final
    objective, and ``all_results`` is the full batched tuple when
    ``keep_all`` (for protocols that evaluate every restart, e.g. the
    paper's 10-init mean +- std tables) and ``None`` otherwise.
    """
    batched = jax.vmap(
        core,
        in_axes=(None,) * len(data) + (0, 0) + (None,) * len(hypers),
    )
    results = batched(*data, *inits, *hypers)
    final_losses = results[4]
    best = int(jnp.argmin(final_losses))
    best_result = jax.tree.map(lambda x: x[best], results)
    return best_result, best, final_losses, results if keep_all else None
