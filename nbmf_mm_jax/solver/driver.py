"""NBMF-MM solver driver.

The reference solver (``siddC/nbmf_mm`` ``src/nbmf_mm/_solver.py:61-216``) is a
Python ``for`` loop over NumPy sweeps with a host-side relative-loss
convergence check.  Here the entire optimization — sweeps, objective, and the
early-stopping test — runs on-device inside one compiled
``jax.lax.while_loop``:

- the carry holds ``(W, H, loss_buffer[max_iter], prev_loss, it, done)`` with
  static shapes, so the loop compiles once per (shape, max_iter, options) and
  transfers to host exactly once, after convergence;
- the loop body *freezes* converged states (selects the old carry when
  ``done``) instead of exiting, which makes the identical code correct under
  ``vmap`` — that is what powers ``n_init`` batched restarts
  (:mod:`nbmf_mm_jax.parallel.restarts`) and keeps GSPMD sharding legal;
- the "dir-beta" orientation reuses the beta-dir kernels through the transpose
  symmetry of the model, exactly like the reference (``_solver.py:113-123``),
  applied on the host before staging;
- seeding uses ``jax.random.PRNGKey`` (functional, reproducible per backend)
  instead of the reference's global ``np.random.seed`` (``_solver.py:102``).

Deviations from the reference (documented per SURVEY.md §7):

- the returned ``time_elapsed`` is the real wall-clock time (the reference
  hard-codes ``0.0``, ``_solver.py:216``);
- ``n_init``, ``projection="duchi"``, ``mask_mode="corrected"``, dtype and
  sharding controls are new capabilities the reference README promises but
  does not implement.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.updates import (
    clip_upper_interior,
    map_objective,
    mm_sweep,
    precompute_masked_terms,
)

__all__ = ["nbmf_mm_solver", "solve", "SolverResult"]

_ORIENTATIONS = ("beta-dir", "dir-beta")


@dataclass
class SolverResult:
    """Full solver output (the tuple API of :func:`nbmf_mm_solver` is a view).

    ``W`` is ``(m, k)`` and ``H`` is ``(k, n)`` in *external* notation for the
    requested orientation.  ``losses`` has length ``n_iter``.
    """

    W: np.ndarray
    H: np.ndarray
    losses: List[float]
    time_elapsed: float
    n_iter: int
    converged: bool
    # Extras beyond the reference tuple:
    best_restart: int = 0
    all_final_losses: Optional[np.ndarray] = None
    seed: Optional[int] = None
    extras: dict = field(default_factory=dict)


def _resolve_dtype(dtype):
    if dtype is not None:
        return jnp.dtype(dtype)
    return jnp.dtype(jnp.float64) if jax.config.jax_enable_x64 else jnp.dtype(jnp.float32)


def _resolve_precision(precision):
    if precision is None:
        return jax.lax.Precision.HIGHEST
    if isinstance(precision, str):
        return {
            "default": jax.lax.Precision.DEFAULT,
            "high": jax.lax.Precision.HIGH,
            "highest": jax.lax.Precision.HIGHEST,
        }[precision.lower()]
    return precision


def _mm_loop(sweep, objective, W0, H0, tol, *, max_iter: int, verbose: int):
    """The shared compiled optimization loop: run ``sweep``/``objective`` to
    convergence inside one ``lax.while_loop`` with vmap-safe freeze semantics.

    Returns ``(W, H, losses, n_iter, final_loss, done)`` with ``losses`` a
    fixed ``(max_iter,)`` buffer (entries past ``n_iter`` are undefined).
    """
    dtype = W0.dtype
    losses0 = jnp.zeros((max_iter,), dtype=dtype)

    def cond(carry):
        _, _, _, _, it, done = carry
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    def body(carry):
        W, H, losses, prev_loss, it, done = carry
        W_new, H_new = sweep(W, H)
        loss_t = objective(W_new, H_new)
        if verbose > 0:
            jax.lax.cond(
                it % 10 == 0,
                lambda: jax.debug.print("Iter {it}: Loss = {loss}", it=it, loss=loss_t),
                lambda: None,
            )
        # Relative-change stopping rule, checked from the 2nd iteration on
        # (reference _solver.py:169-175).  The loss of the stopping iteration
        # is still recorded, matching len(losses) == n_iter there.
        rel_change = jnp.abs(prev_loss - loss_t) / jnp.abs(prev_loss)
        newly_done = jnp.logical_and(it > 0, rel_change < tol)
        # Freeze converged lanes: under vmap the loop keeps running until all
        # restarts converge, and `done` lanes must not drift.
        W_out = jnp.where(done, W, W_new)
        H_out = jnp.where(done, H, H_new)
        losses_out = jnp.where(done, losses, losses.at[it].set(loss_t))
        prev_out = jnp.where(done, prev_loss, loss_t)
        it_out = jnp.where(done, it, it + 1)
        done_out = jnp.logical_or(done, newly_done)
        return (W_out, H_out, losses_out, prev_out, it_out, done_out)

    init = (
        W0,
        H0,
        losses0,
        jnp.array(jnp.inf, dtype=dtype),
        jnp.array(0, dtype=jnp.int32),
        jnp.array(False),
    )
    W, H, losses, final_loss, n_iter, done = jax.lax.while_loop(cond, body, init)
    return W, H, losses, n_iter, final_loss, done


@partial(
    jax.jit,
    static_argnames=("max_iter", "projection", "precision", "verbose"),
)
def _solve_core(
    Ym,
    Ym2,
    Yc,
    W0,
    H0,
    alpha,
    beta,
    tol,
    eps,
    n_obs,
    n_real,
    Vn=None,
    *,
    max_iter: int,
    projection: str,
    precision,
    verbose: int,
):
    """XLA-path MM loop for one initialization (internal beta-dir layout:
    ``W0`` is ``(k, m)`` with unit column sums, ``H0`` is ``(k, n)``).

    ``Vn`` (``(1, n)`` 0/1 column validity) is given only when the operands
    carry GSPMD shard padding: the pads contribute exactly nothing to every
    contraction (zero data, zero W pad columns), so only the Beta-prior sums
    over ``H`` need masking — see :func:`map_objective`."""
    sweep = lambda W, H: mm_sweep(
        W, H, Ym, Ym2, Yc,
        alpha=alpha, beta=beta, n_real=n_real, eps=eps,
        projection=projection, precision=precision,
    )
    objective = lambda W, H: map_objective(
        W, H, Ym, Yc,
        alpha=alpha, beta=beta, n_obs=n_obs, eps=eps, precision=precision,
        col_validity=Vn,
    )
    return _mm_loop(sweep, objective, W0, H0, tol, max_iter=max_iter, verbose=verbose)


@partial(
    jax.jit,
    static_argnames=(
        "max_iter",
        "projection",
        "verbose",
        "eps",
        "m_real",
        "n_real",
        "block_m",
        "block_n",
        "interpret",
        "packed",
        "kernel_precision",
    ),
)
def _solve_core_pallas(
    Ymp,
    Ym2p,
    Ycp,
    W0p,
    H0p,
    alpha,
    beta,
    tol,
    n_obs,
    *,
    max_iter: int,
    projection: str,
    verbose: int,
    eps: float,
    m_real: int,
    n_real: int,
    block_m: int,
    block_n: int,
    interpret: bool = False,
    packed: bool = False,
    kernel_precision=None,
):
    """Fused-kernel MM loop on zero-padded operands (see
    :mod:`nbmf_mm_jax.ops.pallas_sweep` for the padding contract).

    With ``packed=True`` the data operands are int32 bit-plane words
    (``(Mp//32, Np)``, built by :func:`~nbmf_mm_jax.ops.pallas_sweep.pack_bits`
    in :func:`solve`) — bit-identical math, 32x less data traffic and memory
    (binary operands only).

    Uses the *shifted-loss* schedule: the loss the reference reports after
    sweep ``t`` is evaluated on the same ``W.T @ H`` product the next
    sweep's H pass recomputes, so both fuse into one kernel
    (:func:`~nbmf_mm_jax.ops.pallas_sweep.hloss_terms`) and each iteration
    costs exactly 2 single-read passes over the (Mp, Np) data (H+loss pass,
    W pass) instead of 3 — with results identical to the reference schedule:
    the body at counter ``it`` records the loss of sweep ``it-1`` and makes
    the convergence decision the reference made before starting sweep ``it``.
    One more H+loss pass after the loop fills the final entry when
    ``max_iter`` is exhausted.  Results come back padded; the caller slices
    to ``(m_real, n_real)``.
    """
    from ..ops import pallas_sweep as ps
    from ..ops.projection import project_columns_simplex_duchi

    kw = dict(
        block_m=block_m, block_n=block_n, packed=packed, interpret=interpret,
        precision=kernel_precision, eps=eps,
    )
    dtype = W0p.dtype
    # Ycp is the masked complement in corrected mode (the same array as
    # Ym2p), None otherwise: the kernels then form 1 - Ym in registers.
    hloss_fn = lambda W, H: ps.hloss_terms(
        W, H, Ymp, Ycp, m_real=m_real, n_real=n_real, **kw
    )
    wterms_fn = lambda W, H_new: ps.w_terms(W, H_new, Ymp, Ym2p, n_real=n_real, **kw)

    def objective_from_ll(ll, H):
        H_real = H[:, :n_real]
        prior_a = (alpha - 1.0) * jnp.sum(jnp.log(H_real + eps))
        prior_b = (beta - 1.0) * jnp.sum(jnp.log(1.0 - H_real + eps))
        return (-(ll + prior_a + prior_b) / n_obs).astype(dtype)

    def finish_sweep(W, H, Num, Den):
        num = H * Num + (alpha - 1.0)
        den = (1.0 - H) * Den + (beta - 1.0)
        # dtype-aware upper bound: see ops.updates.clip_upper_interior (f32
        # would otherwise let H reach exactly 1.0 and the loss logs hit
        # log(0) under XLA reassociation)
        H_new = jnp.clip(
            num / (num + den + eps), eps, clip_upper_interior(eps, dtype)
        )
        H_new = ps.apply_col_validity(H_new, n_real)
        T = wterms_fn(W, H_new)
        W_raw = W * T
        if projection == "normalize":
            W_new = W_raw / n_real
            col_sums = W_new.sum(axis=0, keepdims=True)
            W_new = W_new / jnp.where(col_sums > 0, col_sums, 1.0)
        else:  # duchi: re-zero the pad columns the projection would fill
            W_new = ps.apply_col_validity(
                project_columns_simplex_duchi(W_raw / n_real), m_real
            )
        return W_new, H_new

    losses0 = jnp.zeros((max_iter,), dtype=dtype)

    def cond(carry):
        _, _, _, _, it, done = carry
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    def body(carry):
        W, H, losses, prev1, it, done = carry
        Num, Den, ll = hloss_fn(W, H)
        loss_cur = objective_from_ll(ll, H)  # loss of sweep it-1 (garbage at it=0)
        if verbose > 0:
            jax.lax.cond(
                jnp.logical_and(it >= 1, (it - 1) % 10 == 0),
                lambda: jax.debug.print(
                    "Iter {it}: Loss = {loss}", it=it - 1, loss=loss_cur
                ),
                lambda: None,
            )
        rec = jnp.logical_and(it >= 1, jnp.logical_not(done))
        losses = jnp.where(
            rec, losses.at[jnp.maximum(it - 1, 0)].set(loss_cur), losses
        )
        # The stopping test the reference made after recording loss_{it-1}
        # (i.e. before starting sweep `it`): requires two recorded losses.
        rel_change = jnp.abs(prev1 - loss_cur) / jnp.abs(prev1)
        newly_done = jnp.logical_and(it >= 2, rel_change < tol)
        done_out = jnp.logical_or(done, newly_done)
        # Freeze semantics: converged lanes keep their carry (required under
        # vmap; for n_init == 1 the selects fire only on the final
        # iteration), so plain selects serve every n_init.
        W_new, H_new = finish_sweep(W, H, Num, Den)
        W_out = jnp.where(done_out, W, W_new)
        H_out = jnp.where(done_out, H, H_new)
        prev_out = jnp.where(rec, loss_cur, prev1)
        it_out = jnp.where(done_out, it, it + 1)
        return (W_out, H_out, losses, prev_out, it_out, done_out)

    init = (
        W0p,
        H0p,
        losses0,
        jnp.array(jnp.inf, dtype=dtype),
        jnp.array(0, dtype=jnp.int32),
        jnp.array(False),
    )
    W, H, losses, prev1, n_iter, done = jax.lax.while_loop(cond, body, init)

    # max_iter exhausted without converging: the last sweep's loss was never
    # recorded — one more H+loss pass fills it (Num/Den discarded; once per
    # solve), so the filled entry is computed exactly like every other.
    _, _, ll_fin = hloss_fn(W, H)
    loss_fin = objective_from_ll(ll_fin, H)
    need_final = jnp.logical_not(done)
    losses = jnp.where(
        need_final, losses.at[jnp.maximum(n_iter - 1, 0)].set(loss_fin), losses
    )
    final_loss = jnp.where(need_final, loss_fin, prev1)
    rel_fin = jnp.abs(prev1 - loss_fin) / jnp.abs(prev1)
    done = jnp.logical_or(
        done, jnp.logical_and(need_final, jnp.logical_and(n_iter >= 2, rel_fin < tol))
    )
    return W, H, losses, n_iter, final_loss, done


def _exactly_binary(A) -> bool:
    """True when every entry of ``A`` is exactly 0 or 1 (None counts as
    trivially binary).  Shared eligibility rule for the bitpacked kernels
    (:func:`solve`, :func:`~nbmf_mm_jax.parallel.grid.grid_solve`)."""
    if A is None:
        return True
    if isinstance(A, jax.Array):
        return bool(jnp.all((A == 0) | (A == 1)))
    Anp = np.asarray(A)
    return bool(((Anp == 0) | (Anp == 1)).all())


def _resolve_backend(backend: str, dtype, precision=None) -> bool:
    """Decide whether to use the fused Pallas sweep path.

    ``auto`` selects the fused kernels on the GPU for <= f32 dtypes at the
    default product precision — both single-device (``_solve_core_pallas``)
    and, when a ``mesh`` is given, the shard_map + per-shard-kernel path
    (``solve_core_sharded``); the routing between those happens in
    :func:`solve` on ``mesh``.  An explicit ``precision="highest"`` keeps
    ``auto`` on XLA: the kernels' IEEE f32 products run off the tensor
    cores and lose to XLA's HIGHEST sweep by a wide margin on an H100.
    ``pallas`` forces the kernels (with ``pallas_interpret`` they run
    anywhere, used by the parity tests on CPU); f64 always takes the XLA
    path.
    """
    if backend == "jnp":
        return False
    if backend == "pallas":
        return True
    if backend != "auto":
        raise ValueError(f"backend must be 'auto', 'jnp' or 'pallas', got {backend!r}")
    if jnp.dtype(dtype) == jnp.dtype(jnp.float64):
        return False
    if precision is not None and _resolve_precision(precision) == jax.lax.Precision.HIGHEST:
        return False
    return jax.default_backend() == "gpu"


def _stage_fused_operands(Ym, Ym2, Yc, Mp, Np, *, packed, data_dtype):
    """Pad the fused kernels' data operands to ``(Mp, Np)`` and, when they
    are exactly binary, bitpack them (``packed`` follows :func:`solve`:
    ``None`` packs when eligible, ``True`` requires it, ``False`` never).

    ``Ym2``/``Yc`` may be ``None`` (complement formed in the kernels);
    ``Yc`` is given only in corrected mode, where it equals ``Ym2`` and
    aliases its staged buffer.  Host (numpy) operands pack on the host, so
    the data crosses to the device as words at 1/32 of the bytes.  Returns
    ``(Ymp, Ym2p, Ycp, use_packed)``.
    """
    from ..ops import pallas_sweep as ps

    if packed is True and data_dtype is not None:
        raise ValueError(
            "packed=True is incompatible with dtype='bfloat16': packing "
            "replaces the data stream (and is both smaller and exact)"
        )
    use_packed = (
        packed is not False
        and data_dtype is None  # an explicit bf16 request wins over auto
        # the streamed operands must be exactly 0/1 — checks Ym/Ym2 (after
        # masking), so continuous values at observed entries are caught
        and _exactly_binary(Ym)
        and _exactly_binary(Ym2)
    )
    if packed is True and not use_packed:
        raise ValueError("packed=True requires exactly binary data (and mask)")

    def stage(A):
        if A is None:
            return None
        if not use_packed:
            A = jnp.asarray(A)
            return ps.pad_to(A if data_dtype is None else A.astype(data_dtype), Mp, Np)
        if isinstance(A, np.ndarray):
            return jnp.asarray(ps.pack_bits_host(ps.pad_to(A, Mp, Np)))
        return jax.jit(ps.pack_bits)(ps.pad_to(A, Mp, Np))

    Ymp, Ym2p = stage(Ym), stage(Ym2)
    return Ymp, Ym2p, (Ym2p if Yc is not None else None), use_packed


def _random_uniform_inits(key, n_init, m, n, k, dtype):
    """Reference-style U(0.1, 0.9) initialization (``_solver.py:126-129``),
    batched over ``n_init`` restarts."""
    kw, kh = jax.random.split(key)
    W0 = jax.random.uniform(kw, (n_init, m, k), dtype=dtype, minval=0.1, maxval=0.9)
    H0 = jax.random.uniform(kh, (n_init, k, n), dtype=dtype, minval=0.1, maxval=0.9)
    return W0, H0


def _final_simplex_safeguard(W_final, H_final, orientation):
    """Renormalization safeguard replicating ``_solver.py:186-213``: if the
    simplex factor drifted more than 1e-9 from unit sums, renormalize
    (guarding degenerate all-zero slices).

    Works on host (numpy) and device (jax) arrays alike; the device variant
    syncs only the scalar drift (4 bytes), never the factors — required by
    ``solve(device_results=True)``."""
    tiny, tol = 1e-12, 1e-9
    xp = jnp if isinstance(W_final, jax.Array) else np
    if orientation == "beta-dir":
        if W_final.size:
            row_sums = W_final.sum(axis=1, keepdims=True)
            dev = float(xp.max(xp.abs(row_sums - 1.0)))
            if np.isfinite(dev) and dev > tol:
                safe = row_sums > tiny
                if bool(xp.any(safe)):
                    W_final = xp.where(safe, W_final / xp.where(safe, row_sums, 1.0), W_final)
    else:
        if H_final.size:
            col_sums = H_final.sum(axis=0, keepdims=True)
            dev = float(xp.max(xp.abs(col_sums - 1.0)))
            if np.isfinite(dev) and dev > tol:
                safe = col_sums > tiny
                if bool(xp.any(safe)):
                    H_final = xp.where(safe, H_final / xp.where(safe, col_sums, 1.0), H_final)
    return W_final, H_final


def _densify(a):
    return a.toarray() if hasattr(a, "toarray") else a


def solve(
    Y,
    n_components: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    alpha: float = 1.2,
    beta: float = 1.2,
    W_init=None,
    H_init=None,
    mask=None,
    random_state: Optional[int] = None,
    verbose: int = 0,
    orientation: str = "beta-dir",
    eps: float = 1e-8,
    *,
    n_init: int = 1,
    projection: str = "normalize",
    mask_mode: str = "parity",
    dtype=None,
    precision=None,
    mesh=None,
    mesh_axes: Tuple[str, str] = ("rows", "cols"),
    backend: str = "auto",
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    pallas_interpret: bool = False,
    return_all: bool = False,
    packed: Optional[bool] = None,
    device_results: bool = False,
) -> SolverResult:
    """Solve ``Y ~ Bernoulli(W @ H)`` by MM and return a :class:`SolverResult`.

    Semantics mirror the reference ``nbmf_mm_solver`` (``_solver.py:61-216``)
    with the documented extensions:

    - ``n_init > 1``: batched random restarts (``vmap``-ed over the whole
      compiled loop); the restart with the lowest final objective is
      returned, with ``all_final_losses``/``best_restart`` recorded.
    - ``projection``: ``"normalize"`` (paper-exact MM simplex step) or
      ``"duchi"`` (sort-based Euclidean projection).  Only ``"normalize"``
      is part of the MM majorizer: with ``"duchi"`` the monotone-descent
      guarantee does not apply (it descends in the paper's regimes, but
      objective increases are possible — observed with ``alpha, beta < 1``
      priors combined with overcomplete ranks ``k > min(m, n)``).

    The monotone-descent guarantee itself requires ``alpha >= 1`` and
    ``beta >= 1``: with an exponent ``< 1`` the ``(alpha-1)``/``(beta-1)``
    prior terms in the multiplicative update turn negative, the update can
    leave ``[0, 1]`` (the clip then engages), and the objective can
    INCREASE — a property of the reference algorithm itself, which this
    library reproduces trajectory-exactly (verified: identical ~11-unit
    loss spikes on both implementations at ``beta ~ 0.4``, ``k > m``).
    The paper's own grids include ``alpha, beta = 0.5``; in those benign
    low-rank regimes the updates stay interior and descent holds in
    practice.
    - ``mask_mode``: ``"parity"`` (the reference's exact asymmetric masking)
      or ``"corrected"`` (observed-entries-only; the original paper's
      objective, fully monotone).
    - ``dtype``: ``float64`` (CPU parity regime), ``float32``, or
      ``"bfloat16"`` (bf16 data matrices, f32 factors/accumulation).
    - ``precision``: matmul precision ("default"/"high"/"highest" or a
      ``lax.Precision``).  ``None`` means path-appropriate defaults: the
      XLA/jnp path runs HIGHEST (true-f32 products); the fused path runs
      DEFAULT — on the GPU that is TF32 tensor-core products (about 10
      mantissa bits).  Pass ``precision="highest"`` explicitly for IEEE
      f32 products in the kernels when trajectories must track the CPU path
      tightly.
    - ``mesh``/``mesh_axes``: shard data and factors over a 2-D device mesh
      (GSPMD on the XLA path; shard_map + per-shard fused kernels with
      explicit psums on the Pallas path).
    - ``backend``: ``"auto"`` (fused kernels on the GPU for <= f32, XLA
      otherwise), ``"jnp"``, or ``"pallas"``; ``block_m``/``block_n`` set
      the kernels' power-of-two block sizes and ``pallas_interpret`` runs
      the kernels interpreted (CPU testing).
    - ``Y``/``mask`` may be device-resident ``jax.Array``s (no host
      round-trip; recommended for repeated large solves).
    - ``return_all``: with ``n_init > 1``, additionally return every
      restart's factors/trace in ``extras`` (``all_W (n_init, m, k)``,
      ``all_H (n_init, k, n)``, ``all_n_iter``, ``all_losses``) — the
      paper's 10-init evaluation protocol needs per-init models, not just
      the best one.  Supported on every path, including the multi-device
      shard_map and GSPMD routes.
    - ``packed``: bitpack exactly-binary operands into int32 bit-plane
      words for the fused kernels (32 entries/word: ~32x less data stream
      and data memory; results bit-identical).  ``None`` (default) enables
      it automatically on the fused paths (single-device and sharded) when
      the data — and the mask, if given — are exactly 0/1 and no explicit
      bf16 data mode was requested (``dtype='bfloat16'`` wins over
      auto-packing).  ``False`` disables; ``True`` requires eligibility —
      fused backend, binary operands, no bf16 mode — and raises otherwise
      on every routing.
    - ``Y`` may be a :class:`~nbmf_mm_jax.ops.packed.PackedMatrix` (built
      with :func:`~nbmf_mm_jax.ops.packed.pack_matrix` /
      :func:`~nbmf_mm_jax.ops.packed.pack_matrix_chunked`): the data then
      only ever exists as int32 bit-plane words — 1/32 the memory of dense
      f32 — so the largest solvable single-device problem is set by the
      packed footprint, not the dense staging.  Beta-dir, unmasked,
      single-device, f32 (everything else raises).
    - ``Y`` may be a ``scipy.sparse`` matrix: f32 beta-dir routings on
      the fused kernels pack it directly from the sparse structure (:func:`~nbmf_mm_jax.ops.packed.pack_matrix_sparse` — no
      dense staging anywhere); every other routing densifies it, exactly
      as before.  With a ``scipy.sparse`` ``mask`` as well (the recommender
      shape: sparse interactions + sparse observed-entry mask), BOTH packed
      operands build sparsely (``Ym = Y*mask``, ``Ym2 = mask - Ym``) and
      the masked fit never stages dense either — results bit-identical to
      the dense masked solve, both mask modes.  The same holds with a
      ``mesh``: the words pack straight from the sparse structures
      (``solver.sharded.pack_words_for_mesh``), so the multi-device ceiling
      is set by the packed footprint too.
    - ``device_results``: return ``W``/``H``/``losses`` as device
      ``jax.Array``s instead of host numpy (the final simplex safeguard
      runs on-device; only scalar ``n_iter``/``converged``/drift sync).
      Use when the factors feed further device work (serving fold-in,
      chained solves) or when the host link is slow.  With
      ``return_all`` the per-restart ``extras`` are still host numpy (the
      10-init protocol consumes them host-side).
    """
    if orientation not in _ORIENTATIONS:
        raise ValueError(
            f"orientation must be one of {_ORIENTATIONS}, got {orientation!r}"
        )
    if projection not in ("normalize", "duchi"):
        raise ValueError(f"projection must be 'normalize' or 'duchi', got {projection!r}")
    if mask_mode not in ("parity", "corrected"):
        # Validated up front for every backend: the Pallas path encodes the
        # mode in which operands it builds, so a typo would otherwise silently
        # fall back to parity semantics on the fused path.
        raise ValueError(
            f"mask_mode must be 'parity' or 'corrected', got {mask_mode!r}"
        )
    if n_init < 1:
        raise ValueError(f"n_init must be >= 1, got {n_init}")

    # First-class bitpacked input (ops.packed.PackedMatrix): the data only
    # ever exists as int32 bit-plane words — 1/32 the device memory of dense
    # f32 — which raises the single-device ceiling to "what fits packed".
    # PackedMatrix input is beta-dir/unmasked/single-device; everything the
    # words cannot express is rejected up front.
    from ..ops.packed import (
        PackedMatrix,
        csr_binary_canonical,
        pack_matrix_sparse,
    )

    # scipy.sparse input: when the solve runs the fused kernels in f32
    # (beta-dir), pack straight from the sparse structure — the matrix is
    # never staged dense, host or device.  Sparse binary user-item data is
    # exactly the case whose dense f32 form blows the memory ceiling that
    # bitpacking removes.  Any ineligible routing (dense mask with no mesh,
    # dir-beta, f64/bf16, jnp backend, non-binary values) densifies as
    # before — unless packed=True made the demand explicit, in which case
    # it raises.
    sparse_masked = False  # Y AND mask scipy.sparse: pack Ym/Ym2 from sparse
    sparse_mesh = False  # sparse operands + mesh: pre-packed words
    if not isinstance(Y, (np.ndarray, jax.Array, PackedMatrix)) and hasattr(
        Y, "toarray"
    ):
        import scipy.sparse as _sp

        # Duck-typed non-scipy objects with .toarray() take the _densify
        # path unchanged.
        sparse_ok = (
            _sp.issparse(Y)
            and orientation == "beta-dir"
            and packed is not False
            and _resolve_dtype(dtype) == jnp.dtype(jnp.float32)
            and _resolve_backend(backend, jnp.dtype(jnp.float32), precision)
        )
        mask_sparse = mask is None or _sp.issparse(mask)
        if sparse_ok and mask_sparse and (mesh is not None or mask is not None):
            # Sparse (Y, mask) on one device, or sparse Y (and mask) on a
            # mesh: both packed operands are sparse-representable (Ym =
            # Y*mask, Ym2 = mask - Ym), so the fit never stages dense.  Only
            # the O(nnz) binaryness check runs here; the packing itself
            # happens after every cheap argument validation below.
            Yb = csr_binary_canonical(Y)
            Mb = csr_binary_canonical(mask) if mask is not None else None
            if Yb is not None and (mask is None or Mb is not None):
                Y, mask = Yb, Mb
                sparse_mesh = mesh is not None
                sparse_masked = mesh is None
            elif packed is True:
                raise ValueError(
                    "packed=True with sparse input requires exactly binary "
                    "stored values"
                )
            else:
                Y = _densify(Y)  # mask densifies via _to_backend below
        elif sparse_ok and mask is None:
            try:
                Y = pack_matrix_sparse(Y)
            except ValueError:
                if packed is True:
                    raise
                Y = _densify(Y)
        else:
            # Includes sparse Y + DENSE mask: no sparse fast path, but the
            # dense route handles it (and itself honors packed=True).
            Y = _densify(Y)

    packed_input = Y if isinstance(Y, PackedMatrix) else None
    if packed_input is not None:
        if orientation != "beta-dir":
            raise ValueError(
                "PackedMatrix input supports orientation='beta-dir' only "
                "(pack the transposed matrix for dir-beta)"
            )
        if mask is not None:
            raise ValueError(
                "PackedMatrix input does not take a separate mask"
            )
        if mesh is not None:
            raise ValueError(
                "PackedMatrix input is single-device.  For a mesh, pass the "
                "data itself — scipy.sparse input packs words directly (no "
                "dense staging), and dense input bitpacks per shard on the "
                "device"
            )
        if packed is False:
            raise ValueError("packed=False contradicts a PackedMatrix input")
        if dtype is not None and jnp.dtype(dtype) not in (
            jnp.dtype(jnp.float32),
        ):
            raise ValueError(
                "PackedMatrix input requires float32 compute (the packed "
                f"kernels are f32; got dtype={dtype!r})"
            )
        dtype = jnp.float32

    t_start = time.time()
    dtype = _resolve_dtype(dtype)
    # Two path-appropriate defaults: the XLA/jnp path (the parity/reference
    # path) defaults to HIGHEST (true-f32 products); the fused path defaults
    # to DEFAULT, which on the GPU means TF32 tensor-core products (about 10
    # mantissa bits) — the throughput the kernels exist for.  An EXPLICIT
    # precision argument is honored on both paths: precision="highest" gives
    # the kernels IEEE f32 products for tight-tolerance work.
    user_precision = precision
    precision = _resolve_precision(precision)
    kernel_precision = (
        None if user_precision is None else _resolve_precision(user_precision)
    )

    # bfloat16 mode: the factors, updates and losses stay f32; only the big
    # (m, n) data matrices are stored bf16 (lossless for binary data) and the
    # fused kernels run their products in bf16 with f32 accumulation.  On the
    # XLA path this is emulated with DEFAULT matmul precision.
    data_dtype = None
    if dtype == jnp.dtype(jnp.bfloat16):
        data_dtype = jnp.bfloat16
        dtype = jnp.dtype(jnp.float32)
        precision = jax.lax.Precision.DEFAULT
        kernel_precision = None  # operands are bf16 already

    # Accept device-resident arrays without a host round-trip.
    def _to_backend(A):
        A = _densify(A)
        if isinstance(A, jax.Array):
            return A.astype(dtype)
        return np.asarray(A, dtype=dtype)

    if packed_input is None and not (sparse_masked or sparse_mesh):
        Y = _to_backend(Y)
    if mask is not None and not (sparse_masked or sparse_mesh):
        mask = _to_backend(mask)

    # dir-beta == beta-dir on Y.T with factors swapped (reference
    # _solver.py:113-123); both init matrices must be given to be swapped.
    transposed = orientation == "dir-beta"
    if transposed:
        Y = Y.T
        if mask is not None:
            mask = mask.T
        if (W_init is None) != (H_init is None):
            # The factor swap onto the transposed problem is only defined
            # for the pair; the reference silently mis-assigns a lone
            # factor (square data) or fails with a confusing shape error.
            raise ValueError(
                "orientation='dir-beta' with a custom init requires BOTH "
                "W_init and H_init"
            )
        if W_init is not None and H_init is not None:
            W_init, H_init = np.asarray(H_init).T, np.asarray(W_init).T

    m, n = Y.shape
    k = int(n_components)

    # ------------------------------------------------------------------ RNG
    if random_state is None:
        seed = int(np.random.SeedSequence().entropy % (2**63))
    else:
        seed = int(random_state)
    key = jax.random.PRNGKey(seed)

    custom_init = W_init is not None or H_init is not None
    if custom_init and n_init > 1:
        raise ValueError("n_init > 1 is incompatible with explicit W_init/H_init")

    if custom_init:
        kw, kh = jax.random.split(key)
        # Device-resident inits stay in place (no host round-trip — e.g.
        # warm-starting from a previous solve(device_results=True)).
        if W_init is None:
            W0_ext = jax.random.uniform(kw, (1, m, k), dtype=dtype, minval=0.1, maxval=0.9)
        elif isinstance(W_init, jax.Array):
            W0_ext = W_init.astype(dtype)[None]
        else:
            W0_ext = jnp.asarray(np.asarray(W_init, dtype=dtype))[None]
        if H_init is None:
            H0 = jax.random.uniform(kh, (1, k, n), dtype=dtype, minval=0.1, maxval=0.9)
        elif isinstance(H_init, jax.Array):
            H0 = H_init.astype(dtype)[None]
        else:
            H0 = jnp.asarray(np.asarray(H_init, dtype=dtype))[None]
    else:
        W0_ext, H0 = _random_uniform_inits(key, n_init, m, n, k, dtype)

    if W0_ext.shape[1:] != (m, k):
        raise ValueError(f"W_init must have shape {(m, k)}, got {W0_ext.shape[1:]}")
    if H0.shape[1:] != (k, n):
        raise ValueError(f"H_init must have shape {(k, n)}, got {H0.shape[1:]}")

    # Internal layout: W is (k, m) with unit column sums (_solver.py:132-136).
    # The renorm is guarded like the in-loop simplex step: a returned factor
    # legitimately carries all-zero simplex vectors for fully-unobserved
    # samples (pinned contract), so warm-starting from it (resume_fit, or
    # W_init=prev.W) must not divide 0/0 — zero columns stay exactly zero
    # and contribute nothing, matching what a fresh fit returns for them.
    # For positive sums the guard returns the sum unchanged, so every
    # previously-valid init renormalizes bit-identically.
    W0 = jnp.swapaxes(W0_ext, 1, 2)
    W0_sums = W0.sum(axis=1, keepdims=True)
    W0 = W0 / jnp.where(W0_sums > 0, W0_sums, 1.0)

    if mask is None:
        n_obs = jnp.array(m * n, dtype=dtype)
    else:
        # Count host-side masks on the host — jnp.count_nonzero on a numpy
        # mask would ship the whole dense array to the device just to count.
        if sparse_masked or sparse_mesh:
            # Canonical binary CSR: stored nonzeros ARE the observed count.
            n_obs = jnp.array(mask.count_nonzero(), dtype=dtype)
        elif isinstance(mask, np.ndarray):
            n_obs = jnp.array(np.count_nonzero(mask), dtype=dtype)
        else:
            n_obs = jnp.count_nonzero(mask).astype(dtype)
        if float(n_obs) == 0.0:
            # Pinned contract (the reference divides by zero silently,
            # _solver.py:162): a mask with no observed entries makes the
            # per-entry objective undefined — reject it up front.
            raise ValueError(
                "mask has no observed entries (all zeros): the per-entry "
                "objective is undefined with n_obs == 0"
            )
    n_real = jnp.array(n, dtype=dtype)

    use_pallas = _resolve_backend(backend, dtype, user_precision)
    Vn_gspmd = None  # GSPMD shard-padding column validity (jnp mesh path)
    gspmd_padded = False

    if return_all and n_init <= 1:
        raise ValueError("return_all requires n_init > 1")

    # ``packed=True`` is an explicit demand, validated for EVERY routing up
    # front (auto-packing below remains silent best-effort): it needs the
    # fused data-streaming kernels, and it replaces the data stream
    # entirely, so combining it with bf16 data storage is contradictory.
    if packed is True:
        if not use_pallas:
            raise ValueError(
                "packed=True requires the Pallas backend (backend='pallas', "
                "or 'auto' resolving to it on the GPU with dtype <= float32)"
            )
        if data_dtype is not None:
            raise ValueError(
                "packed=True is incompatible with dtype='bfloat16': packing "
                "replaces the data stream (and is both smaller and exact)"
            )

    if packed_input is not None:
        if not use_pallas:
            raise ValueError(
                "PackedMatrix input requires the Pallas backend "
                "(backend='pallas', or 'auto' resolving to it on the GPU)"
            )
        Ym = Ym2 = Yc = None  # the data exists only as packed words
    elif sparse_mesh:
        Ym = Ym2 = Yc = None  # the data exists only as pre-packed words
    elif use_pallas and mesh is None:
        # Memory-frugal operand construction for the fused kernels: build
        # only the arrays the kernels actually read (the parity-mode
        # complement is formed in registers), and cast to the bf16 data
        # dtype BEFORE any padding so no full-size f32 copies linger — at
        # 1e9-entry scale the difference is several GB of device memory.
        # HOST inputs stay numpy here: if the packing decision below fires,
        # the data then crosses to the device as bit-plane words at 1/32 of
        # the bytes (device-resident inputs keep the on-device path).
        host_side = (
            data_dtype is None
            and isinstance(Y, np.ndarray)
            and (mask is None or isinstance(mask, np.ndarray))
        )
        if sparse_masked:
            # Both packed operands built sparsely (never dense): Ym = Y*mask;
            # Ym2 = (1-Y)*mask == mask - Ym.  Canonical binary CSRs in, so
            # both results are exactly binary by construction; they pack to
            # words in the staging block below.
            Ym = Y.multiply(mask).tocsr()
            Ym2 = (mask - Ym).tocsr()
            Yc = Ym2 if mask_mode == "corrected" else None
        elif host_side:
            if mask is None:
                Ym, Ym2, Yc = Y, None, None
            else:
                # Y/mask were cast to the (<= f32) compute dtype by
                # _to_backend above, so these host temporaries stay f32 —
                # no f64 promotion even for int/bool inputs.
                Ym = Y * mask
                Ym2 = (1.0 - Y) * mask
                Yc = Ym2 if mask_mode == "corrected" else None
        else:
            Yj = jnp.asarray(Y)
            if data_dtype is not None:
                Yj = Yj.astype(data_dtype)
            if mask is None:
                Ym, Ym2, Yc = Yj, None, None
            else:
                mj = jnp.asarray(mask).astype(Yj.dtype)
                Ym = Yj * mj
                Ym2 = (1.0 - Yj) * mj
                Yc = Ym2 if mask_mode == "corrected" else None
    else:
        Ym, Ym2, Yc = precompute_masked_terms(
            jnp.asarray(Y), None if mask is None else jnp.asarray(mask), mask_mode
        )
        # Optional GSPMD placement over a device mesh (jnp path).  Operands
        # are zero-padded to mesh-divisible shapes so every axis really
        # shards (non-divisible axes used to silently replicate); the
        # returned Vn masks the pad columns out of the Beta-prior sums and
        # gspmd_padded gates the final result slicing.
        if mesh is not None and not use_pallas:
            from ..parallel.sharding import shard_solver_operands

            Ym, Ym2, Yc, W0, H0, Vn_gspmd, (Mp_g, Np_g) = shard_solver_operands(
                Ym, Ym2, Yc, W0, H0, mesh=mesh, mesh_axes=mesh_axes
            )
            gspmd_padded = (Mp_g, Np_g) != (m, n)

    if max_iter <= 0:
        # Graceful degenerate case (the reference raises NameError here):
        # return the (normalized) initial factors untouched.
        W_final = np.asarray(W0[0]).T
        H_final = np.asarray(H0[0])
        if transposed:
            W_final, H_final = H_final.T, W_final.T
        return SolverResult(
            W=W_final, H=H_final, losses=[], time_elapsed=time.time() - t_start,
            n_iter=0, converged=False, seed=seed,
        )

    if use_pallas and mesh is not None:
        # Multi-device fast path: per-shard fused kernels + explicit psums;
        # the n_init restart axis is vmapped inside the shard_map.
        from .sharded import pack_words_for_mesh, solve_core_sharded

        if sparse_mesh:
            # Binaryness was validated in the sparse intercept; now do the
            # deferred packing — every cheap argument validation has passed,
            # so this host work cannot be wasted.
            sparse_words = pack_words_for_mesh(
                Y, mask, mesh=mesh, mesh_axes=mesh_axes,
                block_m=block_m, block_n=block_n, mask_mode=mask_mode,
            )
            pk_sharded = True
        else:
            sparse_words = None
            pk_sharded = (
                packed is not False
                and data_dtype is None
                and _exactly_binary(Ym)
                and _exactly_binary(Ym2)
            )
            if packed is True and not pk_sharded:
                raise ValueError(
                    "packed=True requires exactly binary data (and mask)"
                )
        Wb, Hb, losses_b, n_iter_b, final_loss_b, done_b = solve_core_sharded(
            Ym, Ym2, Yc, W0, H0,
            jnp.array(alpha, dtype=dtype),
            jnp.array(beta, dtype=dtype),
            jnp.array(tol, dtype=dtype),
            n_obs,
            mesh=mesh,
            mesh_axes=mesh_axes,
            max_iter=max_iter,
            projection=projection,
            eps=float(eps),
            m_real=m,
            n_real=n,
            block_m=block_m,
            block_n=block_n,
            interpret=pallas_interpret,
            data_dtype=data_dtype,
            packed=pk_sharded,
            kernel_precision=kernel_precision,
            packed_words=sparse_words,
        )
        best = int(jnp.argmin(final_loss_b)) if n_init > 1 else 0
        all_final = np.asarray(final_loss_b) if n_init > 1 else None
        W_dev, H_dev, losses_dev, n_iter_dev, done_dev = (
            Wb[best], Hb[best], losses_b[best], n_iter_b[best], done_b[best]
        )
        result = _package_result(
            W_dev, H_dev, losses_dev, n_iter_dev, done_dev, best, all_final,
            transposed=transposed, verbose=verbose, max_iter=max_iter,
            t_start=t_start, seed=seed, to_host=not device_results,
        )
        if return_all:
            # solve_core_sharded returns every restart (already unpadded);
            # the 10-init protocol runs end-to-end on the multi-device fast
            # path just like on the single-device paths.
            _attach_all_results(
                result,
                (Wb, Hb, losses_b, n_iter_b, final_loss_b, done_b),
                m=m, n=n, sliced=False, transposed=transposed,
            )
        return result

    if use_pallas:
        from ..ops import pallas_sweep as ps

        Mp, Np = ps.padded_dims(m, n, block_m, block_n)
        pad_last = lambda A, t: jnp.pad(A, [(0, 0)] * (A.ndim - 1) + [(0, t - A.shape[-1])])
        W0p, H0p = pad_last(W0, Mp), pad_last(H0, Np)
        if packed_input is not None:
            # Pre-packed input: the words ARE the data operand; zero word
            # rows/columns are zero data rows/columns, so padding is exact.
            Ymp = ps.pad_to(jnp.asarray(packed_input.words), Mp // ps.WORD_BITS, Np)
            Ym2p = Ycp = None
            use_packed = True
        elif sparse_masked:
            # Binary operands by construction: pack each sparse operand from
            # row chunks — one transient dense chunk at a time, never the
            # full matrix.
            from ..ops.packed import pack_sparse_words

            Ymp = jnp.asarray(pack_sparse_words(Ym, Mp, Np))
            Ym2p = jnp.asarray(pack_sparse_words(Ym2, Mp, Np))
            Ycp = Ym2p if Yc is not None else None
            use_packed = True
        else:
            Ymp, Ym2p, Ycp, use_packed = _stage_fused_operands(
                Ym, Ym2, Yc, Mp, Np, packed=packed, data_dtype=data_dtype
            )
        core = partial(
            _solve_core_pallas,
            max_iter=max_iter,
            projection=projection,
            verbose=verbose if n_init == 1 else 0,
            eps=float(eps),
            m_real=m,
            n_real=n,
            block_m=block_m,
            block_n=block_n,
            interpret=pallas_interpret,
            packed=use_packed,
            kernel_precision=kernel_precision,
        )
        data = (Ymp, Ym2p, Ycp)
        inits = (W0p, H0p)
        hypers = (
            jnp.array(alpha, dtype=dtype),
            jnp.array(beta, dtype=dtype),
            jnp.array(tol, dtype=dtype),
            n_obs,
        )
    else:
        core = partial(
            _solve_core,
            max_iter=max_iter,
            projection=projection,
            precision=precision,
            verbose=verbose if n_init == 1 else 0,
        )
        data = (Ym, Ym2, Yc)
        inits = (W0, H0)
        hypers = (
            jnp.array(alpha, dtype=dtype),
            jnp.array(beta, dtype=dtype),
            jnp.array(tol, dtype=dtype),
            jnp.array(eps, dtype=dtype),
            n_obs,
            n_real,
            Vn_gspmd,
        )

    all_results = None
    if n_init == 1:
        W_dev, H_dev, losses_dev, n_iter_dev, final_loss_dev, done_dev = core(
            *data, inits[0][0], inits[1][0], *hypers
        )
        best = 0
        all_final = None
    else:
        from ..parallel.restarts import vmapped_solve

        (
            (W_dev, H_dev, losses_dev, n_iter_dev, final_loss_dev, done_dev),
            best,
            all_final,
            all_results,
        ) = vmapped_solve(core, data, inits, hypers, keep_all=return_all)

    if use_pallas or gspmd_padded:
        W_dev = W_dev[:, :m]
        H_dev = H_dev[:, :n]

    result = _package_result(
        W_dev, H_dev, losses_dev, n_iter_dev, done_dev, best, all_final,
        transposed=transposed, verbose=verbose, max_iter=max_iter,
        t_start=t_start, seed=seed, to_host=not device_results,
    )
    if all_results is not None:
        _attach_all_results(
            result, all_results, m=m, n=n,
            sliced=use_pallas or gspmd_padded, transposed=transposed,
        )
    return result


def _attach_all_results(result, all_results, *, m, n, sliced, transposed):
    """Populate ``result.extras`` with every restart's factors/trace (the
    ``return_all`` contract shared by the single-device and sharded paths)."""
    aW, aH, a_losses, a_niter, _, a_done = all_results
    aW = np.asarray(aW)  # internal (n_init, k, m), possibly padded
    aH = np.asarray(aH)
    if sliced:
        aW, aH = aW[:, :, :m], aH[:, :, :n]
    all_W = np.swapaxes(aW, 1, 2)  # external (n_init, m, k)
    all_H = aH
    if transposed:
        all_W, all_H = np.swapaxes(all_H, 1, 2), np.swapaxes(all_W, 1, 2)
    result.extras.update(
        all_W=all_W,
        all_H=all_H,
        all_n_iter=np.asarray(a_niter),
        all_losses=np.asarray(a_losses),
        all_converged=np.asarray(a_done),
    )


def _package_result(
    W_dev, H_dev, losses_dev, n_iter_dev, done_dev, best, all_final,
    *, transposed, verbose, max_iter, t_start, seed, to_host: bool = True,
) -> SolverResult:
    """Restore external notation/orientation and apply the final simplex
    safeguard.  ``to_host=True`` (default) pulls the factors to numpy in a
    single host sync; ``to_host=False`` (``solve(device_results=True)``)
    leaves ``W``/``H``/``losses`` as device arrays — only the scalar
    ``n_iter``/``converged``/drift syncs happen, so no O(m*k) bytes cross
    the device link."""
    if to_host:
        W_int = np.asarray(W_dev)
        H_final = np.asarray(H_dev)
        losses_buf = np.asarray(losses_dev)
    else:
        W_int, H_final, losses_buf = W_dev, H_dev, losses_dev
    n_iter = int(n_iter_dev)
    converged = bool(done_dev)

    W_final = W_int.T  # back to external (m, k)
    if transposed:
        W_final, H_final = H_final.T, W_final.T

    W_final, H_final = _final_simplex_safeguard(
        W_final, H_final, "dir-beta" if transposed else "beta-dir"
    )

    if to_host:
        losses = [float(x) for x in losses_buf[:n_iter]]
    else:
        losses = losses_buf[:n_iter]
    if verbose > 0 and converged and n_iter < max_iter:
        print(f"Converged at iteration {n_iter - 1}")

    return SolverResult(
        W=W_final,
        H=H_final,
        losses=losses,
        time_elapsed=time.time() - t_start,
        n_iter=n_iter,
        converged=converged,
        best_restart=int(best),
        all_final_losses=None if all_final is None else np.asarray(all_final),
        seed=seed,
    )


def nbmf_mm_solver(
    Y,
    n_components: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    alpha: float = 1.2,
    beta: float = 1.2,
    W_init=None,
    H_init=None,
    mask=None,
    random_state: Optional[int] = None,
    verbose: int = 0,
    orientation: str = "beta-dir",
    eps: float = 1e-8,
    **kwargs,
):
    """Drop-in replacement for the reference ``nbmf_mm_solver``
    (``src/nbmf_mm/_solver.py:61-216``; exported publicly,
    ``src/nbmf_mm/__init__.py:11,17``).

    Returns ``(W, H, losses, time_elapsed, n_iter)``.  Unlike the reference,
    ``time_elapsed`` is the real wall time rather than a hard-coded ``0.0``.
    Extra keyword arguments are forwarded to :func:`solve` (``n_init``,
    ``projection``, ``mask_mode``, ``dtype``, ``precision``, ``mesh``, ...).
    """
    res = solve(
        Y,
        n_components,
        max_iter=max_iter,
        tol=tol,
        alpha=alpha,
        beta=beta,
        W_init=W_init,
        H_init=H_init,
        mask=mask,
        random_state=random_state,
        verbose=verbose,
        orientation=orientation,
        eps=eps,
        **kwargs,
    )
    return res.W, res.H, res.losses, res.time_elapsed, res.n_iter
