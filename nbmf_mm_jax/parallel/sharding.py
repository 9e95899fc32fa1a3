"""GSPMD sharding of the factorization over a device mesh.

The reference is a single-process NumPy library with no distributed machinery
(SURVEY.md §2.4).  The analogue of data/model parallelism for this
workload is sharding the data matrix ``V (m, n)`` and the factors over a 2-D
``jax.sharding.Mesh``:

- ``V`` (and the masked matrices) sharded ``P(rows, cols)``,
- internal ``W (k, m)`` sharded over its ``m`` axis ``P(None, rows)``,
- ``H (k, n)`` sharded over its ``n`` axis ``P(None, cols)``,
- the rank ``k`` (small) replicated.

Under ``jit`` XLA then inserts the collectives automatically: the H-update
contraction over ``m`` becomes a ``reduce_scatter``/``all_reduce`` along the
``rows`` axis (NCCL on GPUs), the W-update contraction over ``n`` the analogue
along ``cols``, and the masked observed-count normalizers are plain ``psum``s
— no host round-trips, exactly the GSPMD recipe from the scaling playbook.

These helpers only *place* arrays; the solver code is sharding-agnostic.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_solver_operands", "data_sharding", "factor_shardings"]


def make_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("rows", "cols"),
) -> Mesh:
    """Build a 2-D mesh over ``devices`` (default: all local devices).

    If ``shape`` is omitted the device count is factored as squarely as
    possible, preferring more shards along ``rows`` (the larger data axis in
    typical tall matrices).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (n // a, a)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def data_sharding(mesh: Mesh, mesh_axes: Tuple[str, str] = ("rows", "cols")) -> NamedSharding:
    """Sharding for the (m, n) data/mask matrices."""
    return NamedSharding(mesh, P(*mesh_axes))


def factor_shardings(
    mesh: Mesh, mesh_axes: Tuple[str, str] = ("rows", "cols"), batched: bool = False
) -> Tuple[NamedSharding, NamedSharding]:
    """Shardings for internal ``W (k, m)`` and ``H (k, n)`` (optionally with a
    leading replicated ``n_init`` axis)."""
    rows, cols = mesh_axes
    lead = (None,) if batched else ()
    w_spec = P(*lead, None, rows)
    h_spec = P(*lead, None, cols)
    return NamedSharding(mesh, w_spec), NamedSharding(mesh, h_spec)


def shard_solver_operands(Ym, Ym2, Yc, W0, H0, *, mesh: Mesh, mesh_axes=("rows", "cols")):
    """Pad-and-place the solver operands on the mesh.

    ``W0``/``H0`` have a leading ``n_init`` axis (replicated); data matrices
    shard over both axes.  Explicit ``device_put`` shardings require each
    global dimension to be divisible by its mesh-axis size, so non-divisible
    ``m``/``n`` are zero-padded up to the next multiple — every operand is
    then *really* sharded (a silently-replicated axis would put the full-size
    data on every device, defeating the sharding).  Zero pads contribute
    exactly nothing to the solver's contractions (zero data rows/cols, zero
    ``W0`` pad columns); only the Beta-prior sums over ``H`` see the pad
    columns, which the returned column-validity vector ``Vn`` masks out of
    the objective (:func:`nbmf_mm_jax.ops.updates.map_objective`).

    Returns ``(Ym, Ym2, Yc, W0, H0, Vn, (Mp, Np))`` where ``Vn`` is ``None``
    when no column padding was needed and ``(Mp, Np)`` is the padded global
    shape (equal to ``Ym.shape`` on divisible inputs).
    """
    rows, cols = mesh_axes
    m, n = Ym.shape
    n_rows, n_cols = mesh.shape[rows], mesh.shape[cols]
    Mp = -(-m // n_rows) * n_rows
    Np = -(-n // n_cols) * n_cols

    if (Mp, Np) != (m, n):
        pad_mn = lambda A: jnp.pad(A, ((0, Mp - m), (0, Np - n)))
        # Yc may alias Ym2 (unmasked / corrected case): pad once, reuse.
        same = Yc is Ym2
        Ym = pad_mn(Ym)
        Ym2 = pad_mn(Ym2)
        Yc = Ym2 if same else pad_mn(Yc)
        pad_last = lambda A, t: jnp.pad(
            A, [(0, 0)] * (A.ndim - 1) + [(0, t - A.shape[-1])]
        )
        W0 = pad_last(W0, Mp)  # zero pad columns of internal (b, k, m)
        H0 = pad_last(H0, Np)

    dsh = NamedSharding(mesh, P(rows, cols))
    wsh = NamedSharding(mesh, P(None, None, rows))
    hsh = NamedSharding(mesh, P(None, None, cols))
    Ym = jax.device_put(Ym, dsh)
    Ym2 = jax.device_put(Ym2, dsh)
    Yc = jax.device_put(Yc, dsh)
    W0 = jax.device_put(W0, wsh)
    H0 = jax.device_put(H0, hsh)
    Vn = None
    if Np != n:
        Vn = (jnp.arange(Np)[None, :] < n).astype(H0.dtype)
        Vn = jax.device_put(Vn, NamedSharding(mesh, P(None, cols)))
    return Ym, Ym2, Yc, W0, H0, Vn, (Mp, Np)
