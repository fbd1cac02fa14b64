"""Shared window-stencil construction: per-point linear indices and
tensor-product weights over the ``(2M)^D`` spreading stencil.

Used by both the reference (pure-jnp scatter/gather) spreading and
interpolation paths.  Counterpart of the index/value computation in the
reference's get_inds_vals_gpu (src/gpu_common.jl:101-116) and
spread_onto_arrays_gpu! (src/spreading/gpu.jl:43-127), re-shaped for SIMD: all
points in a chunk are processed at once along a leading axis.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

from . import windows
from .windows import KernelData, EvaluationMode


def wrap_indices(idx: jnp.ndarray, n: int) -> jnp.ndarray:
    """Branchless periodic wrap for indices in ``[-n, 2n)`` (the reference's
    kernel_indices wrap, src/Kernels/Kernels.jl:148-158; valid since the plan
    guarantees 2M <= N)."""
    idx = jnp.where(idx < 0, idx + n, idx)
    return jnp.where(idx >= n, idx - n, idx)


def stencil_from_cells(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    cells: jnp.ndarray,  # (D, P) int32 cell indices in [0, N)
    fracs: jnp.ndarray,  # (D, P) in-cell fractions in [0, 1)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Flattened stencil of each point from its cell split.

    Returns ``(lin, w)`` with shapes ``(P, S)`` where ``S = prod(2M_d)``:
    ``lin`` are linear indices into the flattened (row-major) oversampled grid
    and ``w`` the tensor-product window weights.
    """
    lin = None
    w = None
    for d, kd in enumerate(kernel_data):
        two_m = 2 * kd.m
        vals = windows.eval_window_frac(kd, evalmode, fracs[d])  # (P, 2M)
        t = jnp.arange(two_m, dtype=jnp.int32)
        start = cells[d] - (kd.m - 1)
        idx = wrap_indices(start[:, None] + t[None, :], kd.n)  # (P, 2M)
        if lin is None:
            lin, w = idx, vals
        else:
            lin = (lin[:, :, None] * kd.n + idx[:, None, :]).reshape(lin.shape[0], -1)
            w = (w[:, :, None] * vals[:, None, :]).reshape(w.shape[0], -1)
    return lin, w


def linear_stencil(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    points: jnp.ndarray,  # (D, P)
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Flattened stencil for each point (see :func:`stencil_from_cells`).

    The cell split is the high-accuracy one (point_to_cell_split): in f32
    the naive ``(x/L)*N`` costs N*2^-24 cells of position noise, the
    accuracy floor of the whole transform."""
    cs, xs = zip(
        *(windows.point_to_cell_split(points[d], kd.n)
          for d, kd in enumerate(kernel_data))
    )
    return stencil_from_cells(kernel_data, evalmode, jnp.stack(cs), jnp.stack(xs))
