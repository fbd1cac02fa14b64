"""Device-side point bin-sorting into spatial blocks.

Counterpart of the reference's GPU blocking (src/blocking/gpu.jl): where the
reference runs four device kernels (atomic histogram -> prefix sum ->
scatter permutation -> optional point permutation), we compute block ids
from cell indices and run one multi-operand ``lax.sort`` that carries the
cell split and the original index along; a binary search over the sorted
ids then gives every block its *contiguous* range of sorted points, which
is what lets the spread kernel own its output block outright.

Consistency requirement carried over from the reference
(blocking/gpu.jl:145-160): the block id derives from the cell index that
the spread kernel itself uses, never from the block width directly, so a
point can never land outside its block's padded window.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .ops import windows


def cells_and_fracs(kernel_data, points: jnp.ndarray):
    """High-accuracy per-dim cell indices and in-cell fractions for raw
    (possibly unfolded) points (D, Np).  Returns ``(cells (D, Np) int32,
    fracs (D, Np))``; see windows.point_to_cell_split for why this is not
    just ``(x/L)*N``."""
    cs, xs = [], []
    for d, kd in enumerate(kernel_data):
        c, X = windows.point_to_cell_split(points[d], kd.n)
        cs.append(c)
        xs.append(X)
    return jnp.stack(cs), jnp.stack(xs)


def block_ids_from_cells(cells: jnp.ndarray, kernel_data, block_dims) -> jnp.ndarray:
    """Flattened (row-major) block id per point from per-dim cell indices —
    the exact same cells the kernel uses, so a point can never land outside
    its block's padded window (reference: blocking/gpu.jl:145-160)."""
    D = cells.shape[0]
    nb = [kd.n // b for kd, b in zip(kernel_data, block_dims)]
    bid = None
    for d in range(D):
        b = cells[d] // block_dims[d]
        bid = b if bid is None else bid * nb[d] + b
    return bid


def sort_into_blocks(kernel_data, block_dims: Sequence[int], points: jnp.ndarray):
    """Bin-sort raw points (D, Np) by spatial block.

    Returns ``(cells, fracs, perm, pstarts)``: the per-dim cells (int32)
    and in-cell fractions in sorted order, ``perm`` (Np,) the original
    index of each sorted point, and ``pstarts`` (nblocks + 1,) with block
    ``b`` owning sorted positions ``[pstarts[b], pstarts[b+1])`` (the
    reference's cumulative_npoints_per_block)."""
    D, np_ = points.shape
    cells, fracs = cells_and_fracs(kernel_data, points)
    bid = block_ids_from_cells(cells, kernel_data, block_dims).astype(jnp.int32)
    nblocks = int(np.prod([kd.n // b for kd, b in zip(kernel_data, block_dims)]))
    iota = jnp.arange(np_, dtype=jnp.int32)
    ops = jax.lax.sort(
        (bid,) + tuple(cells[d] for d in range(D))
        + tuple(fracs[d] for d in range(D)) + (iota,),
        num_keys=1,
    )
    pstarts = jnp.searchsorted(
        ops[0], jnp.arange(nblocks + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    cells_s = jnp.stack(ops[1 : 1 + D])
    fracs_s = jnp.stack(ops[1 + D : 1 + 2 * D])
    return cells_s, fracs_s, ops[-1], pstarts
