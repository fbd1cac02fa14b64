"""Type-1 spreading: scatter non-uniform values onto the oversampled grid.

This module holds the *reference* (pure-jnp) implementation: an XLA
scatter-add over the flattened grid, chunked over points to bound the memory
of the materialised ``(chunk, (2M)^D)`` stencil tensors.  It runs on any JAX
backend and is the correctness oracle for the blocked Pallas kernel
(ops/pallas/spread.py), playing the role of the reference's non-blocked CPU
spreading (src/spreading/cpu_nonblocked.jl) — except vectorised instead of a
per-point loop.  On a GPU the scatter-add is the reference's global-memory
(GM) method: one atomic add per stencil node.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from .stencil import stencil_from_cells
from .windows import KernelData, EvaluationMode, point_to_cell_split


def balanced_chunks(np_: int, chunk_size: int):
    """(number of chunks, points per chunk) covering ``np_`` points in
    chunks of at most ``chunk_size``, padding fewer than one point per
    chunk (a bare ``ceil(np_ / chunk_size)`` split can nearly double the
    work: 1e6 points at chunk_size 915k pad to 1.83e6)."""
    nchunks = -(-np_ // chunk_size)
    return nchunks, -(-np_ // nchunks)


def spread_cells(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    shape_over: tuple,  # grid shape (N1~, ..., ND~)
    cells: jnp.ndarray,  # (D, Np) int32
    fracs: jnp.ndarray,  # (D, Np)
    vp: jnp.ndarray,  # (C, Np), real or complex
    *,
    chunk_size: Optional[int] = None,
) -> jnp.ndarray:
    """Spread from a precomputed cell split.  Returns the grid
    ``(C,) + shape_over`` with dtype of vp."""
    C, np_ = vp.shape
    ntot = 1
    for n in shape_over:
        ntot *= n

    def add(grid, c, x, v):
        lin, w = stencil_from_cells(kernel_data, evalmode, c, x)
        vals = w[None, :, :] * v[:, :, None]  # (C, P, S)
        return grid.at[:, lin.reshape(-1)].add(
            vals.reshape(C, -1), mode="drop", unique_indices=False
        )

    grid0 = jnp.zeros((C, ntot), dtype=vp.dtype)
    if chunk_size is None or chunk_size >= np_:
        return add(grid0, cells, fracs, vp).reshape((C,) + tuple(shape_over))

    # Chunked accumulation via lax.scan to bound peak memory, in equal
    # chunks of at most chunk_size points.  Padding points carry zero
    # values.
    nchunks, chunk = balanced_chunks(np_, chunk_size)
    pad = nchunks * chunk - np_

    def split(a):
        a = jnp.pad(a, ((0, 0), (0, pad)))
        return jnp.moveaxis(a.reshape(a.shape[0], nchunks, chunk), 1, 0)

    def body(grid, chunk):
        return add(grid, *chunk), None

    grid, _ = jax.lax.scan(body, grid0, (split(cells), split(fracs), split(vp)))
    return grid.reshape((C,) + tuple(shape_over))


def spread_reference(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    shape_over: tuple,  # oversampled grid shape (N1~, ..., ND~)
    points: jnp.ndarray,  # (D, Np), folded
    vp: jnp.ndarray,  # (C, Np), real or complex
    *,
    chunk_size: Optional[int] = None,
) -> jnp.ndarray:
    """Returns the oversampled grid ``(C,) + shape_over`` with dtype of vp."""
    cs, xs = zip(
        *(point_to_cell_split(points[d], kd.n)
          for d, kd in enumerate(kernel_data))
    )
    return spread_cells(
        kernel_data, evalmode, shape_over, jnp.stack(cs), jnp.stack(xs), vp,
        chunk_size=chunk_size,
    )
