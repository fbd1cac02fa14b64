"""Type-2 interpolation: gather oversampled grid values at non-uniform points.

Pure-jnp implementation; transpose of ops/spreading.py.  Counterpart of the
reference's src/interpolation/cpu_nonblocked.jl, with the cell-volume
prefactor ``prod(2pi / N~)`` applied at the gather (cpu_nonblocked.jl:45-48,
interpolation/gpu.jl:55-56).  The blocked method calls
:func:`interpolate_cells` on its bin-sorted points, so neighbouring points
gather from neighbouring grid memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from .spreading import balanced_chunks
from .stencil import linear_stencil, stencil_from_cells
from .windows import KernelData, EvaluationMode


def _chunked_gather(grid, prefactor, stencil, args, np_: int,
                    chunk_size: Optional[int]) -> jnp.ndarray:
    """``sum_S grid[lin] * w`` per point, ``stencil(*chunk_args) -> (lin,
    w)``; at most ``chunk_size`` points' stencils exist at once."""
    C = grid.shape[0]
    gflat = grid.reshape(C, -1)
    pref = jnp.asarray(prefactor, dtype=grid.real.dtype)

    def gather(*chunk):
        lin, w = stencil(*chunk)
        vals = gflat[:, lin]  # (C, P, S)
        return jnp.sum(vals * w[None], axis=-1) * pref

    if chunk_size is None or chunk_size >= np_:
        return gather(*args)

    nchunks, chunk = balanced_chunks(np_, chunk_size)
    np_pad = nchunks * chunk
    split = [
        jnp.moveaxis(
            jnp.pad(a, ((0, 0), (0, np_pad - np_))).reshape(
                a.shape[0], nchunks, chunk
            ),
            1, 0,
        )
        for a in args
    ]

    def body(_, chunk):
        return None, gather(*chunk)

    _, out = jax.lax.scan(body, None, tuple(split))  # (nchunks, C, chunk)
    return jnp.moveaxis(out, 0, 1).reshape(C, np_pad)[:, :np_]


def interpolate_reference(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    grid: jnp.ndarray,  # (C,) + shape_over, real or complex
    points: jnp.ndarray,  # (D, Np), folded
    prefactor: float,
    *,
    chunk_size: Optional[int] = None,
) -> jnp.ndarray:
    """Returns values at points, shape (C, Np)."""
    return _chunked_gather(
        grid, prefactor, lambda p: linear_stencil(kernel_data, evalmode, p),
        (points,), points.shape[1], chunk_size,
    )


def interpolate_cells(
    kernel_data: Sequence[KernelData],
    evalmode: EvaluationMode,
    grid: jnp.ndarray,  # (C,) + shape_over, real or complex
    cells: jnp.ndarray,  # (D, Np) int32
    fracs: jnp.ndarray,  # (D, Np)
    prefactor: float,
    *,
    chunk_size: Optional[int] = None,
) -> jnp.ndarray:
    """:func:`interpolate_reference` from a precomputed cell split (the
    blocked method's sorted point state).  Returns (C, Np)."""
    return _chunked_gather(
        grid, prefactor,
        lambda c, x: stencil_from_cells(kernel_data, evalmode, c, x),
        (cells, fracs), cells.shape[1], chunk_size,
    )
