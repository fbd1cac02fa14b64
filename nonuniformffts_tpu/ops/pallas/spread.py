"""Blocked type-1 spreading: a Pallas kernel through Triton.

This is the shared-memory (SM) method of the reference's GPU spreading
(src/spreading/gpu.jl:237-434) and of cuFINUFFT: points are bin-sorted by
spatial block at ``set_points`` time, and one program owns one block.  The
program walks its block's points in batches of ``BP`` and adds every
point's (2M)^D window into a padded block accumulator that lives on chip;
the padded block is then written out once.  No two programs write the same
bytes, so the kernel needs no atomics, and the periodic halo merge is the
deterministic jnp pass :func:`common.overlap_add`.

Inside a batch the tensor-product window becomes dense linear algebra:
dim 0's weights form a (pd0, BP) matrix scaled by the point values, dims
1..D-1 form a (BP, pd1*..*pd_{D-1}) Khatri-Rao product, and one matrix
product per channel adds the whole batch to the accumulator.  Padded block
extents are powers of two (Triton's block shapes), at least 16 wide (the
smallest matrix-product operand), and large enough for the core B plus the
2M-1 halo rows.

Window values are evaluated outside the kernel in jnp (any kernel family
and evaluation mode), so the kernel only reads per-point local cells,
weights and values.  The kernel takes float32 only: Pallas's Triton route
accumulates matrix products in float32, so 64-bit plans use the jnp path.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import windows
from .common import overlap_add

#: Smallest padded block extent: Triton's matrix product needs every
#: operand dimension >= 16.
MIN_PADDED = 16
#: Points per inner-loop step.  Larger batches keep a (BP, pd1*pd2)
#: Khatri-Rao operand in registers that spills (measured on an H100:
#: BP=16 beats 32 and 64 at every density; PERF.md).
BATCH_SIZE = 16


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def padded_extent(b: int, m: int) -> int:
    """Padded block extent for core size ``b``: core + 2M-1 halo rows,
    rounded up to a power of two, at least :data:`MIN_PADDED`."""
    return max(MIN_PADDED, _next_pow2(b + 2 * m - 1))


def choose_block_dims(shape_over: Sequence[int], m: int) -> Tuple[int, ...]:
    """Per-dim block core sizes for the oversampled grid.

    Each core must divide its grid axis (the overlap-add is a pure roll)
    and be >= M (halos reach immediate neighbours only).  The padded
    extent is the smallest power of two that holds 3M-1 rows; the core is
    the largest divisor that fits in it, which keeps the halo share and the
    on-chip accumulator small."""
    out = []
    for n in shape_over:
        pd = padded_extent(m, m)
        while True:
            cands = [
                b for b in range(m, min(n, pd - 2 * m + 1) + 1) if n % b == 0
            ]
            if cands:
                out.append(max(cands))
                break
            pd *= 2
    return tuple(out)


def check_block_dims(block_dims, shape_over, m: int) -> Tuple[int, ...]:
    """Validate user-given block cores (see :func:`choose_block_dims`)."""
    if len(block_dims) != len(shape_over):
        raise ValueError(
            f"block_dims {block_dims} must have one entry per dimension"
        )
    for b, n in zip(block_dims, shape_over):
        if n % b != 0:
            raise ValueError(
                f"block dim {b} must divide the oversampled grid size {n}"
            )
        if b < m:
            raise ValueError(
                f"block dim {b} must be >= the kernel half-support M={m} "
                "(halos may only touch immediate neighbour blocks)"
            )
    return tuple(block_dims)


def padded_buffer_bytes(shape_over, m: int, channels: int,
                        block_dims=None) -> int:
    """Bytes of the kernel's output: one float32 padded block per block
    and real channel (about 8x the grid's own bytes with 8^3 cores)."""
    if block_dims is None:
        block_dims = choose_block_dims(shape_over, m)
    blocks = 1
    for n, b in zip(shape_over, block_dims):
        blocks *= (n // b) * padded_extent(b, m)
    return 4 * channels * blocks


def _weight_matrix(cells_ref, w_ref, d, off, mask, *, m, B, pd, BP,
                   transposed):
    """Window weights of one dim scattered into padded-block rows.

    Row ``i`` of point ``p`` holds the weight of padded row ``i`` in the
    core-first layout (tap t of local cell c lands on j = c - M + 1 + t,
    negative j wrap to the left-halo tail rows B + 2M - 1 + j).  Returns
    (pd, BP), or (BP, pd) when ``transposed``."""
    H = 2 * m - 1
    c = plgpu.load(cells_ref.at[d, pl.ds(off, BP)], mask=mask,
                   other=jnp.int32(0))
    rows = jnp.arange(pd, dtype=jnp.int32)
    shape = (BP, pd) if transposed else (pd, BP)
    acc = jnp.zeros(shape, jnp.float32)
    for t in range(2 * m):
        wt = plgpu.load(w_ref.at[d, t, pl.ds(off, BP)], mask=mask,
                        other=jnp.float32(0))
        j = c - (m - 1) + t
        i = jnp.where(j < 0, j + B + H, j)
        if transposed:
            acc = jnp.where(rows[None, :] == i[:, None], wt[:, None], acc)
        else:
            acc = jnp.where(rows[:, None] == i[None, :], wt[None, :], acc)
    return acc


def _spread_kernel(pstarts_ref, cells_ref, w_ref, v_ref, out_ref, *, D, m,
                   block_dims, padded, BP, CG):
    b = pl.program_id(0)
    g = pl.program_id(1)
    start = pstarts_ref[b]
    end = pstarts_ref[b + 1]
    nbatch = (end - start + BP - 1) // BP
    lanes = jnp.arange(BP, dtype=jnp.int32)
    wm = functools.partial(_weight_matrix, cells_ref, w_ref, m=m, BP=BP)
    rest = 1
    for p in padded[1:]:
        rest *= p

    def body(k, accs):
        off = start + k * BP
        mask = off + lanes < end
        wx = wm(0, off, mask, B=block_dims[0], pd=padded[0], transposed=False)
        rhs = None
        if D >= 2:
            rhs = wm(1, off, mask, B=block_dims[1], pd=padded[1],
                     transposed=True)
        if D == 3:
            wz = wm(2, off, mask, B=block_dims[2], pd=padded[2],
                    transposed=True)
            rhs = (rhs[:, :, None] * wz[:, None, :]).reshape(BP, rest)
        lhs = []
        for ci in range(CG):
            v = plgpu.load(
                v_ref.at[g * CG + ci, pl.ds(off, BP)], mask=mask,
                other=jnp.float32(0),
            )
            lhs.append(wx * v[None, :])
        if rhs is None:
            return tuple(a + jnp.sum(x, axis=1) for a, x in zip(accs, lhs))
        # Full float32 products: at the default precision an H100 takes
        # TF32 inputs, which keep about three digits.
        return tuple(
            a + pl.dot(x, rhs, precision=jax.lax.Precision.HIGHEST)
            for a, x in zip(accs, lhs)
        )

    acc_shape = (padded[0],) if D == 1 else (padded[0], rest)
    init = tuple(jnp.zeros(acc_shape, jnp.float32) for _ in range(CG))
    accs = jax.lax.fori_loop(0, nbatch, body, init)
    for ci in range(CG):
        out_ref[g * CG + ci, b, :] = accs[ci].reshape(padded[0] * rest)


def spread_padded_blocks(
    pstarts: jnp.ndarray,  # (nblocks + 1,) int32 sorted-point ranges
    local_cells: jnp.ndarray,  # (D, Np) int32 cell within the block
    weights: jnp.ndarray,  # (D, 2M, Np) f32 window values
    vals: jnp.ndarray,  # (CR, Np) f32 values, same (sorted) order
    *,
    m: int,
    block_dims: Tuple[int, ...],
    interpret: bool = False,
) -> jnp.ndarray:
    """Run the kernel: returns the padded block buffer
    (CR, nblocks, prod(padded extents)).  Arrays along the point axis must
    extend :data:`BATCH_SIZE` lanes past the last point (masked loads of
    the final batch stay in bounds)."""
    D = local_cells.shape[0]
    CR = vals.shape[0]
    nblocks = pstarts.shape[0] - 1
    padded = tuple(padded_extent(b, m) for b in block_dims)
    vol = 1
    for p in padded:
        vol *= p
    CG = 2 if CR % 2 == 0 else 1
    kernel = functools.partial(
        _spread_kernel, D=D, m=m, block_dims=tuple(block_dims),
        padded=padded, BP=BATCH_SIZE, CG=CG,
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((CR, nblocks, vol), jnp.float32),
        grid=(nblocks, CR // CG),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="nufft_spread_blocked",
    )(pstarts, local_cells, weights, vals)


def spread_blocked(plan, vp_ch: jnp.ndarray) -> jnp.ndarray:
    """Type-1 spreading of a blocked plan.

    ``vp_ch``: (CR, Np) real channels in the caller's point order (complex
    values as interleaved (re, im) pairs per transform).  Returns the
    oversampled grid (CR,) + shape_over."""
    D = plan.ndim
    m = plan.m
    bd = plan.block_dims
    # Pad the point axis by one batch so the last batch's loads stay in
    # bounds; padding lanes are masked inside the kernel.
    pad = ((0, 0), (0, BATCH_SIZE))
    perm = jnp.pad(plan.sort_perm, (0, BATCH_SIZE))
    cells = jnp.pad(plan.cells, pad)
    fracs = jnp.pad(plan.fracs, pad)
    vals = jnp.take(vp_ch, perm, axis=1).astype(jnp.float32)
    local = jnp.stack([cells[d] % jnp.int32(bd[d]) for d in range(D)])
    weights = jnp.stack(
        [
            windows.eval_window_frac(kd, plan.evalmode, fracs[d]).T
            for d, kd in enumerate(plan.kernel_data)
        ]
    ).astype(jnp.float32)
    buf = spread_padded_blocks(
        plan.pstarts, local, weights, vals, m=m, block_dims=bd,
        interpret=plan.interpret,
    )
    padded = tuple(padded_extent(b, m) for b in bd)
    buf = buf.reshape((buf.shape[0],) + plan.num_blocks + padded)
    return overlap_add(buf, bd, m).astype(vp_ch.dtype)
