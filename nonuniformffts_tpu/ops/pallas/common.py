"""Periodic halo merge for the blocked spread path (plain jnp).

The spread kernel (ops/pallas/spread.py) gives every spatial block a padded
accumulator of its own, so no two programs ever write the same bytes.  This
module folds those padded blocks back into the periodic oversampled grid —
the counterpart of the reference's block -> global merge
(src/spreading/cpu_blocked.jl:3-36), made deterministic by ownership.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def relayout_to_grid(blocks_major: jnp.ndarray, block_dims) -> jnp.ndarray:
    """(CR, nb0, .., nbD-1, B0, .., BD-1) -> (CR, N0, .., ND-1) via one XLA
    block-interleave transpose."""
    D = len(block_dims)
    CR = blocks_major.shape[0]
    nb = tuple(blocks_major.shape[1 : 1 + D])
    grid_shape = tuple(n * b for n, b in zip(nb, block_dims))
    perm = (0,) + tuple(
        x for d in range(D) for x in (1 + d, 1 + D + d)
    )
    return jnp.transpose(blocks_major, perm).reshape((CR,) + grid_shape)


def overlap_add(blocks: jnp.ndarray, block_dims, m: int) -> jnp.ndarray:
    """Merge padded per-block accumulators into the periodic grid.

    ``blocks``: (CR, nb0, .., nbD-1, p0, .., pD-1) in the **core-first**
    layout: along each dim, rows [0, B) are the block's core, [B, B+M) the
    right halo (the next block's head), [B+M, B+2M-1) the left halo (the
    previous block's tail), and any rows past B+2M-1 are zero padding.

    Decomposition:

    1. core = slice -> one XLA block-interleave transpose;
    2. for each dim d, the halo slab (2M-1 rows, core extents in dims < d,
       padded extents in dims > d) is first self-merged over its trailing
       dims (small arrays), then split into right/left parts, rolled across
       the block axis, transposed to a thin interleaved grid and
       zero-padded to stripe width;
    3. one fused elementwise sum adds core + 2D thin contributions.

    Returns (CR, N0~, N1~, ...).
    """
    D = len(block_dims)
    H = 2 * m - 1

    # Peel: core (all dims [0, B)) and per-dim halo slabs.
    core = blocks
    slabs = []
    for d in range(D):
        p_ax = 1 + D + d
        B = block_dims[d]
        slabs.append(jax.lax.slice_in_dim(core, B, B + H, axis=p_ax))
        core = jax.lax.slice_in_dim(core, 0, B, axis=p_ax)

    contributions = [relayout_to_grid(core, block_dims)]
    grid_shape = contributions[0].shape

    for d in range(D):
        slab = slabs[d]
        # Self-merge the slab's trailing padded dims (e > d): its halo rows
        # there belong to dim-e neighbours at the same dim-d halo position.
        for e in range(d + 1, D):
            p_ax_e = 1 + D + e
            nb_ax_e = 1 + e
            Be = block_dims[e]
            right_e = jnp.roll(
                jax.lax.slice_in_dim(slab, Be, Be + m, axis=p_ax_e), 1,
                axis=nb_ax_e,
            )
            left_e = jnp.roll(
                jax.lax.slice_in_dim(slab, Be + m, Be + H, axis=p_ax_e), -1,
                axis=nb_ax_e,
            )
            slab = jax.lax.slice_in_dim(slab, 0, Be, axis=p_ax_e)
            idx = [slice(None)] * slab.ndim
            idx[p_ax_e] = slice(0, m)
            slab = slab.at[tuple(idx)].add(right_e)
            if m > 1:
                idx[p_ax_e] = slice(Be - (m - 1), Be)
                slab = slab.at[tuple(idx)].add(left_e)
        # Split halo rows: right (m rows -> next block's head), left
        # (m-1 rows -> previous block's tail).
        p_ax_d = 1 + D + d
        nb_ax_d = 1 + d
        Bd = block_dims[d]
        right = jnp.roll(
            jax.lax.slice_in_dim(slab, 0, m, axis=p_ax_d), 1, axis=nb_ax_d
        )
        parts = [(right, 0)]
        if m > 1:
            left = jnp.roll(
                jax.lax.slice_in_dim(slab, m, H, axis=p_ax_d), -1, axis=nb_ax_d
            )
            parts.append((left, Bd - (m - 1)))
        for part, off in parts:
            width = part.shape[p_ax_d]
            # Interleave-transpose to a thin grid: block axes pair with
            # their (core-extent) p axes; dim d keeps (nb_d, width) split so
            # the stripe can be zero-padded to B_d at offset ``off``.
            perm = [0]
            for dd in range(D):
                perm.extend([1 + dd, 1 + D + dd])
            thin = jnp.transpose(part, perm)
            pad_cfg = [(0, 0)] * thin.ndim
            ax_w = 1 + 2 * d + 1
            pad_cfg[ax_w] = (off, Bd - off - width)
            thin = jnp.pad(thin, pad_cfg)
            contributions.append(thin.reshape(grid_shape))
    out = contributions[0]
    for c in contributions[1:]:
        out = out + c
    return out
