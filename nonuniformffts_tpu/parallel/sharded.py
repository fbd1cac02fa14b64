"""Point-parallel multi-device NUFFT execution over a JAX device mesh.

The reference is a single-process, single-device library (SURVEY.md section
2: no distributed communication backend exists there) — this module is an
*extension*: scale over devices with ``jax.sharding.Mesh`` + ``shard_map``,
letting XLA place the collectives (NCCL on GPUs).

- non-uniform points and their values are sharded over the ``points`` mesh
  axis (the NUFFT analogue of data parallelism: points are the "batch");
- type 1: each device spreads its local points onto a full local oversampled
  grid — a partial sum free of cross-device races by construction — then
  one ``psum`` merges the grids, and the FFT + deconvolution run on the
  (now replicated) grid.  This mirrors how the reference's CPU path
  resolves write conflicts (block-local accumulation + merge,
  src/spreading/cpu_blocked.jl) lifted to the device level;
- type 2: the deconvolved oversampled grid is computed replicated; each
  device then gathers only its local points — zero communication.

parallel/spatial.py is the grid-sharded counterpart, for grids too large
for one device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import fft as fft_ops
from ..ops.deconvolve import deconvolve_pad, deconvolve_truncate
from ..ops.interpolation import interpolate_reference
from ..ops.spreading import spread_reference
from ..plan import Plan, fold_points


def make_mesh(n_devices: int = None, axis_name: str = "points") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis_name,))


def shard_points(mesh: Mesh, points, vp=None, axis_name: str = "points"):
    """Place (D, Np) points (and optionally values, sharded along the last
    axis) onto the mesh.  Np must divide evenly by the mesh size."""
    sh = NamedSharding(mesh, P(None, axis_name))
    pts = jax.device_put(jnp.asarray(points), sh)
    if vp is None:
        return pts
    vsh = NamedSharding(mesh, P(*([None] * (np.ndim(vp) - 1) + [axis_name])))
    return pts, jax.device_put(jnp.asarray(vp), vsh)


def _local_spread_ch(plan: Plan, pts_local, vp_ch_local):
    """Spread a shard of points onto a full local grid (channel form for
    complex plans)."""
    pts_local = fold_points(pts_local, plan.point_transform)
    if plan.is_real:
        return spread_reference(
            plan.kernel_data, plan.evalmode, plan.shape_over, pts_local,
            vp_ch_local, chunk_size=plan.chunk_size,
        )
    C = vp_ch_local.shape[0]
    vpc = jax.lax.complex(vp_ch_local[:, 0], vp_ch_local[:, 1]).astype(plan.dtype)
    g = spread_reference(
        plan.kernel_data, plan.evalmode, plan.shape_over, pts_local, vpc,
        chunk_size=plan.chunk_size,
    )
    return jnp.stack([g.real, g.imag], axis=1)


@partial(jax.jit, static_argnames=("mesh", "axis_name"))
def exec_type1_sharded(plan: Plan, points, vp_ch, *, mesh: Mesh, axis_name: str = "points"):
    """Distributed type 1.  ``points``: (D, Np) sharded along Np; ``vp_ch``:
    channel-form values (C, [2,] Np) sharded along Np.  Returns the
    channel-form spectrum, replicated."""
    pspec = P(None, axis_name)
    vspec = P(*([None] * (vp_ch.ndim - 1) + [axis_name]))

    def body(plan_l, pts_l, vp_l):
        g = _local_spread_ch(plan_l, pts_l, vp_l)
        return jax.lax.psum(g, axis_name)  # merge the partial grids

    # check_vma=False: the chunked stencil scan carries a grid that starts
    # replicated (zeros) and becomes device-varying in its first step.
    grid = jax.shard_map(
        body, mesh=mesh, in_specs=(P(), pspec, vspec), out_specs=P(),
        check_vma=False,
    )(plan, points, vp_ch)

    # FFT + deconvolution on the merged grid (replicated).
    if plan.is_real:
        uhat_over = fft_ops.forward_fft(grid, real=True)
    else:
        gc = jax.lax.complex(grid[:, 0], grid[:, 1]).astype(plan.complex_dtype)
        uhat_over = fft_ops.forward_fft(gc, real=False)
    uhat = deconvolve_truncate(
        uhat_over, plan.index_ranges, plan.phihat_inv, plan.normfactor
    )
    return jnp.stack([uhat.real, uhat.imag], axis=1)


@partial(jax.jit, static_argnames=("mesh", "axis_name"))
def exec_type2_sharded(plan: Plan, points, uhat_ch, *, mesh: Mesh, axis_name: str = "points"):
    """Distributed type 2.  ``uhat_ch``: channel-form spectrum (replicated);
    ``points`` sharded along Np.  Returns channel-form values sharded along
    Np (zero communication: pure local gather)."""
    uhat = jax.lax.complex(uhat_ch[:, 0], uhat_ch[:, 1]).astype(plan.complex_dtype)
    uhat_over = deconvolve_pad(
        uhat, plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv
    )
    grid = fft_ops.backward_fft(uhat_over, plan.shape_over, real=plan.is_real)

    pspec = P(None, axis_name)

    def body(plan_l, grid_l, pts_l):
        pts_l = fold_points(pts_l, plan_l.point_transform)
        v = interpolate_reference(
            plan_l.kernel_data, plan_l.evalmode, grid_l, pts_l, plan_l.normfactor,
            chunk_size=plan_l.chunk_size,
        )
        if plan_l.is_real:
            return v.astype(plan_l.dtype)
        return jnp.stack([v.real, v.imag], axis=1)

    out_spec = P(None, axis_name) if plan.is_real else P(None, None, axis_name)
    return jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), pspec), out_specs=out_spec,
    )(plan, grid, points)
