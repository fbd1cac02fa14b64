"""Points-chunked execution: huge point sets in bounded device memory.

The reference's benchmark protocol sweeps to rho = 10 — 167.8M points on a
256^3 grid (benchmark/CPU+CUDA/run_benchmarks.jl:394-404) — a scale where
the per-point pipeline temporaries (the multi-operand ``lax.sort`` in
``set_points``, the exec-time value permutation, the stencil chunks) each
carry several full-size copies of the point payload.

This module processes the point set in ``nchunks`` contiguous slices of the
ORIGINAL point order, each an independent plan sharing one geometry.  The
grid-sized stages are shared or cheap:

- ``set_points``: one ``lax.scan`` over chunks — each iteration's sort
  temporaries are chunk-sized and freed before the next chunk runs;
- type 1: spread + forward FFT per chunk, spectra summed (linearity);
- type 2: ONE deconvolve+pad and ONE backward FFT build the grid, then
  interpolation runs per chunk over the shared grid.  Because chunks
  partition the original order, per-chunk outputs concatenate directly —
  no global merge sort.

Numerics match the unchunked path up to summation-order differences in the
type-1 spectrum accumulation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .callbacks import NUFFTCallbacks
from .plan import Plan, PlanNUFFT
from .plan import set_points as _plan_set_points
from .utils.pytree import data_field, register_pytree_dataclass, static_field

_EMPTY_CALLBACKS = NUFFTCallbacks()


@register_pytree_dataclass
class ChunkedPlan:
    """A NUFFT plan whose point set executes in ``nchunks`` slices.

    ``template`` is an ordinary :class:`Plan` built for ~Np/nchunks points;
    after :func:`set_points_chunked`, ``plans`` holds ``nchunks`` point-set
    copies of it stacked leaf-wise (every data leaf gains a leading chunk
    axis), and ``num_points_total`` the true (pre-padding) point count.
    """

    nchunks: int = static_field()
    num_points_total: Optional[int] = static_field(default=None)
    template: Optional[Plan] = data_field(default=None)
    plans: Optional[Plan] = data_field(default=None)

    @property
    def base(self) -> Plan:
        """A representative single-chunk Plan (statics + shared tensors)."""
        if self.plans is not None:
            return jax.tree_util.tree_map(lambda x: x[0], self.plans)
        return self.template


def ChunkedPlanNUFFT(dtype, shape, *, nchunks: int, np_hint: Optional[int] = None,
                     **kwargs) -> ChunkedPlan:
    """Construct a points-chunked plan (see :func:`PlanNUFFT` for kwargs).

    ``np_hint``, when given, is the TOTAL expected point count; the chunk
    geometry is picked for ``np_hint / nchunks`` points.
    """
    if nchunks < 1:
        raise ValueError(f"nchunks must be >= 1, got {nchunks}")
    if np_hint is not None:
        np_hint = -(-int(np_hint) // nchunks)
    tmpl = PlanNUFFT(dtype, shape, np_hint=np_hint, **kwargs)
    if tmpl.timer is not None:
        raise NotImplementedError("timers are not supported on chunked plans")
    return ChunkedPlan(nchunks=nchunks, template=tmpl)


def set_points_chunked(cplan: ChunkedPlan, points) -> ChunkedPlan:
    """Functional ``set_points`` over chunks (jit-traceable).

    ``points``: ``(D, Np)`` array or tuple of D ``(Np,)`` arrays, radians in
    ``[0, 2pi)``.  Np is zero-padded up to a multiple of ``nchunks`` (padded
    points sit at the origin and carry zero values / sliced-off outputs).
    """
    tmpl = cplan.template if cplan.template is not None else cplan.base
    if isinstance(points, (tuple, list)):
        points = jnp.stack([jnp.asarray(p) for p in points])
    else:
        points = jnp.asarray(points)
        if points.ndim == 1:
            points = points[None]
    D, np_total = points.shape
    K = cplan.nchunks
    npk = -(-np_total // K)
    pad = K * npk - np_total
    if pad:
        points = jnp.pad(points, ((0, 0), (0, pad)))
    pts_k = jnp.moveaxis(points.reshape(D, K, npk), 1, 0)  # (K, D, npk)

    def body(c, p):
        return c, _plan_set_points(tmpl, p)

    _, stacked = jax.lax.scan(body, jnp.float32(0), pts_k)
    return dataclasses.replace(
        cplan, plans=stacked, num_points_total=int(np_total), template=None
    )


def _split_last(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """(..., K*npk) -> (K, ..., npk) chunk-major."""
    npk = x.shape[-1] // k
    return jnp.moveaxis(x.reshape(x.shape[:-1] + (k, npk)), -2, 0)


def _merge_last(xk: jnp.ndarray) -> jnp.ndarray:
    """(K, ..., npk) -> (..., K*npk)."""
    k, npk = xk.shape[0], xk.shape[-1]
    return jnp.moveaxis(xk, 0, -2).reshape(xk.shape[1:-1] + (k * npk,))


def _check_set(cplan: ChunkedPlan):
    if cplan.plans is None:
        raise RuntimeError("points not set: call set_points_chunked first")


@partial(jax.jit, static_argnames=("callbacks",))
def exec_type1_ch_chunked(cplan: ChunkedPlan, vp_ch: jnp.ndarray,
                          callbacks: NUFFTCallbacks = _EMPTY_CALLBACKS):
    """Channel-form type 1 over chunks.

    ``vp_ch``: ``(C, K*npk)`` real plans | ``(C, 2, K*npk)`` complex plans —
    the PADDED length (pad values must be zero; :func:`exec_type1_chunked`
    does this for you).  Returns the channel-form spectrum ``(C, 2) +
    spectral_shape`` exactly like ``_exec_type1_ch_impl``.
    """
    from .execution import (
        _apply_nonuniform_ch,
        _t1_deconv_stage,
        _t1_fft_stage,
        _t1_spread_stage,
    )

    _check_set(cplan)
    stacked, k = cplan.plans, cplan.nchunks
    p0 = cplan.base
    vp_ch = _apply_nonuniform_ch(p0, vp_ch, callbacks.nonuniform)
    vk = _split_last(vp_ch, k)

    spec_sd = jax.eval_shape(
        lambda p, v: _t1_fft_stage(p, _t1_spread_stage(p, v)), p0, vk[0]
    )
    acc0 = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), spec_sd
    )

    def body(acc, pv):
        p, v = pv
        spec = _t1_fft_stage(p, _t1_spread_stage(p, v))
        return jax.tree_util.tree_map(jnp.add, acc, spec), None

    spec, _ = jax.lax.scan(body, acc0, (stacked, vk))
    return _t1_deconv_stage(p0, spec, callbacks)


@partial(jax.jit, static_argnames=("callbacks",))
def exec_type2_ch_chunked(cplan: ChunkedPlan, uhat_ch: jnp.ndarray,
                          callbacks: NUFFTCallbacks = _EMPTY_CALLBACKS):
    """Channel-form type 2 over chunks.

    One pad + backward FFT builds the grid; interpolation runs per chunk
    against it inside a ``lax.scan`` (one chunk's temporaries live at a
    time).  Returns the PADDED ``(C, [2,] K*npk)``
    channel values; :func:`exec_type2_chunked` slices to the true Np.
    """
    from .execution import (
        _apply_nonuniform_ch,
        _t2_fft_stage,
        _t2_interp_stage,
        _t2_pad_stage,
    )

    _check_set(cplan)
    stacked = cplan.plans
    p0 = cplan.base
    spec = _t2_pad_stage(p0, uhat_ch, callbacks)
    grid = _t2_fft_stage(p0, spec)

    def body(c, p):
        return c, _t2_interp_stage(p, grid)

    _, vk = jax.lax.scan(body, jnp.float32(0), stacked)
    v_ch = _merge_last(vk)
    return _apply_nonuniform_ch(p0, v_ch, callbacks.nonuniform)


def exec_type1_chunked(cplan: ChunkedPlan, vp,
                       callbacks: NUFFTCallbacks = None) -> jnp.ndarray:
    """Type-1 NUFFT over chunks: ``vp`` shape ``(Np,)`` or ``(C, Np)`` in
    the plan dtype; output ``plan.spectral_shape`` (+ leading C) complex."""
    _check_set(cplan)
    callbacks = callbacks or _EMPTY_CALLBACKS
    p0 = cplan.base
    vp = jnp.asarray(vp)
    had_axis = vp.ndim == 2
    if not had_axis:
        vp = vp[None]
    np_total = cplan.num_points_total
    np_pad = cplan.nchunks * p0.num_points
    if p0.is_real:
        vp_ch = vp.astype(p0.real_dtype)
    else:
        vp_ch = jnp.stack([vp.real, vp.imag], axis=1).astype(p0.real_dtype)
    if np_pad != np_total:
        widths = [(0, 0)] * (vp_ch.ndim - 1) + [(0, np_pad - np_total)]
        vp_ch = jnp.pad(vp_ch, widths)
    out_ch = exec_type1_ch_chunked(cplan, vp_ch, callbacks)
    uhat = (out_ch[:, 0] + 1j * out_ch[:, 1]).astype(p0.complex_dtype)
    return uhat if had_axis else uhat[0]


def exec_type2_chunked(cplan: ChunkedPlan, uhat,
                       callbacks: NUFFTCallbacks = None) -> jnp.ndarray:
    """Type-2 NUFFT over chunks: ``uhat`` shape ``plan.spectral_shape``
    (optionally + leading C) complex; output ``([C,] Np)`` in plan dtype."""
    _check_set(cplan)
    callbacks = callbacks or _EMPTY_CALLBACKS
    p0 = cplan.base
    uhat = jnp.asarray(uhat)
    had_axis = uhat.ndim == p0.ndim + 1
    if not had_axis:
        uhat = uhat[None]
    u_ch = jnp.stack([uhat.real, uhat.imag], axis=1).astype(p0.real_dtype)
    v_ch = exec_type2_ch_chunked(cplan, u_ch, callbacks)
    np_total = cplan.num_points_total
    if p0.is_real:
        vp = v_ch[:, :np_total].astype(p0.dtype)
    else:
        vp = (v_ch[:, 0, :np_total] + 1j * v_ch[:, 1, :np_total]).astype(
            p0.complex_dtype
        )
    return vp if had_axis else vp[0]
