"""Transform execution: type-1 (non-uniform -> uniform) and type-2
(uniform -> non-uniform) pipelines.

Counterpart of the reference's exec_type1! / exec_type2!
(src/NonuniformFFTs.jl:148-189, 237-286), with identical conventions:

- type 1: ``uhat(k) = sum_j v_j exp(-i k . x_j)``;
- type 2: ``v_j = sum_k uhat(k) exp(+i k . x_j)``;
- on uniform points these reduce exactly to the unnormalised forward /
  backward DFT (pinned by tests/test_uniform_points.py, the port of
  test/uniform_points.jl).

Everything is functional and jit-compiled as one XLA program per
(plan-static, Np) signature.

Channel representation
----------------------
Between the stages, complex data travels as real (re, im) *channel* pairs —
shape ``(C, 2, ...)`` — the form the blocked kernel reads and the points-
chunked driver (chunked.py) and the grid-sharded driver (parallel/spatial.py)
accumulate.  Two public surfaces exist:

- :func:`exec_type1` / :func:`exec_type2`: the reference-style complex API.
- :func:`exec_type1_channels` / :func:`exec_type2_channels`: the channel
  API — all-real inputs and outputs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .callbacks import NUFFTCallbacks, apply_nonuniform_callback
from .ops import fft
from .ops.deconvolve import (
    _apply_uniform_callback,
    deconvolve_pad,
    deconvolve_truncate,
)
from .ops.interpolation import interpolate_cells, interpolate_reference
from .ops.spreading import spread_reference
from .plan import Plan

_EMPTY_CALLBACKS = NUFFTCallbacks()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _check_points(plan: Plan):
    if plan.points is None:
        raise ValueError("points not set; call set_points first")


def _to_channels(x: jnp.ndarray) -> jnp.ndarray:
    """Complex (C, ...) -> real channels (C, 2, ...)."""
    return jnp.stack([x.real, x.imag], axis=1)


def _from_channels(ch: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.complex(ch[:, 0], ch[:, 1])


def _t1_spread_stage(plan: Plan, vp_ch: jnp.ndarray) -> jnp.ndarray:
    """Spreading: channel values -> native (complex or real) grid
    (C,) + shape_over."""
    if plan.spread_method == "blocked":
        from .ops.pallas import spread_blocked

        C = vp_ch.shape[0]
        flat = vp_ch.reshape((-1, vp_ch.shape[-1]))  # (CR, Np)
        g = spread_blocked(plan, flat)
        if plan.is_real:
            return g
        return _from_channels(g.reshape((C, 2) + g.shape[1:]))
    vp = vp_ch if plan.is_real else _from_channels(vp_ch).astype(plan.dtype)
    if plan.point_perm is not None:  # sort_points: points stored cell-major
        vp = jnp.take(vp, plan.point_perm, axis=-1)
    return spread_reference(
        plan.kernel_data, plan.evalmode, plan.shape_over, plan.points, vp,
        chunk_size=plan.chunk_size,
    )


def _apply_nonuniform_ch(plan, vp_ch, callback):
    """Nonuniform callback on channel data (complex plans: assemble complex
    on device — elementwise complex ops only)."""
    if callback is None:
        return vp_ch
    if plan.is_real:
        return apply_nonuniform_callback(vp_ch, callback)
    v = _from_channels(vp_ch).astype(plan.dtype)
    return _to_channels(apply_nonuniform_callback(v, callback))


# ---------------------------------------------------------------------------
# Per-stage helpers (shared by the fused jit path, the staged/timed path and
# the points-chunked driver)
# ---------------------------------------------------------------------------


def _t1_fft_stage(plan: Plan, g: jnp.ndarray):
    return fft.forward_fft(g, real=plan.is_real)


def _t1_deconv_stage(plan: Plan, spec, callbacks: NUFFTCallbacks):
    uhat = deconvolve_truncate(
        spec, plan.index_ranges, plan.phihat_inv, plan.normfactor,
        callback=callbacks.uniform,
    )
    return _to_channels(uhat.astype(plan.complex_dtype))


def _t2_pad_stage(plan: Plan, uhat_ch: jnp.ndarray, callbacks: NUFFTCallbacks):
    u = _from_channels(uhat_ch).astype(plan.complex_dtype)
    return deconvolve_pad(
        u, plan.spectral_shape_over, plan.index_ranges, plan.phihat_inv,
        callback=callbacks.uniform,
    )


def _t2_fft_stage(plan: Plan, spec: jnp.ndarray):
    return fft.backward_fft(spec, plan.shape_over, real=plan.is_real)


def _t2_interp_stage(plan: Plan, grid):
    """Interpolation: native grid -> channel values in the caller's point
    order."""
    if plan.spread_method == "blocked":
        out = interpolate_cells(
            plan.kernel_data, plan.evalmode, grid, plan.cells, plan.fracs,
            plan.normfactor, chunk_size=plan.chunk_size,
        )
        # Sorted order -> the caller's order.
        out = jnp.zeros_like(out).at[:, plan.sort_perm].set(
            out, unique_indices=True
        )
    else:
        out = interpolate_reference(
            plan.kernel_data, plan.evalmode, grid, plan.points,
            plan.normfactor, chunk_size=plan.chunk_size,
        )
        if plan.point_perm is not None:  # un-permute back to input order
            out = jnp.take(out, plan.point_perm_inv, axis=-1)
    return out if plan.is_real else _to_channels(out)


def _direct_type1(plan: Plan, vp_ch, callbacks: NUFFTCallbacks):
    from .ops.direct import exec_type1_direct_ch

    # Exact dense sums: no grid, no FFT, no deconvolution.
    out_ch = exec_type1_direct_ch(plan, vp_ch)
    if callbacks.uniform is not None:
        u = _from_channels(out_ch).astype(plan.complex_dtype)
        out_ch = _to_channels(_apply_uniform_callback(u, callbacks.uniform))
    return out_ch


def _direct_type2(plan: Plan, uhat_ch, callbacks: NUFFTCallbacks):
    from .ops.direct import exec_type2_direct_ch

    if callbacks.uniform is not None:
        # No deconvolution scaling exists on the direct path; the callback
        # applies to the user spectrum as-is.
        u = _from_channels(uhat_ch).astype(plan.complex_dtype)
        uhat_ch = _to_channels(_apply_uniform_callback(u, callbacks.uniform))
    return exec_type2_direct_ch(plan, uhat_ch)


@partial(jax.jit, static_argnames=("callbacks",))
def _exec_type1_ch_impl(plan: Plan, vp_ch: jnp.ndarray, callbacks: NUFFTCallbacks):
    """vp_ch: (C, Np) real plans | (C, 2, Np) complex plans.
    Returns the channel-form spectrum (C, 2) + spectral_shape."""
    vp_ch = _apply_nonuniform_ch(plan, vp_ch, callbacks.nonuniform)
    if plan.spread_method == "direct":
        return _direct_type1(plan, vp_ch, callbacks)
    g = _t1_spread_stage(plan, vp_ch)
    spec = _t1_fft_stage(plan, g)
    return _t1_deconv_stage(plan, spec, callbacks)


@partial(jax.jit, static_argnames=("callbacks",))
def _exec_type2_ch_impl(plan: Plan, uhat_ch: jnp.ndarray, callbacks: NUFFTCallbacks):
    """uhat_ch: channel-form spectrum (C, 2) + spectral_shape.
    Returns (C, Np) real plans | (C, 2, Np) complex plans."""
    if plan.spread_method == "direct":
        vp_ch = _direct_type2(plan, uhat_ch, callbacks)
    else:
        spec = _t2_pad_stage(plan, uhat_ch, callbacks)
        grid = _t2_fft_stage(plan, spec)
        vp_ch = _t2_interp_stage(plan, grid)
    return _apply_nonuniform_ch(plan, vp_ch, callbacks.nonuniform)


# ---------------------------------------------------------------------------
# Staged (timed) execution: one jitted call per stage, synchronised between
# stages — the analogue of the reference's @timeit-wrapped pipeline with
# synchronise=true (src/NonuniformFFTs.jl:157-185, plan.jl:288-290).  Active
# whenever the plan carries a Timer.
# ---------------------------------------------------------------------------

_j_nonuni = partial(jax.jit, static_argnames=("cb",))(
    lambda plan, x, cb: _apply_nonuniform_ch(plan, x, cb)
)
_j_t1_spread = jax.jit(_t1_spread_stage)
_j_t1_fft = jax.jit(_t1_fft_stage)
_j_t1_deconv = partial(jax.jit, static_argnames=("callbacks",))(_t1_deconv_stage)
_j_t2_pad = partial(jax.jit, static_argnames=("callbacks",))(_t2_pad_stage)
_j_t2_fft = jax.jit(_t2_fft_stage)
_j_t2_interp = jax.jit(_t2_interp_stage)


def _run_staged(timer, name, fn, *args, **kw):
    with timer.section(name):
        out = fn(*args, **kw)
        timer.sync(out)
    return out


def _exec_type1_ch_staged(plan: Plan, vp_ch, callbacks: NUFFTCallbacks):
    t = plan.timer
    if plan.spread_method == "direct":
        with t.section("exec_type1"):
            return _run_staged(
                t, "(1) direct NUDFT", _exec_type1_ch_impl, plan, vp_ch,
                callbacks=callbacks,
            )
    with t.section("exec_type1"):
        if callbacks.nonuniform is not None:
            vp_ch = _run_staged(
                t, "(0) nonuniform callback", _j_nonuni, plan, vp_ch,
                cb=callbacks.nonuniform,
            )
        g = _run_staged(t, "(1) spreading", _j_t1_spread, plan, vp_ch)
        spec = _run_staged(t, "(2) forward FFT", _j_t1_fft, plan, g)
        out = _run_staged(
            t, "(3) deconvolve + truncate", _j_t1_deconv, plan, spec,
            callbacks=callbacks,
        )
    return out


def _exec_type2_ch_staged(plan: Plan, uhat_ch, callbacks: NUFFTCallbacks):
    t = plan.timer
    if plan.spread_method == "direct":
        with t.section("exec_type2"):
            return _run_staged(
                t, "(1) direct NUDFT", _exec_type2_ch_impl, plan, uhat_ch,
                callbacks=callbacks,
            )
    with t.section("exec_type2"):
        spec = _run_staged(
            t, "(1) deconvolve + pad", _j_t2_pad, plan, uhat_ch,
            callbacks=callbacks,
        )
        grid = _run_staged(t, "(2) backward FFT", _j_t2_fft, plan, spec)
        vp_ch = _run_staged(t, "(3) interpolation", _j_t2_interp, plan, grid)
        if callbacks.nonuniform is not None:
            vp_ch = _run_staged(
                t, "(4) nonuniform callback", _j_nonuni, plan, vp_ch,
                cb=callbacks.nonuniform,
            )
    return vp_ch


def _dispatch_type1(plan, vp_ch, callbacks):
    if plan.timer is not None:
        return _exec_type1_ch_staged(plan, vp_ch, callbacks)
    return _exec_type1_ch_impl(plan, vp_ch, callbacks)


def _dispatch_type2(plan, uhat_ch, callbacks):
    if plan.timer is not None:
        return _exec_type2_ch_staged(plan, uhat_ch, callbacks)
    return _exec_type2_ch_impl(plan, uhat_ch, callbacks)


# ---------------------------------------------------------------------------
# Validation / component-axis handling
# ---------------------------------------------------------------------------


def _as_components(x, plan: Plan, expected_tail_ndim: int):
    if x.ndim == expected_tail_ndim:
        if plan.ntransforms != 1:
            raise ValueError(
                f"plan has ntransforms={plan.ntransforms}; pass data with a "
                f"leading component axis"
            )
        return x[None], False
    if x.ndim == expected_tail_ndim + 1:
        if x.shape[0] != plan.ntransforms:
            raise ValueError(
                f"leading axis {x.shape[0]} != ntransforms {plan.ntransforms}"
            )
        return x, True
    raise ValueError(f"unexpected input rank {x.ndim}")


# ---------------------------------------------------------------------------
# Public API: reference-style complex interface
# ---------------------------------------------------------------------------


def exec_type1(plan: Plan, vp, callbacks: NUFFTCallbacks = None) -> jnp.ndarray:
    """Type-1 NUFFT: values at non-uniform points -> Fourier modes.

    ``vp`` has shape ``(Np,)`` or ``(ntransforms, Np)`` and the plan's dtype;
    the output has shape ``plan.spectral_shape`` (plus the leading component
    axis if present) and complex dtype.
    """
    _check_points(plan)
    callbacks = callbacks or _EMPTY_CALLBACKS
    vp = vp if isinstance(vp, jnp.ndarray) else np.asarray(vp)
    if vp.dtype != plan.dtype:
        raise TypeError(
            f"non-uniform data must have dtype {plan.dtype}, got {vp.dtype}"
        )
    vp, had_axis = _as_components(vp, plan, expected_tail_ndim=1)
    if vp.shape[1] != plan.num_points:
        raise ValueError(
            f"number of values {vp.shape[1]} != number of points {plan.num_points}"
        )
    vp = jnp.asarray(vp)
    vp_ch = vp if plan.is_real else _to_channels(vp)
    out_ch = _dispatch_type1(plan, vp_ch, callbacks)
    uhat = _from_channels(out_ch).astype(plan.complex_dtype)
    return uhat if had_axis else uhat[0]


def exec_type2(plan: Plan, uhat, callbacks: NUFFTCallbacks = None) -> jnp.ndarray:
    """Type-2 NUFFT: Fourier modes -> values at non-uniform points.

    ``uhat`` has shape ``plan.spectral_shape`` (optionally with a leading
    component axis) and complex dtype; output ``(Np,)`` / ``(ntransforms,
    Np)`` in the plan's dtype.
    """
    _check_points(plan)
    callbacks = callbacks or _EMPTY_CALLBACKS
    uhat = uhat if isinstance(uhat, jnp.ndarray) else np.asarray(uhat)
    if uhat.dtype != plan.complex_dtype:
        raise TypeError(
            f"uniform data must have dtype {np.dtype(plan.complex_dtype)}, "
            f"got {uhat.dtype}"
        )
    uhat, had_axis = _as_components(uhat, plan, expected_tail_ndim=plan.ndim)
    if uhat.shape[1:] != plan.spectral_shape:
        raise ValueError(
            f"uniform data shape {uhat.shape[1:]} != expected {plan.spectral_shape}"
        )
    vp_ch = _dispatch_type2(plan, _to_channels(jnp.asarray(uhat)), callbacks)
    if plan.is_real:
        vp = vp_ch.astype(plan.dtype)
    else:
        vp = _from_channels(vp_ch).astype(plan.dtype)
    return vp if had_axis else vp[0]


# ---------------------------------------------------------------------------
# Public API: all-real channel interface
# ---------------------------------------------------------------------------


def exec_type1_channels(plan: Plan, vp_ch, callbacks: NUFFTCallbacks = None):
    """Channel-form type 1.

    ``vp_ch``: real plans ``(Np,)``/``(C, Np)``; complex plans ``(2, Np)`` /
    ``(C, 2, Np)`` with channel 0 = Re, 1 = Im.  Returns the channel-form
    spectrum ``(2,) + spectral_shape`` / ``(C, 2) + spectral_shape`` — always
    a real array.
    """
    _check_points(plan)
    callbacks = callbacks or _EMPTY_CALLBACKS
    vp_ch = jnp.asarray(vp_ch)
    tail = 1 if plan.is_real else 2
    vp_ch, had_axis = _as_components(vp_ch, plan, expected_tail_ndim=tail)
    out_ch = _dispatch_type1(plan, vp_ch, callbacks)
    return out_ch if had_axis else out_ch[0]


def exec_type2_channels(plan: Plan, uhat_ch, callbacks: NUFFTCallbacks = None):
    """Channel-form type 2.

    ``uhat_ch``: ``(2,) + spectral_shape`` / ``(C, 2) + spectral_shape``.
    Returns real plans ``(Np,)``/``(C, Np)``; complex plans ``(2, Np)`` /
    ``(C, 2, Np)``.
    """
    _check_points(plan)
    callbacks = callbacks or _EMPTY_CALLBACKS
    uhat_ch = jnp.asarray(uhat_ch)
    uhat_ch, had_axis = _as_components(
        uhat_ch, plan, expected_tail_ndim=plan.ndim + 1
    )
    vp_ch = _dispatch_type2(plan, uhat_ch, callbacks)
    return vp_ch if had_axis else vp_ch[0]
