"""Direct NUDFT: the exact transform sums as dense matrix products, no grid.

For a handful of points it is cheaper to evaluate the type-1/type-2 sums
*exactly* as dense DFT matrices than to pay the grid-sized FFT floor: no
window, no oversampling, no deconvolution — the achieved "error" is the
contraction precision itself (~2e-7 in f32).  Only an explicit
``spread_method='direct'`` selects it.

The blocker solved here is PHASE PRECISION: e^{-ik.x} with k up to N/2 and
x up to 2pi carries k*x*2^-24 ~ 5e-5 rad of f32 noise if evaluated
naively.  ``_phase_trig`` reduces k*x mod 2pi in an exact split-product
cascade (x split so k*x_hi is exact, 2pi split into three exact-product
terms) leaving ~4e-7 rad of error — below the f32 cos/sin ulp floor.  See
docs/design.md (direct-NUDFT section).

Shapes (channel form, C = ntransforms):
  type 1:  values (C, 2, Np) | (C, Np) real  ->  spectrum (C, 2) + spec
  type 2:  spectrum (C, 2) + spec            ->  values (C, 2, Np) | (C, Np)
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

TWO_PI = 2.0 * math.pi

# Three-term exact-product split of 2pi: TP1/TP2 carry <=13 mantissa bits
# (multiples of 2^-10), so n*TP1 and n*TP2 are exact f32 products for the
# cycle counts n <= 2^11 reached at N <= 2048; TP3 absorbs the f64 rest.
_TP1 = np.float32(np.floor(TWO_PI * 1024.0) / 1024.0)
_TP2 = np.float32(np.floor((TWO_PI - float(_TP1)) * 1024.0 * 2**13) / (1024.0 * 2**13))
_TP3 = np.float32(TWO_PI - float(_TP1) - float(_TP2))


def _phase_trig(k: jnp.ndarray, x: jnp.ndarray, kmax: int):
    """cos/sin of (k*x mod 2pi) with ~4e-7 rad absolute error.

    ``k``: (Nk,) f32 integer-valued, |k| <= kmax; ``x``: (Np,) f32 in
    [0, 2pi).  Returns (cos, sin) each of shape (Np, Nk).
    """
    # Split x so that k * x_hi is EXACT in f32: x < 2^3, so a step of
    # 2^(bits(kmax) - 21) keeps the product under 24 mantissa bits.
    step_log2 = max(int(math.ceil(math.log2(max(kmax, 1)))) - 21, -21)
    inv_step = np.float32(2.0 ** (-step_log2))
    x_hi = jnp.round(x * inv_step) / inv_step
    x_lo = x - x_hi  # exact (nearby f32 values)
    k2 = k[None, :]
    p = k2 * x_hi[:, None]  # exact by construction
    n = jnp.round(p / jnp.float32(TWO_PI))
    # Cascaded exact-product reduction: p and n*TP1 are exact and close
    # (Sterbenz), the remaining subtractions are correctly rounded at
    # ~pi magnitude (~1.2e-7 each), k*x_lo adds <= 1e-7.
    r = ((p - n * _TP1) - n * _TP2) - n * _TP3 + k2 * x_lo[:, None]
    return jnp.cos(r), jnp.sin(r)


def _trig_factors(plan, pts: jnp.ndarray):
    """Per-dim (cos, sin) of k_d * x_d, shapes (Np, N_d)."""
    out = []
    for d in range(plan.ndim):
        kv = plan.kvec[d].astype(jnp.float32)
        kmax = plan.shape[d] // 2 + 1
        out.append(_phase_trig(kv, pts[d].astype(jnp.float32), kmax))
    return out


def _tail_factor(trig):
    """Combine dims 1..D-1 into one flattened (Np, prod N_d) complex pair
    for phase e^{-i sum k_d x_d} (F_re, F_im with F = prod (c - i s))."""
    (c, s) = trig[0]
    f_re, f_im = c, -s
    for (c, s) in trig[1:]:
        g_re, g_im = c, -s
        # (Np, A) x (Np, B) -> (Np, A, B), flattened.
        nr = f_re[:, :, None] * g_re[:, None, :] - f_im[:, :, None] * g_im[:, None, :]
        ni = f_re[:, :, None] * g_im[:, None, :] + f_im[:, :, None] * g_re[:, None, :]
        npts = nr.shape[0]
        f_re = nr.reshape(npts, -1)
        f_im = ni.reshape(npts, -1)
    return f_re, f_im


def _prec(plan):
    # Full-precision products: a GPU would otherwise run float32 matrix
    # products in TF32 (~3 decimal digits).
    del plan
    return jax.lax.Precision.HIGHEST


def exec_type1_direct_ch(plan, vp_ch: jnp.ndarray) -> jnp.ndarray:
    """u[k] = sum_j v_j e^{-i k.x_j} as one (N0, Np) @ (Np, N1..N_{D-1})
    contraction per channel component."""
    pts = plan.points
    trig = _trig_factors(plan, pts)
    prec = _prec(plan)
    spec = plan.spectral_shape
    (c0, s0) = trig[0]
    f0_re, f0_im = c0, -s0  # (Np, N0)
    if plan.ndim == 1:
        t_re = t_im = None
    else:
        t_re, t_im = _tail_factor(trig[1:])  # (Np, N1*..)
    C = vp_ch.shape[0]
    outs = []
    for c in range(C):
        if plan.is_real:
            vr, vi = vp_ch[c], None
        else:
            vr, vi = vp_ch[c, 0], vp_ch[c, 1]
        # Left factor L[j, k0] = v_j * F0[j, k0].
        l_re = vr[:, None] * f0_re
        l_im = vr[:, None] * f0_im
        if vi is not None:
            l_re = l_re - vi[:, None] * f0_im
            l_im = l_im + vi[:, None] * f0_re
        if plan.ndim == 1:
            u_re = jnp.sum(l_re, axis=0)
            u_im = jnp.sum(l_im, axis=0)
        else:
            dot = lambda a, b: jnp.matmul(a.T, b, precision=prec)
            u_re = dot(l_re, t_re) - dot(l_im, t_im)
            u_im = dot(l_re, t_im) + dot(l_im, t_re)
        outs.append(jnp.stack([u_re.reshape(spec), u_im.reshape(spec)]))
    return jnp.stack(outs)


def exec_type2_direct_ch(plan, uhat_ch: jnp.ndarray) -> jnp.ndarray:
    """v_j = sum_k u_k e^{+i k.x_j}; r2c plans realify with the halved-axis
    doubling convention (k_last = 0 once, every stored k_last > 0 doubled —
    pinned by tests/test_accuracy.py c2r oracle tests)."""
    pts = plan.points
    trig = _trig_factors(plan, pts)
    prec = _prec(plan)
    spec = plan.spectral_shape
    n0 = spec[0]
    ntail = int(np.prod(spec[1:], dtype=np.int64)) if plan.ndim > 1 else 1
    (c0, s0) = trig[0]
    g0_re, g0_im = c0, s0  # conj of the type-1 factor: e^{+i k0 x0}
    if plan.ndim > 1:
        t_re, t_im = _tail_factor(trig[1:])
        g_t_re, g_t_im = t_re, -t_im  # conj -> e^{+i ...}
    C = uhat_ch.shape[0]
    outs = []
    for c in range(C):
        u_re = uhat_ch[c, 0].reshape(n0, ntail)
        u_im = uhat_ch[c, 1].reshape(n0, ntail)
        if plan.is_real:
            # Halved last axis: weight stored modes (1 at k=0, 2 beyond).
            # In the (n0, ntail) layout the halved axis is axis 0 for 1D
            # plans and the fastest-varying tail position otherwise.
            h = spec[-1]
            w = jnp.where(jnp.arange(h) == 0, 1.0, 2.0).astype(jnp.float32)
            w = w[:, None] if plan.ndim == 1 else jnp.tile(w, ntail // h)[None, :]
            u_re = u_re * w
            u_im = u_im * w
        if plan.ndim == 1:
            # v_j = sum_k0 G0[j, k0] * u[k0]
            mv = lambda a, b: jnp.matmul(a, b, precision=prec)
            v_re = mv(g0_re, u_re[:, 0]) - mv(g0_im, u_im[:, 0])
            v_im = mv(g0_re, u_im[:, 0]) + mv(g0_im, u_re[:, 0])
        else:
            dot = lambda a, b: jnp.matmul(a, b, precision=prec)
            m_re = dot(g_t_re, u_re.T) - dot(g_t_im, u_im.T)  # (Np, N0)
            m_im = dot(g_t_re, u_im.T) + dot(g_t_im, u_re.T)
            v_re = jnp.sum(g0_re * m_re - g0_im * m_im, axis=1)
            v_im = jnp.sum(g0_re * m_im + g0_im * m_re, axis=1)
        if plan.is_real:
            outs.append(v_re)
        else:
            outs.append(jnp.stack([v_re, v_im]))
    return jnp.stack(outs)
