"""Spreading-window kernels (the math core of the NUFFT).

This is the TPU-native counterpart of the reference's ``src/Kernels/``
submodule (Kernels.jl, kaiser_bessel.jl, kaiser_bessel_backwards.jl,
gaussian.jl, bspline.jl, piecewise_polynomial.jl).  Same math, re-designed for
JAX: per-point window evaluation is vectorised over a trailing ``2M`` axis so
the whole batch of non-uniform points is evaluated with a handful of fused VPU
ops, and the FINUFFT-style piecewise-polynomial fast evaluation becomes a
single Horner recurrence over a static ``(Npoly, 2M)`` coefficient tensor.

Conventions (identical to the reference):

- the domain is the periodic box ``[0, 2pi)^d``;
- ``point_to_cell`` computes ``r = (x / L) * N`` and ``c = trunc(r)`` with this
  exact order of operations, which guarantees in-bounds cell indices for points
  just below ``2pi`` (reference: src/Kernels/Kernels.jl:121-126, validated by
  test/near_2pi.jl); we additionally clamp to ``N - 1`` as a pure safety net;
- a point with cell ``c`` (0-based) spreads onto the ``2M`` grid nodes
  ``c - M + 1 ... c + M`` (periodically wrapped); the value at node
  ``c - M + 1 + t`` (``t = 0 .. 2M-1``) is ``phi((M - 1 - t + X) / M)`` with
  ``X = r - c`` in ``[0, 1)`` (reference: kernel_indices Kernels.jl:148-158 +
  _evaluate_kernel_direct in each kernel file).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.besseli0 import besseli0
from ..utils.pytree import register_pytree_dataclass, static_field, data_field

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# User-facing kernel specifications (static / hashable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractKernel:
    pass


@dataclasses.dataclass(frozen=True)
class KaiserBesselKernel(AbstractKernel):
    """phi(y) = I0(beta * sqrt(1 - y^2)) for |y| <= 1.

    Reference: src/Kernels/kaiser_bessel.jl.  Default shape parameter
    ``beta = gamma * M * pi * (2 - 1/sigma)`` with the Beatty et al. safety
    factor ``gamma = sqrt(1 - 0.8 / (M (2 - 1/sigma))^2)``.
    """

    beta: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class BackwardsKaiserBesselKernel(AbstractKernel):
    """phi(y) = sinh(beta * sqrt(1 - y^2)) / (pi * sqrt(1 - y^2)); the default
    kernel of the reference (src/Kernels/kaiser_bessel_backwards.jl, selected
    in src/NonuniformFFTs.jl:52)."""

    beta: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class GaussianKernel(AbstractKernel):
    """Truncated Gaussian, phi(x) = exp(-x^2 / (2 l^2)).

    ``ell`` is the normalised width ``l / dx``; the default is the Potts &
    Steidl optimum ``l^2 = dx^2 sigma M / ((2 sigma - 1) pi)`` (reference:
    src/Kernels/gaussian.jl:106-115)."""

    ell: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class BSplineKernel(AbstractKernel):
    """B-spline of order 2M evaluated by the de Boor recurrence (reference:
    src/Kernels/bspline.jl)."""


# Evaluation modes (reference: src/Kernels/Kernels.jl:14-46).
class EvaluationMode:
    pass


@dataclasses.dataclass(frozen=True)
class Direct(EvaluationMode):
    """Evaluate the window from its definition."""


@dataclasses.dataclass(frozen=True)
class FastApproximation(EvaluationMode):
    """FINUFFT-style piecewise-polynomial evaluation for (B)KB kernels, fast
    Gaussian gridding for the Gaussian; same as Direct for B-splines."""


# ---------------------------------------------------------------------------
# Per-dimension kernel data (goes inside the plan)
# ---------------------------------------------------------------------------


@register_pytree_dataclass
class KernelData:
    """Static window parameters + polynomial coefficient tensor for one
    dimension (oversampled grid of size ``N``).

    Counterpart of the reference's ``AbstractKernelData`` subtypes.  All scalar
    parameters are static (compile-time constants of jitted transforms); only
    the piecewise-polynomial coefficients are an array leaf.
    """

    kind: str = static_field()  # 'kb' | 'bkb' | 'gaussian' | 'bspline'
    m: int = static_field()  # half-support M
    n: int = static_field()  # oversampled grid size along this dim
    beta: float = static_field(default=0.0)  # (B)KB shape parameter
    tau: float = static_field(default=0.0)  # Gaussian: 2 l^2
    w: float = static_field(default=0.0)  # physical half-width = M * dx
    dx: float = static_field(default=0.0)  # oversampled grid step = 2 pi / N
    # Window normalisation: every evaluation path returns phi(y)/peak with
    # ``peak ~= phi(0)`` (FINUFFT normalises its ES kernel the same way) and
    # the Fourier coefficients scale identically, so the factor cancels
    # exactly in both transform types.  The raw (B)KB windows peak at
    # ~e^beta/2pi (1.5e10 at m=6, 4e14 at m=8): unnormalised, the f32 fast
    # path OVERFLOWS in the 3-dim tensor product at m=8 (inf - inf -> nan)
    # and UNDERFLOWS in type-2's u/prod(phihat) padding at m=6 (the padded
    # DC mode lands at 1e-31, the normalised inverse FFT flushes it to a
    # subnormal zero).  The reference never sees this because it runs f64
    # (src/Kernels/kaiser_bessel_backwards.jl evaluates the raw window).
    peak: float = static_field(default=1.0)
    cs_poly: Optional[jnp.ndarray] = data_field(default=None)  # (Npoly, 2M)
    cs_gauss: Optional[jnp.ndarray] = data_field(default=None)  # (2M,)


# ---------------------------------------------------------------------------
# Optimal-parameter selection (host side, plan-construction time)
# ---------------------------------------------------------------------------


def _optimal_beta_kb(m: int, sigma: float) -> float:
    # Reference: src/Kernels/kaiser_bessel.jl:152-166 (Potts & Steidl eq. 5.12
    # with the Beatty et al. gamma factor).
    a = m * (2.0 - 1.0 / sigma)
    gamma = math.sqrt(1.0 - 0.8 / a**2)
    return math.pi * a * gamma

def _optimal_beta_bkb(m: int, sigma: float) -> float:
    # Reference: src/Kernels/kaiser_bessel_backwards.jl:123-136.
    a = m * (2.0 - 1.0 / sigma)
    gamma = max(0.995, math.sqrt(1.0 - 0.3 / a**2))
    return math.pi * a * gamma


def _optimal_ell_gauss(m: int, sigma: float) -> float:
    # Reference: src/Kernels/gaussian.jl:106-115 (Potts & Steidl eq. 5.9);
    # normalised width l / dx.
    return math.sqrt(sigma * m / ((2.0 * sigma - 1.0) * math.pi))


def _solve_piecewise_polynomial_coefficients(f, m: int, npoly: int) -> np.ndarray:
    """Solve for the (npoly, 2M) piecewise-polynomial coefficient tensor.

    FINUFFT-style fast window evaluation (reference:
    src/Kernels/piecewise_polynomial.jl): the window support [-1, 1] is split
    into 2M subintervals; on each, the window is interpolated by a polynomial
    of degree npoly-1 fitted at Chebyshev nodes.  At runtime all 2M
    polynomials are evaluated at the *same* scaled coordinate
    ``z = 2 X - 1`` (X in [0, 1)) with one Horner recurrence: piece ``t``
    (0-based) then yields the window value at evaluation point
    ``y = 1 + (X - (t+1)) / M``, exactly the node offsets of direct
    evaluation.

    The solve happens once at plan time, in float64 on the host.
    """
    L = 2 * m
    # Chebyshev nodes in [-1, 1] (piecewise_polynomial.jl:60-62).
    i = np.arange(npoly, dtype=np.float64)
    xs = np.cos(np.pi * (i + 0.5) / npoly)
    A = np.vander(xs, npoly, increasing=True)  # A[i, q] = xs[i]**q
    cs = np.empty((npoly, L), dtype=np.float64)
    for j in range(1, L + 1):
        h = 1.0 - 2.0 * (j - 0.5) / L  # midpoint of subinterval (right->left)
        delta = 1.0 / L
        ys = f(h + xs * delta)
        cs[:, j - 1] = np.linalg.solve(A, ys)
    return cs


def make_kernel_data(
    kernel: AbstractKernel, m: int, n: int, sigma: float, dtype,
) -> KernelData:
    """Build per-dimension kernel data (reference: Kernels.optimal_kernel)."""
    dx = TWO_PI / n
    w = m * dx
    npoly = m + 4  # polynomial degree npoly - 1 (kaiser_bessel.jl:128)
    real_dtype = jnp.dtype(dtype)

    def _poly_fields(cs64: np.ndarray):
        return dict(cs_poly=jnp.asarray(cs64, dtype=real_dtype))

    if isinstance(kernel, KaiserBesselKernel):
        beta = kernel.beta if kernel.beta is not None else _optimal_beta_kb(m, sigma)
        from scipy.special import i0 as _i0

        peak = float(_i0(beta))  # phi(0); see KernelData.peak
        cs = _solve_piecewise_polynomial_coefficients(
            lambda y: _i0(beta * np.sqrt(np.maximum(1.0 - y**2, 0.0))) / peak,
            m, npoly,
        )
        return KernelData(
            kind="kb", m=m, n=n, beta=float(beta), w=w, dx=dx, peak=peak,
            **_poly_fields(cs),
        )

    if isinstance(kernel, BackwardsKaiserBesselKernel):
        beta = kernel.beta if kernel.beta is not None else _optimal_beta_bkb(m, sigma)
        peak = float(math.sinh(beta) / math.pi)  # phi(0); see KernelData.peak

        def f(y):
            s = np.sqrt(np.maximum(1.0 - y**2, 0.0))
            with np.errstate(divide="ignore", invalid="ignore"):
                v = np.sinh(beta * s) / (s * np.pi)
            return np.where(s == 0.0, beta / np.pi, v) / peak

        cs = _solve_piecewise_polynomial_coefficients(f, m, npoly)
        return KernelData(
            kind="bkb", m=m, n=n, beta=float(beta), w=w, dx=dx, peak=peak,
            **_poly_fields(cs),
        )

    if isinstance(kernel, GaussianKernel):
        alpha = kernel.ell if kernel.ell is not None else _optimal_ell_gauss(m, sigma)
        ell = alpha * dx
        tau = 2.0 * ell**2
        # exp(-(e dx)^2 / tau) for node-offset exponents e = t - (M-1),
        # t = 0..2M-1 (used by the fast Gaussian gridding path).
        e = np.arange(2 * m, dtype=np.float64) - (m - 1)
        csg = np.exp(-((e * dx) ** 2) / tau)
        return KernelData(
            kind="gaussian", m=m, n=n, tau=float(tau), w=w, dx=dx,
            cs_gauss=jnp.asarray(csg, dtype=real_dtype),
        )

    if isinstance(kernel, BSplineKernel):
        return KernelData(kind="bspline", m=m, n=n, w=w, dx=dx)

    raise TypeError(f"unknown kernel type: {kernel!r}")


# ---------------------------------------------------------------------------
# Point -> cell mapping
# ---------------------------------------------------------------------------


def point_to_cell(x: jnp.ndarray, n: int):
    """Map folded points ``x in [0, 2pi)`` to 0-based cell indices.

    Returns ``(c, r)`` with ``r = (x / L) * N`` and ``c = trunc(r)`` clamped to
    ``[0, N-1]``.  The order of operations matches the reference exactly
    (src/Kernels/Kernels.jl:121-126); the clamp is a branchless safety net for
    points within one ulp of ``2pi`` in low precision.
    """
    L = jnp.asarray(TWO_PI, dtype=x.dtype)
    r = (x / L) * n
    c = jnp.clip(r.astype(jnp.int32), 0, n - 1)
    return c, r


def point_to_cell_split(x: jnp.ndarray, n: int):
    """High-accuracy cell decomposition for the blocked fast path: map raw
    (possibly unfolded) coordinates to ``(c, X)`` with ``c`` the 0-based
    cell in ``[0, N)`` and ``X = r - floor(r) in [0, 1)`` the in-cell
    fraction of ``r = x * N / 2pi`` (folding is the mod-N on ``r``).

    In f32 the naive ``(x/L)*N`` carries an *absolute* error of
    ``N * 2^-24`` cells (2.3e-5 at N=384), which bounds the accuracy of
    the whole float32 transform.  Here the product is
    evaluated in double-single arithmetic (Veltkamp-split operands, exact
    high product), reducing the fraction error to ~2^-24 of one cell; f64
    inputs take the plain path (already exact enough).
    """
    if x.dtype == jnp.float64:
        r = x * (np.float64(n) / np.float64(TWO_PI))
        i = jnp.floor(r)
        X = r - i
        c = jnp.mod(i.astype(jnp.int64), n).astype(jnp.int32)
        return c, X.astype(x.dtype)

    # k = N / 2pi split so that x_hi * k_hi is exact in f32: both keep 12
    # significand bits (11 stored + implicit), 12 + 12 <= 24.  (Round-1
    # used a 13-bit k_hi mask — a 25-bit product whose rounding put
    # ~2^-17 = 7.6e-6 cells of noise on the fraction, the measured floor
    # of the whole f32 pipeline.)
    k = np.float64(n) / np.float64(TWO_PI)
    k_hi = np.float32(
        np.frombuffer(
            (np.frombuffer(np.float32(k).tobytes(), np.uint32) & np.uint32(0xFFFFF000)).tobytes(),
            np.float32,
        )[0]
    )
    k_lo = np.float32(k - np.float64(k_hi))  # next ~24 bits of k
    xb = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    x_hi = jax.lax.bitcast_convert_type(xb & jnp.uint32(0xFFFFF000), jnp.float32)
    x_lo = x - x_hi  # exact
    r_main = x_hi * jnp.float32(k_hi)  # exact product
    r_rest = x_lo * jnp.float32(k_hi) + x * jnp.float32(k_lo)
    i_main = jnp.floor(r_main)
    f_main = r_main - i_main  # exact (Sterbenz)
    t = f_main + r_rest
    extra = jnp.floor(t)
    X = t - extra
    i = i_main.astype(jnp.int32) + extra.astype(jnp.int32)
    c = jnp.mod(i, n)
    return c, X.astype(x.dtype)


# ---------------------------------------------------------------------------
# Window evaluation: per-point (..., 2M) value tensors
# ---------------------------------------------------------------------------


def _eval_bkb_direct(kd: KernelData, y: jnp.ndarray) -> jnp.ndarray:
    """Peak-normalised BKB window sinh(beta s)/(s sinh beta), s = sqrt(1-y^2).

    Shifted exponents (multiply num and den by e^{-beta}) keep every
    intermediate <= 1 instead of the raw sinh's e^beta; the s -> 0 edge
    limit sinh(bs)/bs -> 1 becomes e^{-beta} after the shift (reference
    handles the same limit on the raw form,
    kaiser_bessel_backwards.jl:158-175)."""
    beta = jnp.asarray(kd.beta, dtype=y.dtype)
    z = jnp.maximum(1.0 - y * y, 0.0)
    s = jnp.sqrt(z)
    bs = beta * s
    em = jnp.exp(bs - beta)
    ep = jnp.exp(-bs - beta)
    sinh_s = 0.5 * (em - ep)  # sinh(bs) * e^{-beta}
    ratio = jnp.where(
        bs == 0.0,
        jnp.asarray(math.exp(-kd.beta), dtype=y.dtype),
        sinh_s / jnp.where(bs == 0.0, 1.0, bs),
    )
    # beta / (sinh(beta) e^{-beta}); ratio * pref == 1 at the peak (y = 0).
    pref = kd.beta / (-0.5 * math.expm1(-2.0 * kd.beta))
    return ratio * jnp.asarray(pref, dtype=y.dtype)


def _eval_kb_direct(kd: KernelData, y: jnp.ndarray) -> jnp.ndarray:
    beta = jnp.asarray(kd.beta, dtype=y.dtype)
    z = jnp.maximum(1.0 - y * y, 0.0)
    # Normalised by phi(0) = I0(beta) (see KernelData.peak); I0(beta) itself
    # stays f32-representable up to beta ~ 88 (m ~ 22).
    return besseli0(beta * jnp.sqrt(z)) * jnp.asarray(
        1.0 / kd.peak, dtype=y.dtype
    )


def _eval_gaussian_direct(kd: KernelData, yphys: jnp.ndarray) -> jnp.ndarray:
    tau = jnp.asarray(kd.tau, dtype=yphys.dtype)
    return jnp.exp(-(yphys * yphys) / tau)


def bspline_values_list(xp: jnp.ndarray, order: int):
    """All ``order`` non-zero B-splines of order ``order`` at the normalised
    coordinate ``xp in [0, 1]`` via the de Boor recurrence (reference:
    src/Kernels/bspline.jl:143-222), returned as a list of arrays (one per
    node, reference ``values`` ordering)."""
    dtype = xp.dtype
    b = [jnp.ones_like(xp)]
    for q in range(2, order + 1):
        alpha = 1.0 / (q - 1)
        deltas = [(xp + j) * jnp.asarray(alpha, dtype) for j in range(q - 1)]
        new = [deltas[0] * b[0]]
        for j in range(1, q - 1):
            new.append((1.0 - deltas[j - 1]) * b[j - 1] + deltas[j] * b[j])
        new.append((1.0 - deltas[q - 2]) * b[q - 2])
        b = new
    return b


def _eval_bspline_all(xp: jnp.ndarray, order: int) -> jnp.ndarray:
    """Stacked variant of :func:`bspline_values_list`: shape
    ``xp.shape + (order,)``."""
    return jnp.stack(bspline_values_list(xp, order), axis=-1)


def _horner_piecewise(cs: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """Evaluate all 2M piecewise polynomials at the same coordinate
    ``z = 2X - 1`` with one Horner recurrence (reference:
    piecewise_polynomial.jl:76-92).  ``cs`` has shape (Npoly, 2M); output has
    shape ``z.shape + (2M,)``."""
    cs = cs.astype(z.dtype)
    npoly = cs.shape[0]
    zb = z[..., None]
    acc = jnp.broadcast_to(cs[npoly - 1], z.shape + (cs.shape[1],))
    for q in range(npoly - 2, -1, -1):
        acc = acc * zb + cs[q]
    return acc


def eval_window(kd: KernelData, evalmode: EvaluationMode, r: jnp.ndarray, c: jnp.ndarray):
    """Evaluate the 2M window values for each point.

    ``r = (x/L)*N`` and ``c = trunc(r)`` come from :func:`point_to_cell`.
    Returns an array of shape ``r.shape + (2M,)``; entry ``t`` is the weight of
    grid node ``c - M + 1 + t`` (0-based, to be wrapped mod N by the caller).
    """
    return eval_window_frac(kd, evalmode, r - c.astype(r.dtype))


def eval_window_frac(kd: KernelData, evalmode: EvaluationMode, X: jnp.ndarray):
    """Same as :func:`eval_window` but taking the in-cell fraction
    ``X = r - c in [0, 1)`` directly (the high-accuracy path computes it via
    :func:`point_to_cell_split`)."""
    m = kd.m
    r = X  # dtype carrier
    t = jnp.arange(2 * m, dtype=r.dtype)

    fast = isinstance(evalmode, FastApproximation)

    if kd.kind in ("kb", "bkb"):
        if fast:
            return _horner_piecewise(kd.cs_poly, 2.0 * X - 1.0)
        y = (m - 1.0 - t + X[..., None]) / m
        return _eval_kb_direct(kd, y) if kd.kind == "kb" else _eval_bkb_direct(kd, y)

    if kd.kind == "gaussian":
        if fast:
            # Fast Gaussian gridding (Greengard & Lee; reference:
            # gaussian.jl:125-138, 155-192): one exp for the point offset, one
            # log/exp pair for the geometric ladder, precomputed node factors.
            dx = jnp.asarray(kd.dx, dtype=r.dtype)
            tau = jnp.asarray(kd.tau, dtype=r.dtype)
            Xp = X * dx
            a = jnp.exp(-(Xp * Xp) / tau)
            e = t - (m - 1.0)  # node-offset exponents -(M-1) .. M
            bpow = jnp.exp((2.0 * Xp * dx / tau)[..., None] * e)
            return a[..., None] * kd.cs_gauss.astype(r.dtype) * bpow
        yphys = (m - 1.0 - t + X[..., None]) * jnp.asarray(kd.dx, dtype=r.dtype)
        return _eval_gaussian_direct(kd, yphys)

    if kd.kind == "bspline":
        return _eval_bspline_all(1.0 - X, 2 * m)

    raise ValueError(f"unknown kernel kind {kd.kind}")


# ---------------------------------------------------------------------------
# Fourier coefficients phi_hat(k)
# ---------------------------------------------------------------------------


def fourier_coefficients_np(kd: KernelData, k: np.ndarray) -> np.ndarray:
    """phi_hat at wavenumbers ``k`` (host-side, float64; plan time only).

    These are the continuous Fourier transforms of the (physical-units)
    windows, matching the reference's ``evaluate_fourier_func`` of each kernel
    file — divided by the same ``kd.peak`` the evaluators use (the
    normalisation cancels exactly in both transform types; see
    KernelData.peak); used to build the deconvolution factors.
    """
    k = np.asarray(k, dtype=np.float64)
    if kd.kind == "kb":
        q = kd.w * k
        s2 = kd.beta**2 - q**2
        s = np.sqrt(np.maximum(s2, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            v = 2.0 * kd.w * np.sinh(s) / s
        return np.where(s == 0.0, 2.0 * kd.w, v) / kd.peak
    if kd.kind == "bkb":
        from scipy.special import i0 as _i0

        q = kd.w * k
        s = np.sqrt(np.maximum(kd.beta**2 - q**2, 0.0))
        return kd.w * _i0(s) / kd.peak
    if kd.kind == "gaussian":
        return np.sqrt(np.pi * kd.tau) * np.exp(-kd.tau * k**2 / 4.0)
    if kd.kind == "bspline":
        kh = k * kd.dx / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            s = np.sin(kh) / kh
        s = np.where(k == 0.0, 1.0, s)
        return kd.dx * s ** (2 * kd.m)
    raise ValueError(kd.kind)
