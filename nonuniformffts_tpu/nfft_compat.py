"""NFFT-ecosystem compatibility adapter.

Counterpart of the reference's AbstractNFFTs.jl interface layer
(src/abstractNFFTs.jl:115-245): an operator-style plan speaking the NFFT
convention rather than ours, so users of NFFT-style libraries can switch
without touching their math:

- points live in ``[-1/2, 1/2)^d`` (ours: ``[0, 2pi)^d``);
- opposite sign convention: the NFFT *forward* transform computes
  ``f_j = sum_k fhat[k] e^{-2pi i k.x_j}`` and the *adjoint* computes
  ``fhat[k] = sum_j f_j e^{+2pi i k.x_j}`` — realised by wrapping a
  :class:`~nonuniformffts_tpu.plan.Plan` whose ``point_transform`` maps
  ``x -> -2pi x`` before folding (reference:
  src/abstractNFFTs.jl:150-158 ``_transform_point_convention``);
- frequencies in *increasing* order, ``k = -N/2 .. N/2-1`` per axis
  (``fftshift=True``; reference default at src/abstractNFFTs.jl:219-225);
- accuracy requested as a relative tolerance ``reltol`` and mapped to
  ``(m, sigma)`` from the library's empirical error model (reference:
  ``accuracyParams``, src/abstractNFFTs.jl:173-188 — we derive the mapping
  from our own tested budgets in tests/test_accuracy.py instead of copying
  NFFT.jl's constants).

The adapter is functional like the rest of the library: ``forward`` /
``adjoint`` return arrays (the reference's in-place ``mul!`` has no
functional analogue), and ``with_nodes`` returns a new plan.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .execution import exec_type1, exec_type2
from .ops.windows import (
    AbstractKernel,
    BackwardsKaiserBesselKernel,
    BSplineKernel,
    GaussianKernel,
    KaiserBesselKernel,
)
from .plan import TWO_PI, PlanNUFFT, set_points

#: Window-name map, mirroring the symbol names accepted by the NFFT
#: ecosystem (reference: src/abstractNFFTs.jl window symbol handling).
WINDOWS = {
    "kaiser_bessel": KaiserBesselKernel,
    "kaiser_bessel_rev": BackwardsKaiserBesselKernel,
    "backwards_kaiser_bessel": BackwardsKaiserBesselKernel,
    "gauss": GaussianKernel,
    "gaussian": GaussianKernel,
    "spline": BSplineKernel,
    "bspline": BSplineKernel,
}


def accuracy_params(reltol: float, *, f32: bool = False) -> Tuple[int, float]:
    """Map a requested relative tolerance to ``(m, sigma)``.

    Uses the (Backwards)Kaiser-Bessel error model validated by our accuracy
    sweep (tests/test_accuracy.py error_budget; BASELINE.md accuracy table):
    at sigma = 2 the L2 relative error is ~6 x 10^(-1.9 m).  The floor is
    the arithmetic's: ~4e-14 for f64 plans and ~2.5e-7 for f32 plans (f32
    window evaluation + spread/interp accumulation).  The reference
    performs the same kind of mapping in ``accuracyParams``
    (src/abstractNFFTs.jl:173-188).
    """
    if not 0.0 < reltol < 1.0:
        raise ValueError(f"reltol must be in (0, 1), got {reltol}")
    sigma = 2.0
    floor = 2.5e-7 if f32 else 4e-14
    target = max(float(reltol), floor)
    m = math.ceil(math.log10(6.0 / target) / 1.9)
    m = min(max(m, 2), 10)
    return m, sigma


def _transform_point_convention(x):
    """[-1/2, 1/2) NFFT coordinates -> our convention: t = -2pi x, folded to
    [0, 2pi) by set_points (sign flip realises the opposite transform sign;
    reference: src/abstractNFFTs.jl:150-158)."""
    return -TWO_PI * x


class NFFTPlan:
    """Operator-style NFFT plan (counterpart of the reference's ``NFFTPlan``
    wrapper, src/abstractNFFTs.jl:115-145).

    Parameters
    ----------
    x : array
        Non-uniform nodes in ``[-1/2, 1/2)^d``; shape ``(d, Np)`` (or
        anything :func:`set_points` accepts).
    N : tuple of int
        Uniform grid dimensions.
    reltol : float
        Requested relative accuracy; mapped to ``(m, sigma)`` via
        :func:`accuracy_params` unless both ``m`` and ``sigma`` are given.
    window : str
        Window name (see :data:`WINDOWS`).
    ntransforms, dtype, spread_method, ... forwarded to :func:`PlanNUFFT`.
    """

    def __init__(
        self,
        x,
        N,
        *,
        reltol: float = 1e-9,
        m: Optional[int] = None,
        sigma: Optional[float] = None,
        window: str = "kaiser_bessel",
        dtype=np.complex128,
        ntransforms: int = 1,
        **plan_kw,
    ):
        if isinstance(N, int):
            N = (N,)
        N = tuple(int(n) for n in N)
        dtype = np.dtype(dtype)
        if not np.issubdtype(dtype, np.complexfloating):
            raise TypeError(
                f"NFFT-convention plans are complex transforms, got {dtype}"
            )
        f32 = dtype == np.dtype(np.complex64)
        m_auto, sigma_auto = accuracy_params(reltol, f32=f32)
        if m is None:
            m = m_auto
        if sigma is None:
            sigma = sigma_auto
        try:
            kernel_cls = WINDOWS[window]
        except KeyError:
            raise ValueError(
                f"unknown window {window!r}; available: {sorted(set(WINDOWS))}"
            ) from None

        self.N = N
        self.reltol = float(reltol)
        self._plan = PlanNUFFT(
            dtype,
            N,
            m=int(m),
            sigma=float(sigma),
            kernel=kernel_cls(),
            ntransforms=ntransforms,
            fftshift=True,  # increasing frequency order, NFFT convention
            point_transform=_transform_point_convention,
            **plan_kw,
        )
        self._plan = set_points(self._plan, x)

    # -- geometry ---------------------------------------------------------
    @property
    def size_in(self) -> Tuple[int, ...]:
        """Shape of the frequency-domain input of ``forward`` (= N)."""
        return self.N

    @property
    def size_out(self) -> Tuple[int, ...]:
        """Shape of the node-domain output of ``forward`` (= (Np,))."""
        return (self._plan.num_points,)

    @property
    def num_nodes(self) -> int:
        return self._plan.num_points

    @property
    def plan(self):
        """The wrapped native :class:`Plan` (our convention)."""
        return self._plan

    def with_nodes(self, x) -> "NFFTPlan":
        """Return a new plan with updated nodes (reference ``nodes!``,
        src/abstractNFFTs.jl:163-171, made functional)."""
        import copy

        out = copy.copy(self)
        out._plan = set_points(self._plan, x)
        return out

    # -- transforms ---------------------------------------------------------
    def forward(self, fhat) -> jnp.ndarray:
        """``f_j = sum_k fhat[k] e^{-2pi i k.x_j}`` (NFFT trafo; our type 2
        through the sign-flipping point transform)."""
        fhat = jnp.asarray(fhat, dtype=self._plan.complex_dtype)
        return exec_type2(self._plan, fhat)

    def adjoint(self, f) -> jnp.ndarray:
        """``fhat[k] = sum_j f_j e^{+2pi i k.x_j}`` (NFFT adjoint; our
        type 1)."""
        f = jnp.asarray(f, dtype=self._plan.complex_dtype)
        return exec_type1(self._plan, f)

    # Operator sugar: plan @ fhat == forward; plan.H @ f == adjoint.
    def __matmul__(self, fhat):
        return self.forward(fhat)

    @property
    def H(self) -> "_AdjointNFFTPlan":
        return _AdjointNFFTPlan(self)

    def __repr__(self):
        return (
            f"NFFTPlan(N={self.N}, nodes={self._plan.num_points}, "
            f"reltol={self.reltol:g}, m={self._plan.m}, "
            f"sigma={self._plan.sigma:g})"
        )


class _AdjointNFFTPlan:
    """Lazy adjoint operator (``plan.H``), mirroring the reference's
    ``mul!(fhat, adjoint(p), f)`` path (src/abstractNFFTs.jl:138-145)."""

    def __init__(self, parent: NFFTPlan):
        self.parent = parent

    def __matmul__(self, f):
        return self.parent.adjoint(f)

    @property
    def H(self) -> NFFTPlan:
        return self.parent


def plan_nfft(x, N, **kw) -> NFFTPlan:
    """Convenience constructor (reference: ``plan_nfft``,
    src/abstractNFFTs.jl:238-245)."""
    return NFFTPlan(x, N, **kw)


def nfft(x, fhat, **kw) -> jnp.ndarray:
    """One-shot forward NFFT at nodes ``x`` of the frequency data ``fhat``."""
    fhat = np.asarray(fhat)
    return NFFTPlan(x, fhat.shape, dtype=fhat.dtype, **kw).forward(fhat)


def nfft_adjoint(x, f, N, **kw) -> jnp.ndarray:
    """One-shot adjoint NFFT of node values ``f`` onto an ``N`` grid."""
    f = np.asarray(f)
    return NFFTPlan(x, N, dtype=f.dtype, **kw).adjoint(f)
