"""NUFFT plans: static transform configuration + precomputed device tensors.

Counterpart of the reference's ``PlanNUFFT`` (src/plan.jl).  A plan is an
immutable pytree dataclass: configuration (sizes, kernel choice,
half-support, ...) is static metadata that becomes compile-time constants of
the jitted transforms — the analogue of the reference's type-level
parameters ``HalfSupport{M}`` / ``Val(ntransforms)`` — while the precomputed
tensors (piecewise-polynomial coefficients, deconvolution factors, sorted
point state) are array leaves living on device.

``set_points`` is functional: it returns a *new* plan holding the folded
(and, for the blocked method, bin-sorted) points, replacing the reference's
mutating ``set_points!`` (src/set_points.jl).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import backend
from .ops import deconvolve, windows
from .ops.windows import (
    AbstractKernel,
    BackwardsKaiserBesselKernel,
    EvaluationMode,
    FastApproximation,
    KernelData,
)
from .utils.misc import next_fast_len
from .utils.pytree import data_field, register_pytree_dataclass, static_field

TWO_PI = 2.0 * math.pi

#: Spreading methods a plan can run.
METHODS = ("reference", "blocked", "direct")

#: Points per oversampled grid cell from which ``'auto'`` picks the blocked
#: kernel on a GPU.  Measured end to end on an H100 (set_points + type 1 +
#: type 2; one complex64 transform, 3-D, M = 4, 384^3 grid; PERF.md): the
#: jnp path wins by 18% at 0.018 (Np = 1e6), the two are level at 0.035
#: (Np = 2e6), and the blocked path wins by 1.43x at rho = 1.
BLOCKED_MIN_DENSITY = 1 / 32


def _identity(x):
    return x


@register_pytree_dataclass
class Plan:
    """See :func:`PlanNUFFT` for the user-facing constructor."""

    # --- static configuration -------------------------------------------
    dtype: Any = static_field()  # np.dtype of non-uniform data (real or complex)
    shape: Tuple[int, ...] = static_field()  # output (non-oversampled) dims
    shape_over: Tuple[int, ...] = static_field()  # oversampled grid dims
    m: int = static_field()  # kernel half-support M
    sigma: float = static_field()  # actual oversampling factor (max over dims)
    kernel: AbstractKernel = static_field()
    evalmode: EvaluationMode = static_field()
    ntransforms: int = static_field()
    fftshift: bool = static_field()
    # 'reference' | 'blocked' | 'direct', or 'auto' until set_points sees
    # the number of points.
    spread_method: str = static_field()
    block_dims: Optional[Tuple[int, ...]] = static_field(default=None)
    sort_points: bool = static_field(default=False)
    point_transform: Callable = static_field(default=_identity)
    # Points per stencil chunk on the jnp paths (None = all at once).
    chunk_size: Optional[int] = static_field(default=None)
    interpret: bool = static_field(default=False)  # Pallas interpreter (tests)
    # Host-side per-stage Timer (utils.timer.Timer) or None.  When set, the
    # execution functions run stage-by-stage with device sync between stages
    # (the analogue of the reference's TimerOutputs + synchronise=true,
    # src/NonuniformFFTs.jl:157-185, src/plan.jl:453-454).
    timer: Optional[Any] = static_field(default=None)

    # --- precomputed tensors --------------------------------------------
    kernel_data: Tuple[KernelData, ...] = data_field(default=())
    phihat_inv: Tuple[jnp.ndarray, ...] = data_field(default=())  # 1/phi_hat per dim
    # Per-dim (src_start, length) slice ranges mapping output modes into the
    # oversampled FFT axis — static so trunc/pad lower to slices, not gathers.
    index_ranges: Tuple = static_field(default=())
    kvec: Tuple[jnp.ndarray, ...] = data_field(default=())  # output wavenumbers

    # --- point state (set by set_points) --------------------------------
    points: Optional[jnp.ndarray] = data_field(default=None)  # (D, Np) folded
    # Reference-path spatial sort (sort_points=True): points stored in
    # cell-major order for scatter/gather locality (reference:
    # src/blocking/gpu.jl:130-139); values permute in, results permute out.
    point_perm: Optional[jnp.ndarray] = data_field(default=None)  # (Np,)
    point_perm_inv: Optional[jnp.ndarray] = data_field(default=None)  # (Np,)
    # Blocked path: points bin-sorted by block.  ``cells``/``fracs`` are the
    # high-accuracy cell split (windows.point_to_cell_split) in sorted
    # order, ``sort_perm`` the original index of each sorted point and
    # ``pstarts`` each block's range of sorted positions.
    cells: Optional[jnp.ndarray] = data_field(default=None)  # (D, Np) int32
    fracs: Optional[jnp.ndarray] = data_field(default=None)  # (D, Np)
    sort_perm: Optional[jnp.ndarray] = data_field(default=None)  # (Np,)
    pstarts: Optional[jnp.ndarray] = data_field(default=None)  # (nblocks+1,)

    # --------------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_real(self) -> bool:
        return not np.issubdtype(np.dtype(self.dtype), np.complexfloating)

    @property
    def real_dtype(self):
        return np.dtype(self.dtype).type(0).real.dtype

    @property
    def complex_dtype(self):
        return np.result_type(np.dtype(self.dtype), np.complex64)

    @property
    def spectral_shape(self) -> Tuple[int, ...]:
        """Dimensions of the uniform-data arrays (Fourier space), the
        counterpart of ``size(::PlanNUFFT)`` (src/plan.jl:420-426).  For
        real-data plans the *last* axis is halved (XLA rfft convention)."""
        if self.is_real:
            return self.shape[:-1] + (self.shape[-1] // 2 + 1,)
        return self.shape

    @property
    def spectral_shape_over(self) -> Tuple[int, ...]:
        if self.is_real:
            return self.shape_over[:-1] + (self.shape_over[-1] // 2 + 1,)
        return self.shape_over

    @property
    def num_points(self) -> Optional[int]:
        return None if self.points is None else self.points.shape[1]

    @property
    def num_blocks(self) -> Tuple[int, ...]:
        return tuple(n // b for n, b in zip(self.shape_over, self.block_dims))

    @property
    def normfactor(self) -> float:
        """FFT normalisation ``prod(2pi / N~)`` (NonuniformFFTs.jl:181)."""
        out = 1.0
        for n in self.shape_over:
            out *= TWO_PI / n
        return out

    # Convenience (functional) methods mirroring the reference's API.
    def set_points(self, points) -> "Plan":
        return set_points(self, points)

    def exec_type1(self, vp, callbacks=None):
        from .execution import exec_type1

        return exec_type1(self, vp, callbacks=callbacks)

    def exec_type2(self, uhat, callbacks=None):
        from .execution import exec_type2

        return exec_type2(self, uhat, callbacks=callbacks)

    def __repr__(self):  # mirrors the reference's Base.show (plan.jl:362-392)
        lines = [
            f"{self.ndim}-dimensional PlanNUFFT with input type {np.dtype(self.dtype).name}:",
            f"  - kernel: {self.kernel} with half-support M = {self.m}",
            f"  - evaluation mode: {type(self.evalmode).__name__}",
            f"  - oversampling factor: sigma = {self.sigma:.6g}",
            f"  - uniform dimensions: {self.spectral_shape} (oversampled grid {self.shape_over})",
            f"  - simultaneous transforms: {self.ntransforms}",
            f"  - frequency order: {'increasing' if self.fftshift else 'FFTW'} (fftshift = {self.fftshift})",
            f"  - spreading method: {self.spread_method}"
            + (f", block dims {self.block_dims}" if self.block_dims else ""),
            f"  - points set: {self.num_points if self.points is not None else 'no'}",
        ]
        if self.spread_method == "blocked" and self.block_dims:
            nblocks = int(np.prod(self.num_blocks))
            lines.append(f"  - blocked geometry: {nblocks} blocks")
        if self.timer is not None:
            lines.append(f"  - timer attached (synchronise={self.timer.synchronise})")
        return "\n".join(lines)


def _check_nufft_size(n_over: int, m: int):
    if n_over < 2 * m:
        raise ValueError(
            f"data size is too small: sigma*N = {n_over} < {2 * m} = 2M. Try "
            "increasing N or sigma, or decreasing the kernel half-support M."
        )


def stencil_bytes_per_point(dtype, ndim: int, m: int, ntransforms: int) -> int:
    """Transient bytes one point costs on the jnp stencil paths: its
    (2M)^D linear indices (int32) and weights, and the weighted values of
    every transform (the scatter's update operand)."""
    dt = np.dtype(dtype)
    real = dt.type(0).real.dtype.itemsize
    S = (2 * m) ** ndim
    return S * (4 + real + ntransforms * dt.itemsize)


def auto_chunk_size(dtype, ndim: int, m: int, ntransforms: int) -> int:
    """Points per stencil chunk: the device memory budget of
    :func:`backend.stencil_budget_bytes` over the per-point stencil
    bytes."""
    per_point = stencil_bytes_per_point(dtype, ndim, m, ntransforms)
    return max(backend.stencil_budget_bytes() // per_point, 1024)


def resolve_method(dtype, shape_over, m: int, ntransforms: int,
                   num_points: int, block_dims=None) -> str:
    """What ``spread_method='auto'`` runs for ``num_points`` points.

    The blocked kernel runs on a GPU only, and is picked only where it was
    measured faster end to end: one complex64 transform on a 3-D grid with
    M = 4, from :data:`BLOCKED_MIN_DENSITY` points per oversampled cell.
    Its padded block buffer and the grid must also fit
    :func:`backend.spread_buffer_budget_bytes`.  Everywhere else the jnp
    path runs."""
    measured = (
        np.dtype(dtype) == np.complex64 and len(shape_over) == 3
        and m == 4 and ntransforms == 1
    )
    if not (backend.on_gpu() and measured):
        return "reference"
    cells = int(np.prod(shape_over))
    if num_points / cells < BLOCKED_MIN_DENSITY:
        return "reference"
    from .ops.pallas.spread import padded_buffer_bytes

    channels = 2 * ntransforms
    need = padded_buffer_bytes(shape_over, m, channels, block_dims)
    need += 4 * channels * cells
    if need > backend.spread_buffer_budget_bytes():
        return "reference"
    return "blocked"


def PlanNUFFT(
    dtype,
    shape,
    *,
    m: int = 4,
    sigma: float = 2.0,
    kernel: AbstractKernel = None,
    kernel_evalmode: EvaluationMode = None,
    ntransforms: int = 1,
    fftshift: bool = False,
    spread_method: str = "auto",
    block_dims=None,
    sort_points: bool = False,
    point_transform: Callable = _identity,
    chunk_size: Optional[int] = None,
    interpret: bool = False,
    np_hint: Optional[int] = None,
    timer=None,
) -> Plan:
    """Construct a NUFFT plan (counterpart of ``PlanNUFFT`` in src/plan.jl).

    Parameters mirror the reference: ``dtype`` is the non-uniform data type
    (real dtypes select the r2c fast path), ``shape`` the uniform grid
    dimensions, ``m`` the kernel half-support, ``sigma`` the oversampling
    factor, ``kernel`` one of the four window kernels (default backwards
    Kaiser-Bessel), ``ntransforms`` the number of simultaneous transforms over
    shared points and ``fftshift`` the frequency ordering.

    ``spread_method`` selects the execution path: ``'reference'`` is the
    pure-jnp scatter/gather path; ``'blocked'`` bin-sorts the points and
    spreads with the Pallas block-owner kernel (a GPU, or the interpreter
    with ``interpret=True``); ``'direct'`` evaluates the exact sums with no
    grid; ``'auto'`` (default) picks from the platform, the dtype and the
    point density (``np_hint``, else the points given to ``set_points``).

    ``chunk_size`` bounds the points whose stencils exist at once on the
    jnp paths; by default it follows the device's memory.  ``interpret``
    runs the Pallas kernel in the interpreter — a test hook for hosts
    without a GPU.
    """
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(n) for n in shape)
    D = len(shape)
    if not 1 <= D <= 3:
        raise ValueError(f"only 1-3 dimensions supported, got {D}")
    dtype = np.dtype(dtype)
    if dtype not in (
        np.dtype(np.float32),
        np.dtype(np.float64),
        np.dtype(np.complex64),
        np.dtype(np.complex128),
    ):
        raise TypeError(f"unsupported non-uniform data dtype {dtype}")
    is_real = not np.issubdtype(dtype, np.complexfloating)
    real_dtype = dtype.type(0).real.dtype
    if spread_method not in METHODS + ("auto",):
        raise ValueError(f"unknown spread_method {spread_method!r}")
    if interpret and backend.on_gpu():
        raise ValueError(
            "interpret=True runs the Pallas kernel in the interpreter, a test "
            "hook for hosts without a GPU; on a GPU the kernel runs compiled"
        )

    if kernel is None:
        kernel = BackwardsKaiserBesselKernel()
    if kernel_evalmode is None:
        kernel_evalmode = FastApproximation()

    # Oversampled grid dims: next 5-smooth integer >= sigma*N; for real-data
    # plans the halved (last) axis is forced even (reference: plan.jl:485-498,
    # which applies the rule to its halved *first* axis).
    shape_over = []
    for d, n in enumerate(shape):
        if is_real and d == D - 1:
            n_over = 2 * next_fast_len(int(math.floor(sigma * ((n + 1) // 2))))
        else:
            n_over = next_fast_len(int(math.floor(sigma * n)))
        _check_nufft_size(n_over, m)
        shape_over.append(n_over)
    shape_over = tuple(shape_over)

    sigma_actual = max(no / n for no, n in zip(shape_over, shape))

    # Per-dimension kernel data with the per-dim actual oversampling factor
    # (plan.jl:500-505).
    kernel_data = tuple(
        windows.make_kernel_data(kernel, m, n_over, n_over / n, real_dtype)
        for n, n_over in zip(shape, shape_over)
    )

    # Output wavenumbers, deconvolution factors and slice ranges per dim.
    kvec_np, phinv_np, iranges = [], [], []
    for d, (n, n_over, kd) in enumerate(zip(shape, shape_over, kernel_data)):
        r2c = is_real and d == D - 1
        k = deconvolve.output_wavenumbers(n, r2c=r2c, fftshift=fftshift and not r2c)
        ph = windows.fourier_coefficients_np(kd, k)
        n_over_spec = (n_over // 2 + 1) if r2c else n_over
        iranges.append(
            deconvolve.truncate_ranges(
                len(k), n_over_spec, r2c=r2c, fftshift=fftshift and not r2c
            )
        )
        kvec_np.append(k)
        phinv_np.append(1.0 / ph)

    if block_dims is not None:
        from .ops.pallas.spread import check_block_dims

        block_dims = check_block_dims(tuple(int(b) for b in block_dims),
                                      shape_over, m)
    if spread_method == "auto" and np_hint is not None:
        spread_method = resolve_method(dtype, shape_over, m, ntransforms,
                                       int(np_hint), block_dims)
    if spread_method == "blocked" and real_dtype.itemsize != 4:
        raise ValueError(
            "spread_method='blocked' runs a float32 kernel (Pallas's Triton "
            "route accumulates products in float32); 64-bit plans use "
            "spread_method='reference'"
        )
    if spread_method == "direct" and sort_points:
        # No locality to exploit; the value order must match the stored
        # point order.
        raise ValueError("sort_points is not supported with spread_method='direct'")

    if chunk_size is None:
        chunk_size = auto_chunk_size(dtype, D, m, ntransforms)

    plan = Plan(
        dtype=dtype,
        shape=shape,
        shape_over=shape_over,
        m=int(m),
        sigma=float(sigma_actual),
        kernel=kernel,
        evalmode=kernel_evalmode,
        ntransforms=int(ntransforms),
        fftshift=bool(fftshift),
        spread_method=spread_method,
        block_dims=block_dims,
        sort_points=bool(sort_points),
        point_transform=point_transform,
        chunk_size=int(chunk_size),
        interpret=bool(interpret),
        timer=timer,
        kernel_data=kernel_data,
        phihat_inv=tuple(jnp.asarray(p, dtype=real_dtype) for p in phinv_np),
        index_ranges=tuple(iranges),
        kvec=tuple(jnp.asarray(k, dtype=real_dtype) for k in kvec_np),
    )
    if spread_method == "blocked":
        plan = _with_block_geometry(plan)
    return plan


def _with_block_geometry(plan: Plan) -> Plan:
    """Fill in the blocked method's block dims (when the user gave none)."""
    if plan.block_dims is not None:
        return plan
    from .ops.pallas.spread import choose_block_dims

    return dataclasses.replace(
        plan, block_dims=choose_block_dims(plan.shape_over, plan.m)
    )


# ---------------------------------------------------------------------------
# set_points
# ---------------------------------------------------------------------------


def _canonicalise_points(points, D: int, real_dtype) -> jnp.ndarray:
    """Accept the reference's input formats (src/set_points.jl): a tuple/list
    of D vectors, a 1-D vector (D == 1), an (Np, D) array of point tuples, or
    a (D, Np) matrix.  Returns a (D, Np) array."""
    if isinstance(points, (tuple, list)):
        if len(points) != D:
            raise ValueError(f"expected {D} coordinate arrays, got {len(points)}")
        cols = [jnp.asarray(p, dtype=real_dtype).reshape(-1) for p in points]
        n0 = cols[0].shape[0]
        if any(c.shape[0] != n0 for c in cols):
            raise ValueError("coordinate arrays must have equal lengths")
        return jnp.stack(cols, axis=0)
    arr = jnp.asarray(points, dtype=real_dtype)
    if arr.ndim == 1:
        if D != 1:
            raise ValueError(f"1-D point array given for a {D}-D plan")
        return arr[None, :]
    if arr.ndim == 2:
        if arr.shape[0] == D:  # (D, Np) matrix, reference-style layout
            return arr
        if arr.shape[1] == D:
            return arr.T
        raise ValueError(f"point array shape {arr.shape} incompatible with D={D}")
    raise ValueError(f"point array must be 1- or 2-dimensional, got {arr.ndim}")


def fold_points(x: jnp.ndarray, point_transform: Callable = _identity) -> jnp.ndarray:
    """Apply the optional convention transform, then fold onto [0, 2pi)
    (reference: to_unit_cell, src/blocking/blocking.jl:26-33 — branchless)."""
    if point_transform is not _identity:
        x = point_transform(x)
    L = x.dtype.type(TWO_PI)
    # Non-finite coordinates propagate as NaN (mod(inf) = mod(nan) = nan),
    # matching the reference's to_unit_cell semantics: invalid input points
    # surface as NaN in the output rather than silently folding to 0.
    return jnp.mod(x, L)


@jax.jit
def _sort_points_jit(plan: Plan, pts: jnp.ndarray):
    """Blocked-path point preparation.  ``pts`` are transformed but NOT
    folded: folding is the mod-N built into the high-accuracy cell split
    (folding in f32 first would add 2pi*2^-24 of coordinate noise)."""
    from .blocking import sort_into_blocks

    return sort_into_blocks(plan.kernel_data, plan.block_dims, pts)


@jax.jit
def _spatial_sort_jit(plan: Plan, pts_f: jnp.ndarray):
    """Cell-major sort permutation (and its inverse) for the reference path."""
    from .blocking import cells_and_fracs

    cells, _ = cells_and_fracs(plan.kernel_data, pts_f)
    lin = cells[0]
    for d in range(1, plan.ndim):
        lin = lin * plan.kernel_data[d].n + cells[d]
    np_ = pts_f.shape[1]
    iota = jnp.arange(np_, dtype=jnp.int32)
    _, perm = jax.lax.sort_key_val(lin, iota)
    _, perm_inv = jax.lax.sort_key_val(perm, iota)
    return perm, perm_inv


def _timed(plan: Plan, fn, *args):
    if plan.timer is None:
        return fn(*args)
    with plan.timer.section("set_points"):
        out = fn(*args)
        plan.timer.sync(out)
    return out


def set_points(plan: Plan, points) -> Plan:
    """Return a new plan with the non-uniform points set (folded; bin-sorted
    when the blocked method is active)."""
    pts = _canonicalise_points(points, plan.ndim, plan.real_dtype)
    np_ = pts.shape[1]
    if plan.spread_method == "auto":
        method = resolve_method(plan.dtype, plan.shape_over, plan.m,
                                plan.ntransforms, np_, plan.block_dims)
        plan = dataclasses.replace(plan, spread_method=method)
        if method == "blocked":
            plan = _with_block_geometry(plan)
    pts_f = fold_points(pts, plan.point_transform)
    if plan.spread_method == "blocked":
        pts_t = pts if plan.point_transform is _identity else plan.point_transform(pts)
        cells, fracs, perm, pstarts = _timed(plan, _sort_points_jit, plan, pts_t)
        return dataclasses.replace(
            plan, points=pts_f, cells=cells, fracs=fracs, sort_perm=perm,
            pstarts=pstarts, point_perm=None, point_perm_inv=None,
        )
    perm = perm_inv = None
    if plan.sort_points:
        # Cell-major spatial sort for scatter/gather locality on the
        # reference path (reference: src/blocking/gpu.jl:130-139 physically
        # permutes point data when sort_points is on).  Values are permuted
        # at exec time; type-2 results are un-permuted on output.
        perm, perm_inv = _timed(plan, _spatial_sort_jit, plan, pts_f)
        pts_f = jnp.take(pts_f, perm, axis=1)
    return dataclasses.replace(
        plan,
        points=pts_f,
        point_perm=perm,
        point_perm_inv=perm_inv,
        cells=None,
        fracs=None,
        sort_perm=None,
        pstarts=None,
    )
