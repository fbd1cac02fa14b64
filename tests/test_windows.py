"""Window-kernel math tests.

Ports the content of the reference's test/approx_window_functions.jl
(FastApproximation vs Direct pointwise agreement) plus basic invariants of
each window family.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import nonuniformffts_tpu as nufft
from nonuniformffts_tpu.ops import windows

KERNELS = [
    nufft.KaiserBesselKernel(),
    nufft.BackwardsKaiserBesselKernel(),
    nufft.GaussianKernel(),
    nufft.BSplineKernel(),
]


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: type(k).__name__)
@pytest.mark.parametrize("m", [2, 4, 6])
def test_fast_approximation_matches_direct(kernel, m, rng):
    """Reference: test/approx_window_functions.jl:9-24 (rtol 1e-7)."""
    n = 64
    kd = windows.make_kernel_data(kernel, m, n, 2.0, np.float64)
    x = jnp.asarray(rng.uniform(0, 2 * np.pi, 1000))
    c, r = windows.point_to_cell(x, n)
    v_direct = np.asarray(windows.eval_window(kd, nufft.Direct(), r, c))
    v_fast = np.asarray(windows.eval_window(kd, nufft.FastApproximation(), r, c))
    scale = np.abs(v_direct).max()
    # Npoly = M + 4: the approximation error shrinks with M; at M = 2 the
    # window itself is only ~1e-2 accurate, so 1e-4 is ample there.
    tol = 1e-4 if m == 2 else 1e-7
    assert np.abs(v_fast - v_direct).max() / scale < tol


def test_point_to_cell_in_bounds_near_two_pi():
    """The (x/L)*N order of operations keeps indices in bounds for points one
    ulp below 2 pi (reference: test/near_2pi.jl:19-46)."""
    for dtype in (np.float32, np.float64):
        two_pi = dtype(2 * np.pi)
        x = np.nextafter(two_pi, dtype(0.0))
        for n in (61, 64, 384, 509):
            c, r = windows.point_to_cell(jnp.asarray([x]), n)
            assert 0 <= int(c[0]) <= n - 1
            X = float(r[0]) - float(c[0])
            assert 0.0 <= X <= 1.0


def test_bspline_partition_of_unity(rng):
    """B-splines of any order sum to one at every evaluation point."""
    for m in (2, 3, 4):
        x = jnp.asarray(rng.uniform(0, 1, 200))
        vals = np.asarray(windows._eval_bspline_all(x, 2 * m))
        np.testing.assert_allclose(vals.sum(axis=-1), 1.0, rtol=1e-12)


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: type(k).__name__)
def test_fourier_coefficients_match_quadrature(kernel):
    """phi_hat(k) must equal the continuous Fourier transform of the window:
    the deconvolution identity the transforms rely on."""
    m, n = 4, 64
    kd = windows.make_kernel_data(kernel, m, n, 2.0, np.float64)
    # Dense quadrature of int phi(x) exp(-i k x) dx over the window support.
    dx_grid = kd.w / 20000.0
    xs = np.arange(-kd.w + dx_grid / 2, kd.w, dx_grid)
    # Evaluate the physical-units window phi(x), via the direct evaluators.
    y = jnp.asarray(xs / kd.w)
    if kd.kind == "kb":
        phi = np.asarray(windows._eval_kb_direct(kd, y))
    elif kd.kind == "bkb":
        phi = np.asarray(windows._eval_bkb_direct(kd, y))
    elif kd.kind == "gaussian":
        phi = np.asarray(windows._eval_gaussian_direct(kd, jnp.asarray(xs)))
    else:  # bspline, reconstructed from the de Boor all-values evaluator:
        # values[t] at point fraction X is the weight of node offset
        # s = t + 1 - M - X, so phi(s) = values[M + floor(s)] at X = ceil(s)-s.
        order = 2 * m
        s = xs / kd.dx  # node offsets in grid units, in [-M, M)
        frac = s - np.floor(s)
        t_idx = (np.floor(s).astype(int) + m).clip(0, order - 1)
        vals = np.asarray(windows._eval_bspline_all(jnp.asarray(frac), order))
        phi = vals[np.arange(len(s)), t_idx]
        phi[(s < -m) | (s >= m)] = 0.0
    for k in (0.0, 1.0, 5.0, float(n // 4)):
        quad = np.sum(phi * np.exp(-1j * k * xs)) * dx_grid
        ref = windows.fourier_coefficients_np(kd, np.array([k]))[0]
        assert abs(quad.real - ref) < 2e-4 * abs(
            windows.fourier_coefficients_np(kd, np.array([0.0]))[0]
        ), (kd.kind, k, quad.real, ref)


def test_optimal_parameters_match_reference_formulas():
    # KB: beta = gamma * M * pi * (2 - 1/sigma), gamma Beatty.
    m, sigma = 4, 2.0
    a = m * (2 - 1 / sigma)
    beta_kb = np.pi * a * np.sqrt(1 - 0.8 / a**2)
    kd = windows.make_kernel_data(nufft.KaiserBesselKernel(), m, 64, sigma, np.float64)
    assert np.isclose(kd.beta, beta_kb)
    beta_bkb = np.pi * a * max(0.995, np.sqrt(1 - 0.3 / a**2))
    kd = windows.make_kernel_data(
        nufft.BackwardsKaiserBesselKernel(), m, 64, sigma, np.float64
    )
    assert np.isclose(kd.beta, beta_bkb)
    # Explicit beta overrides the default.
    kd = windows.make_kernel_data(
        nufft.KaiserBesselKernel(beta=10.0), m, 64, sigma, np.float64
    )
    assert kd.beta == 10.0


def test_besseli0_matches_scipy():
    """besseli0 (the direct Kaiser-Bessel window's I0) must track scipy's
    i0 to the f64 floor over the full kernel argument range [0,
    beta_max], and stay finite and f32-accurate in float32."""
    from scipy.special import i0 as scipy_i0

    from nonuniformffts_tpu.utils.besseli0 import besseli0

    x = np.linspace(0.0, 50.0, 20001)
    got = np.asarray(besseli0(jnp.asarray(x, jnp.float64)))
    want = scipy_i0(x)
    rel = np.max(np.abs(got - want) / want)
    assert rel < 1e-13, rel
    # f32: the exp(x) dynamic range bounds the relative error at ~x*eps
    got32 = np.asarray(besseli0(jnp.asarray(x, jnp.float32)))
    assert np.all(np.isfinite(got32))
    rel32 = np.max(np.abs(got32 - want) / want)
    assert rel32 < 1e-5, rel32
