"""Accuracy sweep vs the exact DFT oracle.

Port of the reference's test/accuracy.jl: kernel-specific empirical error
budgets as a function of the half-support M and the oversampling factor sigma
(accuracy.jl:7-78), swept over M for Float64/ComplexF64 and spot-checked for
Float32/ComplexF32.  Points are deliberately shifted by +-2pi outside the
domain to exercise folding (accuracy.jl:114-117).
"""

import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nufft_test_utils import direct_type1, direct_type2, direct_type2_real, l2_error, random_values


def error_budget(real_dtype, kernel, m, sigma):
    """Reference: check_nufft_error methods, test/accuracy.jl:7-78."""
    f64 = np.dtype(real_dtype) == np.dtype(np.float64)
    if isinstance(kernel, nufft.KaiserBesselKernel):
        if np.isclose(sigma, 1.25):
            budget = 10.0 ** (-1.16 * m) * 1.05
            return max(budget, 4e-12) if f64 else 2 * 10.0 ** (-1.16 * m)
        budget = 6 * 10.0 ** (-1.9 * m)
        return max(budget, 4e-14) if f64 else budget
    if isinstance(kernel, nufft.BackwardsKaiserBesselKernel):
        if np.isclose(sigma, 1.25):
            budget = 10.0 ** (-1.20 * m)
            return max(budget, 4e-12) if f64 else 2 * budget
        budget = 6 * 10.0 ** (-1.9 * m)
        return max(budget, 4e-14) if f64 else budget
    if isinstance(kernel, nufft.GaussianKernel):
        return 10.0 ** (-0.95 * m) * 0.8
    if isinstance(kernel, nufft.BSplineKernel):
        return 10.0 ** (-0.98 * m) * 0.4
    raise TypeError(kernel)


def run_1d(dtype, kernel, m, sigma, *, N=256, evalmode=None, rng=None, **plan_kw):
    rng = rng or np.random.default_rng(42)
    np_pts = 2 * N
    real_dtype = np.dtype(dtype).type(0).real.dtype
    x = rng.uniform(0, 2 * np.pi, np_pts)
    # Shift some points outside [0, 2pi) to exercise folding.
    x += rng.integers(-1, 2, np_pts) * 2 * np.pi
    v = random_values(rng, dtype, np_pts)

    plan = nufft.PlanNUFFT(
        dtype, (N,), m=m, sigma=sigma, kernel=kernel,
        kernel_evalmode=evalmode, **plan_kw,
    )
    plan = nufft.set_points(plan, x.astype(real_dtype))
    uhat = np.asarray(nufft.exec_type1(plan, v))
    kv = [np.asarray(plan.kvec[0], np.float64)]
    exact = direct_type1(x[None, :], v.astype(np.complex128), kv)
    err1 = l2_error(uhat, exact)

    # Type 2 with the type-1 output as input (Hermitian for real plans).
    u_in = uhat.astype(plan.complex_dtype)
    if plan.is_real:
        u_in = u_in.copy()
        u_in[-1] = 0  # zero Nyquist (reference: test/uniform_points.jl:26)
        exact2 = direct_type2_real(x[None, :], u_in.astype(np.complex128), kv, N)
    else:
        exact2 = direct_type2(x[None, :], u_in.astype(np.complex128), kv)
    v2 = np.asarray(nufft.exec_type2(plan, u_in))
    err2 = l2_error(v2, exact2)
    return err1, err2


KB = nufft.KaiserBesselKernel()
BKB = nufft.BackwardsKaiserBesselKernel()
GAUSS = nufft.GaussianKernel()
BSPL = nufft.BSplineKernel()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("m", [4, 6, 8, 10])
@pytest.mark.parametrize("sigma", [1.25, 2.0])
@pytest.mark.parametrize("kernel", [KB, BKB], ids=["KB", "BKB"])
def test_kb_family_f64(dtype, m, sigma, kernel):
    budget = error_budget(np.float64, kernel, m, sigma)
    err1, err2 = run_1d(dtype, kernel, m, sigma)
    assert err1 < budget, (err1, budget)
    assert err2 < budget, (err2, budget)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("m", [4, 6, 8])
@pytest.mark.parametrize("kernel", [GAUSS, BSPL], ids=["Gaussian", "BSpline"])
def test_gauss_bspline_f64(dtype, m, kernel):
    budget = error_budget(np.float64, kernel, m, 2.0)
    err1, err2 = run_1d(dtype, kernel, m, 2.0)
    assert err1 < budget, (err1, budget)
    assert err2 < budget, (err2, budget)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("kernel", [KB, BKB, GAUSS, BSPL], ids=["KB", "BKB", "Gaussian", "BSpline"])
def test_f32(dtype, kernel):
    m = 2
    sigma = 2.0
    budget = error_budget(np.float32, kernel, m, sigma)
    err1, err2 = run_1d(dtype, kernel, m, sigma)
    assert err1 < budget, (err1, budget)
    assert err2 < budget, (err2, budget)


@pytest.mark.parametrize("m", [6, 8, 10])
@pytest.mark.parametrize("kernel", [KB, BKB], ids=["KB", "BKB"])
def test_f32_high_m_dynamic_range(kernel, m):
    """Regression: unnormalised (B)KB windows peak at ~e^beta/2pi, which in
    f32 OVERFLOWS the D-dim window product at m >= 8 (nan) and UNDERFLOWS
    type-2's u/prod(phihat) padding at m >= 6 (the padded DC mode lands near
    1e-31 and the normalised inverse FFT flushes it to zero — the transform
    silently becomes a high-pass filter).  The peak-normalised windows
    (KernelData.peak) must keep every m at the f32 floor."""
    err1, err2 = run_1d(np.complex64, kernel, m, 2.0)
    assert np.isfinite(err1) and np.isfinite(err2), (err1, err2)
    # ~1.6e-5 = the f32 coordinate floor of the plain (x/L)*N cell split at
    # N_over=512; the broken unnormalised windows gave 1e-2 .. nan here.
    assert err1 < 5e-5, err1
    assert err2 < 5e-5, err2


@pytest.mark.parametrize("evalmode", [nufft.Direct(), nufft.FastApproximation()],
                         ids=["Direct", "FastApprox"])
def test_evalmodes_equivalent_accuracy(evalmode):
    err1, err2 = run_1d(np.complex128, BKB, 6, 1.25, evalmode=evalmode)
    budget = error_budget(np.float64, BKB, 6, 1.25)
    assert err1 < budget and err2 < budget


def test_explicit_kernel_parameters():
    """Passing explicit beta / ell overrides the defaults (reference:
    accuracy.jl:251-267) and still yields sane accuracy."""
    m, sigma = 6, 1.5
    a = m * (2 - 1 / sigma)
    beta = np.pi * a  # gamma = 1
    err1, _ = run_1d(np.complex128, nufft.KaiserBesselKernel(beta=beta), m, sigma)
    assert err1 < 1e-6
    err1, _ = run_1d(np.complex128, nufft.GaussianKernel(ell=1.2), 4, 2.0)
    assert err1 < 1e-2  # non-optimal width: just sanity


def test_chunked_spreading_matches_unchunked():
    """The scan-chunked scatter path must be bit-equivalent in results."""
    rng = np.random.default_rng(7)
    e_full = run_1d(np.complex128, BKB, 4, 1.25, rng=np.random.default_rng(7))
    e_chunk = run_1d(
        np.complex128, BKB, 4, 1.25, rng=np.random.default_rng(7), chunk_size=100
    )
    np.testing.assert_allclose(e_full, e_chunk, rtol=1e-12)


def test_r2c_halved_axis_nyquist_convention(rng):
    """The halved LAST axis of r2c plans stores k = 0..+N/2 with a POSITIVE
    Nyquist mode (rfft layout).  For non-uniform points e^{+iNx/2} and
    e^{-iNx/2} differ, so the convention is observable — and a benchmark
    oracle that folds index N/2 to -N/2 reads 1.25e-1 'error' from a
    correct transform (round-4 device hunt: identical across three
    geometries, absent in interpret).  Pin it against exact f64 sums and
    the c2c path."""
    import nonuniformffts_tpu as nufft

    N, Np = 32, 3000
    pts = rng.uniform(0, 2 * np.pi, (3, Np))
    v = rng.standard_normal(Np)
    p = nufft.set_points(nufft.PlanNUFFT(np.float64, (N,) * 3, m=6, sigma=2.0), pts)
    u = np.asarray(nufft.exec_type1(p, v))
    assert u.shape == (N, N, N // 2 + 1)
    for k0, k1 in [(3, 7), (N // 2, 2), (0, N - 1)]:
        kv0 = k0 - N if k0 >= (N + 1) // 2 else k0  # full axes: FFTW fold
        kv1 = k1 - N if k1 >= (N + 1) // 2 else k1
        exact_pos = np.sum(
            v * np.exp(-1j * (kv0 * pts[0] + kv1 * pts[1] + (N // 2) * pts[2]))
        )
        got = u[k0, k1, N // 2]
        assert abs(got - exact_pos) / abs(exact_pos) < 1e-5, (k0, k1)
    # And the c2c path agrees with the r2c slab everywhere below Nyquist.
    pc = nufft.set_points(
        nufft.PlanNUFFT(np.complex128, (N,) * 3, m=6, sigma=2.0), pts
    )
    uc = np.asarray(nufft.exec_type1(pc, v.astype(np.complex128)))
    rel = np.linalg.norm(u[:, :, : N // 2] - uc[:, :, : N // 2]) / np.linalg.norm(
        uc[:, :, : N // 2]
    )
    assert rel < 1e-5


def test_c2r_type2_rank1_oracle_convention(rng):
    """Pin the c2r type-2 convention bench.py's r2c err2 oracle relies on
    (measured mode-by-mode on the reference path):

        v(x) = Re(sum_{k2=0 plane} u e^{ikx}) + 2 Re(sum_{k2>0} u e^{ikx})

    i.e. every stored k2 > 0 plane — INCLUDING the stored +N/2 plane (the
    oversampled c2r axis Ntilde > N mirrors it at -N/2) — contributes
    doubled-realified; the k2 = 0 plane realifies once.  With Hermitian
    full-axis factors whose Nyquist bin is zero (the -N/2 mode has no +N/2
    partner on a c2c axis, so it is complex at non-uniform points), the
    rank-1 exact value is a product of three real factor sums."""
    N, Np = 16, 500
    H = N // 2 + 1
    pts = rng.uniform(0, 2 * np.pi, (3, Np))

    def herm_full(n):
        a = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / n
        a[0] = a[0].real
        a[n // 2] = 0.0
        a[n // 2 + 1 :] = np.conj(a[1 : n // 2][::-1])
        return a

    a0, a1 = herm_full(N), herm_full(N)
    a2h = (rng.standard_normal(H) + 1j * rng.standard_normal(H)) / N
    a2h[0] = a2h[0].real
    u = np.einsum("a,b,c->abc", a0, a1, a2h)
    p = nufft.set_points(
        nufft.PlanNUFFT(np.float64, (N,) * 3, m=6, sigma=2.0), pts
    )
    v = np.asarray(nufft.exec_type2(p, u))
    kfull = np.fft.fftfreq(N, 1.0 / N)
    exact = np.ones(Np)
    for d, a in ((0, a0), (1, a1)):
        exact = exact * (np.exp(1j * np.outer(pts[d], kfull)) @ a).real
    kh = np.arange(H, dtype=float)
    terms = np.exp(1j * np.outer(pts[2], kh)) * a2h
    s2 = terms[:, 0].real + 2.0 * np.sum(terms[:, 1:].real, axis=1)
    exact = exact * s2
    rel = np.linalg.norm(v - exact) / np.linalg.norm(exact)
    assert rel < 1e-5, rel
