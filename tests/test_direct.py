"""Direct-NUDFT path (ops/direct.py): exact dense sums for tiny point sets.

Correctness is pinned two ways: against exact f64 DFT oracles built from
first principles (c2c — the direct path should sit at the contraction
precision, ~1e-6 in f32 well below the windowed pipeline), and against the
library's reference path for the r2c/c2r conventions (halved-axis layout
and realification doubling), which the oracle-style check cannot pin
without re-implementing the same convention.
"""

import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nufft_test_utils import random_values


def _exact_type1(pts, v, kvecs):
    """u[k] = sum_j v_j e^{-i k.x_j} in f64, all modes."""
    D = len(kvecs)
    grids = np.meshgrid(*[np.asarray(k).astype(np.float64) for k in kvecs],
                        indexing="ij")
    x = pts.astype(np.float64)
    out = np.zeros(grids[0].shape, np.complex128)
    for j in range(x.shape[1]):
        ph = sum(grids[d] * x[d, j] for d in range(D))
        out += v[j] * np.exp(-1j * ph)
    return out


def _exact_type2(pts, u, kvecs):
    """v_j = sum_k u_k e^{+i k.x_j} in f64."""
    D = len(kvecs)
    grids = np.meshgrid(*[np.asarray(k).astype(np.float64) for k in kvecs],
                        indexing="ij")
    x = pts.astype(np.float64)
    out = np.zeros(x.shape[1], np.complex128)
    for j in range(x.shape[1]):
        ph = sum(grids[d] * x[d, j] for d in range(D))
        out[j] = np.sum(u.astype(np.complex128) * np.exp(1j * ph))
    return out


CASES = [
    ((64,), 1, False),
    ((32, 24), 1, False),
    ((16, 12, 20), 1, False),
    ((16, 12, 20), 2, False),
    ((16, 12, 20), 1, True),  # fftshift
]


@pytest.mark.parametrize("shape,C,fftshift", CASES, ids=lambda c: str(c))
def test_direct_c2c_vs_exact(shape, C, fftshift, rng):
    D = len(shape)
    Np = 60
    pts = rng.uniform(0, 2 * np.pi, (D, Np)).astype(np.float32)
    v = random_values(rng, np.complex64, (C, Np))
    plan = nufft.PlanNUFFT(
        np.complex64, shape, ntransforms=C, spread_method="direct",
        fftshift=fftshift,
    )
    plan = nufft.set_points(plan, pts)
    u = np.asarray(nufft.exec_type1(plan, v if C > 1 else v[0]))
    u = u if C > 1 else u[None]
    v2 = np.asarray(nufft.exec_type2(plan, (u if C > 1 else u[0]).astype(np.complex64)))
    v2 = v2 if C > 1 else v2[None]
    kv = [np.asarray(k) for k in plan.kvec]
    for c in range(C):
        u_exact = _exact_type1(pts, v[c].astype(np.complex128), kv)
        err1 = np.abs(u[c] - u_exact).max() / np.abs(u_exact).max()
        assert err1 < 2e-6, err1
        v_exact = _exact_type2(pts, u[c].astype(np.complex128), kv)
        err2 = np.abs(v2[c] - v_exact).max() / np.abs(v_exact).max()
        assert err2 < 2e-6, err2


def test_direct_phase_precision_large_k(rng):
    """N=256: k*x reaches ~800 rad; naive f32 phases would carry ~5e-5 rad
    of noise (rel err ~5e-5).  The split-product reduction must stay at the
    f32 trig floor (~1e-6 after the mode-sum)."""
    N, Np = 256, 40
    pts = rng.uniform(0, 2 * np.pi, (1, Np)).astype(np.float32)
    v = random_values(rng, np.complex64, (Np,))
    plan = nufft.PlanNUFFT(np.complex64, (N,), spread_method="direct")
    plan = nufft.set_points(plan, pts)
    u = np.asarray(nufft.exec_type1(plan, v))
    u_exact = _exact_type1(pts, v.astype(np.complex128), [np.asarray(plan.kvec[0])])
    err = np.abs(u - u_exact).max() / np.abs(u_exact).max()
    assert err < 2e-6, err


@pytest.mark.parametrize("shape", [(24,), (24, 18), (12, 10, 14)])
def test_direct_r2c_conventions_vs_reference(shape, rng):
    """r2c type-1 layout and c2r type-2 doubling must match the library's
    windowed reference path (the convention keeper)."""
    D = len(shape)
    Np = 80
    pts = rng.uniform(0, 2 * np.pi, (D, Np)).astype(np.float32)
    v = rng.standard_normal(Np).astype(np.float32)
    direct = nufft.PlanNUFFT(np.float32, shape, spread_method="direct")
    direct = nufft.set_points(direct, pts)
    ref = nufft.PlanNUFFT(np.float32, shape, m=8, sigma=2.0,
                          spread_method="reference")
    ref = nufft.set_points(ref, pts)
    u_d = np.asarray(nufft.exec_type1(direct, v))
    u_r = np.asarray(nufft.exec_type1(ref, v))
    assert u_d.shape == u_r.shape == direct.spectral_shape
    assert np.abs(u_d - u_r).max() / np.abs(u_r).max() < 2e-5
    uh = random_values(rng, np.complex64, direct.spectral_shape)
    v_d = np.asarray(nufft.exec_type2(direct, uh))
    v_r = np.asarray(nufft.exec_type2(ref, uh))
    assert v_d.dtype == np.float32
    assert np.abs(v_d - v_r).max() / np.abs(v_r).max() < 2e-5


def test_direct_callbacks(rng):
    shape = (16, 12)
    Np = 50
    pts = rng.uniform(0, 2 * np.pi, (2, Np)).astype(np.float32)
    v = random_values(rng, np.complex64, (Np,))
    cb = nufft.NUFFTCallbacks(nonuniform=lambda vs, n: tuple(2.0 * x for x in vs))
    plain = nufft.PlanNUFFT(np.complex64, shape, spread_method="direct")
    plain = nufft.set_points(plain, pts)
    u_cb = np.asarray(nufft.exec_type1(plain, v, cb))
    u_2x = 2.0 * np.asarray(nufft.exec_type1(plain, v))
    assert np.abs(u_cb - u_2x).max() / np.abs(u_2x).max() < 1e-6


def test_direct_rejects_sort_points():
    with pytest.raises(ValueError, match="sort_points"):
        nufft.PlanNUFFT(np.complex64, (16, 16), spread_method="direct",
                        sort_points=True)


def test_unknown_spread_method_rejected():
    with pytest.raises(ValueError, match="spread_method"):
        nufft.PlanNUFFT(np.complex64, (16, 16), spread_method="magic")
