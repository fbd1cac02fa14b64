"""complex128 and float64 plans in native float64 against exact DFT sums.

64-bit plans run the same jnp pipeline as 32-bit ones, in float64 end to
end (x64 on).  The cases are those of the earlier extended-precision
pipeline: 3-D and 2-D grids, several simultaneous transforms, m = 6 and
m = 8.  Type 1 is checked on a random subset of modes, type 2 on a random
subset of points; the tolerance is the kernel's error model (BASELINE.md:
~6 x 10^(-1.9 m) at sigma = 2, floored near 1e-13 by float64 sums) with a
5x margin.
"""

import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nufft_test_utils import direct_type2, random_values

CASES = [
    ("3d_m8", np.complex128, (32, 32, 32), 8, 1, 3000),
    ("2d_m6", np.complex128, (48, 32), 6, 1, 2000),
    ("3d_ntransforms", np.complex128, (24, 24, 24), 6, 3, 1500),
    ("real_3d_m8", np.float64, (32, 32, 32), 8, 1, 3000),
    ("real_2d_ntransforms", np.float64, (48, 32), 6, 2, 2000),
]


def _tol(m):
    return 5 * max(6 * 10.0 ** (-1.9 * m), 1e-13)


@pytest.mark.parametrize("name,dtype,shape,m,C,Np", CASES, ids=[c[0] for c in CASES])
def test_native_f64_vs_exact(name, dtype, shape, m, C, Np, rng):
    D = len(shape)
    pts = rng.uniform(0, 2 * np.pi, (D, Np))
    v = random_values(rng, dtype, (C, Np))
    plan = nufft.set_points(
        nufft.PlanNUFFT(dtype, shape, m=m, sigma=2.0, ntransforms=C), pts
    )
    assert plan.real_dtype == np.float64
    u = np.asarray(nufft.exec_type1(plan, v if C > 1 else v[0]))
    u = u if C > 1 else u[None]
    assert u.dtype == np.complex128

    kv = [np.asarray(k, np.float64) for k in plan.kvec]
    spec = plan.spectral_shape
    idx = [rng.integers(0, s, 300) for s in spec]
    ph = sum(np.outer(kv[d][idx[d]], pts[d]) for d in range(D))  # (300, Np)
    for c in range(C):
        exact = np.exp(-1j * ph) @ v[c]
        got = u[c][tuple(idx)]
        assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < _tol(m)

    uin = random_values(rng, np.complex128, (C,) + spec)
    v2 = np.asarray(nufft.exec_type2(plan, uin if C > 1 else uin[0]))
    v2 = v2 if C > 1 else v2[None]
    sel = rng.choice(Np, 200, replace=False)
    for c in range(C):
        u_c = uin[c]
        if plan.is_real:  # c2r: stored k > 0 planes of the halved axis count twice
            u_c = u_c * np.where(kv[-1] > 0, 2.0, 1.0)
        exact = direct_type2(pts[:, sel], u_c, kv)
        exact = exact.real if plan.is_real else exact
        got = v2[c][sel]
        assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < _tol(m)
