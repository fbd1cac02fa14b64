"""Points-chunked execution (chunked.py) vs the unchunked blocked path.

The chunked mode bounds the per-point temporaries of very large point sets
(the rho=10 benchmark scale, 167.8M points, reference protocol
benchmark/CPU+CUDA/run_benchmarks.jl:394-404).  Correctness is scale-free:
these tests pin output equality against the unchunked plan on small problems
(interpret-mode Pallas on CPU), including the zero-padding path when Np is
not a multiple of nchunks.
"""

import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nufft_test_utils import random_values

CASES = [
    ((16, 12, 20), np.complex64, 1, 2, 800),    # divisible
    ((16, 12, 20), np.complex64, 2, 3, 1000),   # pad (1000 -> 3*334)
    ((12, 10, 14), np.float32, 1, 3, 500),      # r2c + pad
    ((32, 24), np.complex64, 1, 4, 600),        # 2D
]


def _plan_kwargs(shape):
    return dict(
        sigma=1.5, m=4, spread_method="blocked", interpret=True,
    )


@pytest.mark.parametrize("shape,dtype,C,K,Np", CASES, ids=lambda c: str(c))
def test_chunked_matches_unchunked(shape, dtype, C, K, Np, rng):
    D = len(shape)
    pts = rng.uniform(0, 2 * np.pi, (D, Np)).astype(np.float32)
    v = random_values(rng, dtype, (C, Np))
    kw = _plan_kwargs(shape)

    ref = nufft.PlanNUFFT(dtype, shape, ntransforms=C, np_hint=Np, **kw)
    ref = nufft.set_points(ref, pts)
    u_ref = np.asarray(nufft.exec_type1(ref, v if C > 1 else v[0]))
    v2_ref = np.asarray(
        nufft.exec_type2(ref, u_ref.astype(ref.complex_dtype))
    )

    cpl = nufft.ChunkedPlanNUFFT(
        dtype, shape, nchunks=K, ntransforms=C, np_hint=Np, **kw
    )
    cpl = nufft.set_points_chunked(cpl, pts)
    u_chk = np.asarray(nufft.exec_type1_chunked(cpl, v if C > 1 else v[0]))
    v2_chk = np.asarray(
        nufft.exec_type2_chunked(cpl, u_chk.astype(ref.complex_dtype))
    )

    assert u_chk.shape == u_ref.shape
    assert v2_chk.shape == v2_ref.shape
    assert np.abs(u_chk - u_ref).max() / np.abs(u_ref).max() < 1e-5
    assert np.abs(v2_chk - v2_ref).max() / np.abs(v2_ref).max() < 1e-5


def test_chunked_set_points_is_jittable(rng):
    """The bench times set_points_chunked under jit; pin traceability."""
    import jax

    shape = (16, 12, 20)
    Np, K = 900, 3
    pts = rng.uniform(0, 2 * np.pi, (3, Np)).astype(np.float32)
    cpl = nufft.ChunkedPlanNUFFT(
        np.complex64, shape, nchunks=K, np_hint=Np, **_plan_kwargs(shape)
    )

    @jax.jit
    def set_and_reduce(p):
        c = nufft.set_points_chunked(cpl, p)
        return jnp_sum_all(c)

    import jax.numpy as jnp

    def jnp_sum_all(c):
        # NaN is a legitimate padding sentinel in the folded point rows;
        # reduce over finite entries only.
        acc = jnp.float32(0)
        for leaf in jax.tree_util.tree_leaves(c.plans):
            acc = acc + jnp.sum(jnp.nan_to_num(leaf.astype(jnp.float32)))
        return acc

    val = float(set_and_reduce(pts))
    assert np.isfinite(val)


def test_chunked_requires_set_points():
    cpl = nufft.ChunkedPlanNUFFT(
        np.complex64, (16, 12, 20), nchunks=2, **_plan_kwargs((16, 12, 20))
    )
    with pytest.raises(RuntimeError, match="points not set"):
        nufft.exec_type1_chunked(cpl, np.zeros(8, np.complex64))
