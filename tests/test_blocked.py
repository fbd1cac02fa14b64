"""Blocked path (bin sort + Pallas spread kernel) vs the reference path.

The analogue of the reference's test/pseudo_gpu.jl: the accelerated code path
is run on an emulated backend (Pallas ``interpret=True`` on CPU — the role
POCL/OpenCL plays for the reference) and compared against the plain path on
identical seeded inputs (reference oracle strategy, pseudo_gpu.jl:109-174).
The kernel computes in float32, so blocked plans are 32-bit and the
tolerances are float32's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nonuniformffts_tpu.ops.pallas import spread as S
from nonuniformffts_tpu.ops.pallas.common import overlap_add
from nufft_test_utils import random_values

CASES = [
    ((64,), np.complex64, 1),
    ((32, 24), np.complex64, 1),
    ((16, 12, 20), np.complex64, 2),
    ((24, 18), np.float32, 1),
    ((12, 10, 14), np.float32, 1),
    ((32, 24), np.complex64, 3),
]
TOL = 1e-5


def _make_inputs(shape, dtype, C, Np, rng):
    D = len(shape)
    real_dtype = np.dtype(dtype).type(0).real.dtype
    pts = rng.uniform(0, 2 * np.pi, (D, Np)).astype(real_dtype)
    v = random_values(rng, dtype, (C, Np))
    return pts, (v[0] if C == 1 else v)


def _roundtrip(plan, pts, v, callbacks=None):
    plan = nufft.set_points(plan, pts)
    u = np.asarray(nufft.exec_type1(plan, v, callbacks=callbacks))
    v2 = np.asarray(nufft.exec_type2(plan, u.astype(plan.complex_dtype),
                                     callbacks=callbacks))
    return u, v2


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _blocked(dtype, shape, **kw):
    return nufft.PlanNUFFT(dtype, shape, spread_method="blocked",
                           interpret=True, **kw)


@pytest.mark.parametrize("shape,dtype,C", CASES, ids=lambda c: str(c))
def test_blocked_matches_reference(shape, dtype, C, rng):
    pts, v = _make_inputs(shape, dtype, C, 500, rng)
    ref = nufft.PlanNUFFT(dtype, shape, ntransforms=C, sigma=2.0,
                          spread_method="reference")
    blk = _blocked(dtype, shape, ntransforms=C, sigma=2.0)
    u_ref, v2_ref = _roundtrip(ref, pts, v)
    u_blk, v2_blk = _roundtrip(blk, pts, v)
    assert _rel(u_blk, u_ref) < TOL
    assert _rel(v2_blk, v2_ref) < TOL


@pytest.mark.parametrize("fftshift", [False, True])
@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_blocked_fftshift_and_r2c(dtype, fftshift, rng):
    """fftshift ordering and the r2c half-spectrum layout are independent
    of the spreading method."""
    shape = (18, 16)
    pts, v = _make_inputs(shape, dtype, 1, 300, rng)
    ref = nufft.PlanNUFFT(dtype, shape, sigma=2.0, fftshift=fftshift,
                          spread_method="reference")
    blk = _blocked(dtype, shape, sigma=2.0, fftshift=fftshift)
    u_ref, v2_ref = _roundtrip(ref, pts, v)
    u_blk, v2_blk = _roundtrip(blk, pts, v)
    assert _rel(u_blk, u_ref) < TOL
    assert _rel(v2_blk, v2_ref) < TOL


def test_blocked_point_distribution_edge_cases(rng):
    """Empty blocks, all points clustered in one block, single point, points
    exactly at block boundaries and near 2pi."""
    shape = (32, 24)
    plan0 = _blocked(np.complex64, shape, sigma=2.0)
    ref0 = nufft.PlanNUFFT(np.complex64, shape, sigma=2.0,
                           spread_method="reference")
    cases = {
        "clustered": rng.uniform(0.0, 0.05, (2, 300)),
        "single": np.array([[1.234], [2.345]]),
        "boundaries": np.stack(
            [
                np.linspace(0, 2 * np.pi, 64, endpoint=False),
                np.full(64, np.nextafter(np.float32(2 * np.pi), 0)),
            ]
        ),
    }
    for name, pts in cases.items():
        pts = pts.astype(np.float32)
        v = random_values(rng, np.complex64, pts.shape[1])
        u_ref, v2_ref = _roundtrip(ref0, pts, v)
        u_blk, v2_blk = _roundtrip(plan0, pts, v)
        assert _rel(u_blk, u_ref) < TOL, name
        assert _rel(v2_blk, v2_ref) < TOL, name


@pytest.mark.parametrize("bdims", [(12, 12), (8, 60), (48, 10)])
def test_blocked_custom_block_dims(bdims, rng):
    shape = (24, 30)
    pts, v = _make_inputs(shape, np.complex64, 1, 700, rng)
    ref = nufft.PlanNUFFT(np.complex64, shape, sigma=2.0,
                          spread_method="reference")
    u_ref, v2_ref = _roundtrip(ref, pts, v)
    blk = _blocked(np.complex64, shape, sigma=2.0, block_dims=bdims)
    assert blk.block_dims == bdims
    u_blk, v2_blk = _roundtrip(blk, pts, v)
    assert _rel(u_blk, u_ref) < TOL
    assert _rel(v2_blk, v2_ref) < TOL


def test_blocked_callbacks_and_fftshift(rng):
    shape = (16, 20)
    pts, v = _make_inputs(shape, np.complex64, 1, 200, rng)
    w = jnp.asarray(rng.uniform(0.5, 1.5, 200).astype(np.float32))
    cb = nufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple(x * w[n] for x in vs),
        uniform=lambda ws, idx: tuple(x * 2.0 for x in ws),
    )
    for fftshift in (False, True):
        ref = nufft.PlanNUFFT(np.complex64, shape, sigma=2.0,
                              fftshift=fftshift, spread_method="reference")
        blk = _blocked(np.complex64, shape, sigma=2.0, fftshift=fftshift)
        u_ref, v_ref = _roundtrip(ref, pts, v, callbacks=cb)
        u_blk, v_blk = _roundtrip(blk, pts, v, callbacks=cb)
        assert _rel(u_blk, u_ref) < TOL
        assert _rel(v_blk, v_ref) < TOL


KERNELS = [
    nufft.KaiserBesselKernel(),
    nufft.BackwardsKaiserBesselKernel(),
    nufft.GaussianKernel(),
    nufft.BSplineKernel(),
]


@pytest.mark.parametrize("mode", [nufft.Direct(), nufft.FastApproximation()],
                         ids=["Direct", "FastApprox"])
@pytest.mark.parametrize("kernel", KERNELS,
                         ids=["KB", "BKB", "Gaussian", "BSpline"])
def test_all_kernels_blocked(kernel, mode, rng):
    """Window values are evaluated outside the kernel, so every kernel
    family and evaluation mode runs through the same kernel."""
    shape = (28, 22)
    pts, v = _make_inputs(shape, np.complex64, 1, 300, rng)
    kw = dict(sigma=2.0, kernel=kernel, kernel_evalmode=mode)
    ref = nufft.PlanNUFFT(np.complex64, shape, spread_method="reference", **kw)
    blk = _blocked(np.complex64, shape, **kw)
    u_ref, _ = _roundtrip(ref, pts, v)
    u_blk, _ = _roundtrip(blk, pts, v)
    assert _rel(u_blk, u_ref) < TOL


def test_blocked_ntransforms_32(rng):
    """C=32 simultaneous transforms: the kernel grid gains one program per
    pair of real channels (CR=64)."""
    C, Np = 32, 200
    pts = rng.uniform(0, 2 * np.pi, (1, Np)).astype(np.float32)
    v = random_values(rng, np.complex64, (C, Np))
    kw = dict(m=4, sigma=2.0, ntransforms=C)
    pb = _blocked(np.complex64, (64,), **kw)
    pr = nufft.PlanNUFFT(np.complex64, (64,), spread_method="reference", **kw)
    ub, vb = _roundtrip(pb, pts, v)
    ur, vr = _roundtrip(pr, pts, v)
    assert _rel(ub, ur) < TOL
    assert _rel(vb, vr) < TOL


@pytest.mark.parametrize("C", [1, 3])
def test_blocked_odd_channel_count(C, rng):
    """Real plans with an odd number of channels run one channel per
    program; even counts pair them."""
    shape = (16, 16, 24)
    pts, v = _make_inputs(shape, np.float32, C, 800, rng)
    kw = dict(m=4, sigma=1.5, ntransforms=C)
    u_b, v_b = _roundtrip(_blocked(np.float32, shape, **kw), pts, v)
    u_r, v_r = _roundtrip(
        nufft.PlanNUFFT(np.float32, shape, spread_method="reference", **kw),
        pts, v,
    )
    assert _rel(u_b, u_r) < TOL
    assert _rel(v_b, v_r) < TOL


@pytest.mark.parametrize("n,m", [(384, 4), (512, 8), (48, 2), (24, 4)])
def test_block_geometry(n, m):
    """Block cores divide the grid, reach no further than one neighbour,
    and fit core + halo into a power-of-two padded extent >= 16."""
    (b,) = S.choose_block_dims((n,), m)
    pd = S.padded_extent(b, m)
    assert n % b == 0 and b >= m
    assert b + 2 * m - 1 <= pd and pd >= S.MIN_PADDED
    assert pd & (pd - 1) == 0


def _periodic_dense_spread(shape, m, cells, wts, vals):
    """Numpy oracle: add each point's tensor window onto the periodic grid."""
    D = len(shape)
    grid = np.zeros((vals.shape[0],) + tuple(shape))
    for p in range(cells.shape[1]):
        idx = [
            (cells[d, p] - (m - 1) + np.arange(2 * m)) % shape[d]
            for d in range(D)
        ]
        w = wts[0][:, p]
        for d in range(1, D):
            w = np.multiply.outer(w, wts[d][:, p])
        for c in range(vals.shape[0]):
            np.add.at(grid[c], np.ix_(*idx), w * vals[c, p])
    return grid


@pytest.mark.parametrize("shape", [(40,), (24, 32), (16, 24, 16)])
def test_kernel_and_overlap_add_match_dense_oracle(shape, rng):
    """The kernel's padded blocks, merged by overlap_add, equal a dense
    periodic accumulation of every point's window (random weights, so any
    misplaced tap shows)."""
    m, D, Np, CR = 3, len(shape), 150, 2
    bd = S.choose_block_dims(shape, m)
    nb = [n // b for n, b in zip(shape, bd)]
    cells = np.stack([rng.integers(0, n, Np) for n in shape]).astype(np.int32)
    wts = rng.standard_normal((D, 2 * m, Np)).astype(np.float32)
    vals = rng.standard_normal((CR, Np)).astype(np.float32)
    bid = np.zeros(Np, np.int64)
    for d in range(D):
        bid = bid * nb[d] + cells[d] // bd[d]
    order = np.argsort(bid, kind="stable")
    pstarts = np.searchsorted(bid[order], np.arange(np.prod(nb) + 1))
    pad = S.BATCH_SIZE
    local = np.stack([cells[d][order] % bd[d] for d in range(D)])
    buf = S.spread_padded_blocks(
        jnp.asarray(pstarts, jnp.int32),
        jnp.asarray(np.pad(local, ((0, 0), (0, pad)))),
        jnp.asarray(np.pad(wts[:, :, order], ((0, 0), (0, 0), (0, pad)))),
        jnp.asarray(np.pad(vals[:, order], ((0, 0), (0, pad)))),
        m=m, block_dims=bd, interpret=True,
    )
    padded = tuple(S.padded_extent(b, m) for b in bd)
    grid = overlap_add(buf.reshape((CR,) + tuple(nb) + padded), bd, m)
    want = _periodic_dense_spread(shape, m, cells, wts, vals)
    np.testing.assert_allclose(np.asarray(grid), want, rtol=1e-5, atol=1e-5)


def test_blocked_sorted_state(rng):
    """set_points bin-sorts: block ranges tile the sorted points, every
    sorted point lies in its range's block, and sort_perm is a
    permutation."""
    shape = (24, 20, 16)
    pts, _ = _make_inputs(shape, np.complex64, 1, 900, rng)
    plan = nufft.set_points(_blocked(np.complex64, shape, sigma=2.0), pts)
    pst = np.asarray(plan.pstarts)
    cells = np.asarray(plan.cells)
    assert pst[0] == 0 and pst[-1] == 900 and np.all(np.diff(pst) >= 0)
    nb = plan.num_blocks
    bid = np.zeros(900, np.int64)
    for d in range(3):
        bid = bid * nb[d] + cells[d] // plan.block_dims[d]
    owner = np.searchsorted(pst, np.arange(900), side="right") - 1
    np.testing.assert_array_equal(bid, owner)
    np.testing.assert_array_equal(np.sort(np.asarray(plan.sort_perm)),
                                  np.arange(900))


def test_blocked_rejects_64bit():
    with pytest.raises(ValueError, match="float32"):
        nufft.PlanNUFFT(np.complex128, (16, 16), spread_method="blocked",
                        interpret=True)


def test_blocked_jit_cache_reuse(rng):
    """A fresh plan with the same configuration and point count hits the
    compiled spread (static metadata is hashable and stable)."""
    from nonuniformffts_tpu.execution import _exec_type1_ch_impl

    shape = (16, 16)

    def run():
        pts, v = _make_inputs(shape, np.complex64, 1, 128, rng)
        plan = nufft.set_points(_blocked(np.complex64, shape), pts)
        jax.block_until_ready(nufft.exec_type1(plan, v))

    run()
    size0 = _exec_type1_ch_impl._cache_size()
    run()
    assert _exec_type1_ch_impl._cache_size() == size0
