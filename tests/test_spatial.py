"""Grid-sharded multi-device path vs the single-device library.

Runs on the 8-virtual-device CPU mesh (conftest): numerical equality with
single-device execution at a grid that is *sharded* end to end — grid slabs
per device, point routing via all_to_all, ppermute halo exchange, a
distributed FFT with an all_to_all transpose.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import nonuniformffts_tpu as nufft
from nonuniformffts_tpu.execution import (
    exec_type1_channels,
    exec_type2_channels,
)
from nonuniformffts_tpu.parallel import SpatialNUFFT


def make_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("grid",))


def _single(dtype, shape, pts, **kw):
    return nufft.set_points(
        nufft.PlanNUFFT(dtype, shape, spread_method="reference", **kw), pts
    )


def _values(rng, dtype, C, Np):
    if np.dtype(dtype).kind == "c":
        return rng.standard_normal((C, 2, Np))
    return rng.standard_normal((C, Np))


def _check(sp, dtype, shape, pts, v_ch, **kw):
    st = sp.set_points(pts)
    u_sp = np.asarray(sp.exec_type1(st, v_ch))
    ref = _single(dtype, shape, pts, **kw)
    u_ref = np.asarray(exec_type1_channels(ref, v_ch))
    np.testing.assert_allclose(u_sp, u_ref, rtol=1e-10, atol=1e-10)
    v_sp = np.asarray(sp.exec_type2(st, u_ref))
    v_ref = np.asarray(exec_type2_channels(ref, u_ref))
    np.testing.assert_allclose(v_sp, v_ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n_chips", [2, 4])
@pytest.mark.parametrize("m", [4, 2])
def test_type1_type2_match_single_device_complex(n_chips, m, rng):
    shape = (32, 32, 32)
    Np = 160 * n_chips
    kw = dict(m=m, sigma=1.5)
    sp = SpatialNUFFT(np.complex128, shape, mesh=make_mesh(n_chips), **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, Np))
    _check(sp, np.complex128, shape, pts, _values(rng, np.complex128, 1, Np), **kw)


@pytest.mark.parametrize("n_chips", [2, 4])
def test_real_data_path(n_chips, rng):
    shape = (32, 32, 32)
    Np = 150 * n_chips
    kw = dict(m=4, sigma=1.5)
    sp = SpatialNUFFT(np.float64, shape, mesh=make_mesh(n_chips), **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, Np))
    _check(sp, np.float64, shape, pts, _values(rng, np.float64, 1, Np), **kw)


def test_2d(rng):
    shape = (32, 32)
    Np = 400
    kw = dict(m=4, sigma=2.0)
    sp = SpatialNUFFT(np.complex128, shape, mesh=make_mesh(4), **kw)
    pts = rng.uniform(0, 2 * np.pi, (2, Np))
    _check(sp, np.complex128, shape, pts, _values(rng, np.complex128, 1, Np), **kw)


def test_single_device_mesh(rng):
    """One device: the halo exchange wraps onto the same slab."""
    shape = (16, 24, 20)
    kw = dict(m=4, sigma=2.0)
    sp = SpatialNUFFT(np.complex128, shape, mesh=make_mesh(1), **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, 300))
    _check(sp, np.complex128, shape, pts, _values(rng, np.complex128, 1, 300), **kw)


def test_skewed_points_still_exact(rng):
    """All points piled into one device's slab (max routing skew) must
    still be exact as long as the capacity allows it."""
    shape = (32, 32, 32)
    Np = 64 * 4
    kw = dict(m=4, sigma=1.5)
    sp = SpatialNUFFT(np.complex128, shape, mesh=make_mesh(4),
                      capacity_factor=4.0, **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, Np))
    pts[0] = rng.uniform(0, 0.3, Np)  # everything in device 0's slab
    _check(sp, np.complex128, shape, pts, _values(rng, np.complex128, 1, Np), **kw)


def test_points_outside_domain_and_transform(rng):
    """Unfolded coordinates and a point transform route by the folded,
    transformed cell, like the single-device plan."""
    shape = (24, 16, 16)
    kw = dict(m=3, sigma=2.0, point_transform=lambda x: -x)
    sp = SpatialNUFFT(np.complex128, shape, mesh=make_mesh(2), **kw)
    pts = rng.uniform(-2 * np.pi, 4 * np.pi, (3, 200))
    _check(sp, np.complex128, shape, pts, _values(rng, np.complex128, 1, 200), **kw)


def test_routing_overflow_raises(rng):
    sp = SpatialNUFFT(np.complex128, (32, 32, 32), mesh=make_mesh(4), m=4,
                      sigma=1.5, capacity_factor=0.5)
    pts = rng.uniform(0, 2 * np.pi, (3, 256))
    pts[0] = 0.1  # everyone routes to device 0 -> guaranteed overflow
    with pytest.raises(ValueError, match="overflow"):
        sp.set_points(pts)


def test_validation_errors():
    mesh = make_mesh(4)
    with pytest.raises(ValueError, match="1-D mesh"):
        SpatialNUFFT(
            np.complex128, (32, 32),
            mesh=Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("a", "b")),
        )
    with pytest.raises(ValueError, match=">= 2 dimensions"):
        SpatialNUFFT(np.complex128, (64,), mesh=mesh)
    with pytest.raises(ValueError, match="slabs"):
        SpatialNUFFT(np.complex128, (8, 32), mesh=make_mesh(8), m=4, sigma=2.0)
    with pytest.raises(ValueError, match="spectrum layout"):
        SpatialNUFFT(np.complex128, (32, 32), mesh=mesh, spectrum="bogus")
    sp = SpatialNUFFT(np.complex128, (32, 32), mesh=mesh)
    with pytest.raises(ValueError, match="divide by mesh size"):
        sp.set_points(np.zeros((2, 101)))


def test_ntransforms(rng):
    """C=2 simultaneous transforms through the distributed path."""
    shape = (32, 32, 32)
    Np = 300 * 2
    kw = dict(m=4, sigma=1.5, ntransforms=2)
    sp = SpatialNUFFT(np.complex128, shape, mesh=make_mesh(2), **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, Np))
    _check(sp, np.complex128, shape, pts, _values(rng, np.complex128, 2, Np), **kw)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_spectrum_sharded_matches_replicated(dtype, rng):
    """spectrum='sharded' (per-device O(N^D/n) spectrum memory) must give
    the replicated layout's numbers, split along spectral dim 1."""
    shape = (32, 32, 32) if dtype == np.complex128 else (32, 24, 30)
    n = 2
    Np = 200 * n
    kw = dict(mesh=make_mesh(n), m=4, sigma=1.5)
    sp_r = SpatialNUFFT(dtype, shape, **kw)
    sp_s = SpatialNUFFT(dtype, shape, spectrum="sharded", **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, Np))
    v_ch = _values(rng, dtype, 1, Np)
    st_r, st_s = sp_r.set_points(pts), sp_s.set_points(pts)
    u_r = np.asarray(sp_r.exec_type1(st_r, v_ch))
    u_s = sp_s.exec_type1(st_s, v_ch)
    assert u_s.sharding.shard_shape(u_s.shape)[3] == u_r.shape[3] // n
    np.testing.assert_allclose(np.asarray(u_s), u_r, rtol=1e-12, atol=1e-12)
    v_r = np.asarray(sp_r.exec_type2(st_r, u_r))
    v_s = np.asarray(sp_s.exec_type2(st_s, u_s))
    np.testing.assert_allclose(v_s, v_r, rtol=1e-12, atol=1e-12)


def test_collective_bytes():
    kw = dict(mesh=make_mesh(4), m=4, sigma=1.5)
    b_r = SpatialNUFFT(np.complex64, (64, 64, 64), **kw).collective_bytes()
    b_s = SpatialNUFFT(np.complex64, (64, 64, 64), spectrum="sharded",
                       **kw).collective_bytes()
    assert b_r["halo_ppermute"] == 7 * 96 * 96 * 8
    assert b_s["spectrum_all_gather"] == 0 < b_r["spectrum_all_gather"]
    assert b_s["transpose_all_to_all"] == b_r["transpose_all_to_all"] > 0


def test_spectrum_sharded_indivisible_raises():
    with pytest.raises(ValueError, match="divide by the mesh size"):
        SpatialNUFFT(np.complex128, (30, 30, 30), mesh=make_mesh(4), m=4,
                     sigma=2.0, spectrum="sharded")


def test_chunked_stencils(rng):
    """Per-device stencil chunking (a lax.scan inside shard_map) matches the
    single-device plan with the same chunking."""
    shape = (32, 24, 20)
    kw = dict(m=4, sigma=1.5, chunk_size=32)
    sp = SpatialNUFFT(np.complex128, shape, mesh=make_mesh(4), **kw)
    pts = rng.uniform(0, 2 * np.pi, (3, 400))
    _check(sp, np.complex128, shape, pts, _values(rng, np.complex128, 1, 400), **kw)
