"""Geometry calculator (C9) + observability (C22) tests.

The blocked kernel's block geometry (the counterpart of the reference's
shared-memory geometry arithmetic, src/gpu_common.jl:19-92), the plan's
method resolution, plus the per-stage Timer (reference: TimerOutputs on
the plan, src/plan.jl:282).
"""

import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nonuniformffts_tpu.ops.pallas.spread import (
    MIN_PADDED,
    choose_block_dims,
    padded_extent,
)
from nonuniformffts_tpu.utils.timer import Timer


@pytest.mark.parametrize("shape_over", [(384, 384, 384), (96, 96, 96),
                                        (512, 512), (36, 48, 60)])
def test_choose_block_dims_divides(shape_over):
    bd = choose_block_dims(shape_over, 4)
    assert all(n % b == 0 for n, b in zip(shape_over, bd))
    assert all(b >= 4 for b in bd)


def test_choose_block_dims_fills_smallest_padded_block():
    # m = 4: core + halo (B + 7) fits the 16-wide padded block at B = 8.
    assert choose_block_dims((384, 384, 384), 4) == (8, 8, 8)
    assert padded_extent(8, 4) == MIN_PADDED
    # m = 8 needs B + 15 rows: the padded extent doubles to 32.
    assert choose_block_dims((512,), 8) == (16,)
    assert padded_extent(16, 8) == 32


def test_plan_rejects_bad_block_dims():
    with pytest.raises(ValueError, match="must divide"):
        nufft.PlanNUFFT(
            np.complex64, (256, 256, 256), m=4, sigma=1.5,
            spread_method="blocked", block_dims=(16, 24, 100),
        )
    with pytest.raises(ValueError, match="half-support"):
        nufft.PlanNUFFT(
            np.complex64, (256, 256, 256), m=4, sigma=1.5,
            spread_method="blocked", block_dims=(2, 24, 128),
        )
    with pytest.raises(ValueError, match="one entry per dimension"):
        nufft.PlanNUFFT(
            np.complex64, (64, 64, 64), m=4, sigma=1.5,
            spread_method="blocked", block_dims=(16, 16),
        )
    p = nufft.PlanNUFFT(
        np.complex64, (64, 64, 64), m=4, sigma=1.5,
        spread_method="blocked", block_dims=(16, 16, 16), interpret=True,
    )
    assert p.block_dims == (16, 16, 16)


def test_timer_records_stages(rng):
    t = Timer(synchronise=True)
    plan = nufft.PlanNUFFT(np.complex128, (32, 32), m=4, sigma=2.0, timer=t)
    plan = nufft.set_points(plan, rng.uniform(0, 2 * np.pi, (2, 100)))
    v = rng.standard_normal(100) + 1j * rng.standard_normal(100)
    u = nufft.exec_type1(plan, v)
    nufft.exec_type2(plan, np.asarray(u))
    labels = set(t.times)
    assert "exec_type1/(1) spreading" in labels
    assert "exec_type1/(2) forward FFT" in labels
    assert "exec_type2/(3) interpolation" in labels
    assert "timer attached" in repr(plan)
    t.reset()
    assert not t.times


def test_timer_matches_untimed_results(rng):
    """The staged path must produce identical results to the fused path."""
    pts = rng.uniform(0, 2 * np.pi, (2, 200))
    v = rng.standard_normal(200) + 1j * rng.standard_normal(200)
    base = nufft.PlanNUFFT(np.complex128, (32, 24), m=4, sigma=2.0)
    timed = nufft.PlanNUFFT(
        np.complex128, (32, 24), m=4, sigma=2.0, timer=Timer()
    )
    u0 = np.asarray(nufft.exec_type1(nufft.set_points(base, pts), v))
    u1 = np.asarray(nufft.exec_type1(nufft.set_points(timed, pts), v))
    np.testing.assert_allclose(u0, u1, rtol=1e-13)


def test_plan_repr_geometry(rng):
    plan = nufft.PlanNUFFT(
        np.complex64, (64, 64, 64), m=4, sigma=1.5, spread_method="blocked",
        interpret=True, block_dims=(16, 16, 16),
    )
    r = repr(plan)
    assert "blocked geometry: 216 blocks" in r
    pts = rng.uniform(0, 2 * np.pi, (3, 5_000)).astype(np.float32)
    plan = nufft.set_points(plan, pts)
    assert "points set: 5000" in repr(plan)


def test_sort_points_reference_path(rng):
    """sort_points=True (cell-major physical sort, reference path) must be
    output-equivalent to the unsorted path, type 1 and type 2."""
    pts = rng.uniform(0, 2 * np.pi, (2, 300))
    v = rng.standard_normal(300) + 1j * rng.standard_normal(300)
    kw = dict(m=4, sigma=2.0, spread_method="reference")
    p0 = nufft.set_points(nufft.PlanNUFFT(np.complex128, (32, 32), **kw), pts)
    p1 = nufft.set_points(
        nufft.PlanNUFFT(np.complex128, (32, 32), sort_points=True, **kw), pts
    )
    u0 = np.asarray(nufft.exec_type1(p0, v))
    u1 = np.asarray(nufft.exec_type1(p1, v))
    np.testing.assert_allclose(u1, u0, rtol=1e-12)
    v0 = np.asarray(nufft.exec_type2(p0, u0))
    v1 = np.asarray(nufft.exec_type2(p1, u0))
    np.testing.assert_allclose(v1, v0, rtol=1e-12)
    assert p1.point_perm is not None and p0.point_perm is None


def test_auto_method_resolves(rng):
    # On the CPU test backend 'auto' resolves to the reference path, at
    # plan time with np_hint and at set_points otherwise.
    plan = nufft.PlanNUFFT(np.complex64, (32, 32))
    assert plan.spread_method == "auto"
    pts = rng.uniform(0, 2 * np.pi, (2, 5_000)).astype(np.float32)
    assert nufft.set_points(plan, pts).spread_method == "reference"
    hinted = nufft.PlanNUFFT(np.complex64, (32, 32), np_hint=5_000)
    assert hinted.spread_method == "reference"


def test_exec_no_recompilation_across_calls(rng):
    """Analogue of the reference's JET type-stability checks
    (test/accuracy.jl:133-141): repeated execution with fresh data and a
    fresh same-config plan must hit the jit cache (static plan metadata is
    hashable and stable; no retraces)."""
    from nonuniformffts_tpu.execution import _exec_type1_ch_impl

    def run():
        plan = nufft.PlanNUFFT(np.complex128, (32, 32), m=4, sigma=2.0)
        plan = nufft.set_points(plan, rng.uniform(0, 2 * np.pi, (2, 128)))
        v = rng.standard_normal(128) + 1j * rng.standard_normal(128)
        nufft.exec_type1(plan, v)

    run()
    size0 = _exec_type1_ch_impl._cache_size()
    run()
    run()
    assert _exec_type1_ch_impl._cache_size() == size0
