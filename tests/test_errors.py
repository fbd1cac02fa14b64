"""Error paths (port of test/errors.jl plus inline arg checks)."""

import numpy as np
import pytest

import nonuniformffts_tpu as nufft


def test_grid_too_small_raises():
    # sigma*N < 2M must throw (reference: check_nufft_size, plan.jl:545-556).
    with pytest.raises(ValueError, match="too small"):
        nufft.PlanNUFFT(np.complex128, (4,), m=8, sigma=1.0)


def test_bad_dtype():
    with pytest.raises(TypeError):
        nufft.PlanNUFFT(np.int32, (16,))


def test_points_not_set():
    plan = nufft.PlanNUFFT(np.complex128, (16,))
    with pytest.raises(ValueError, match="points not set"):
        nufft.exec_type1(plan, np.zeros(4, np.complex128))


def test_wrong_point_count(rng):
    plan = nufft.PlanNUFFT(np.complex128, (16,))
    plan = nufft.set_points(plan, rng.uniform(0, 1, 10))
    with pytest.raises(ValueError, match="number of values"):
        nufft.exec_type1(plan, np.zeros(5, np.complex128))


def test_wrong_value_dtype(rng):
    plan = nufft.PlanNUFFT(np.complex128, (16,))
    plan = nufft.set_points(plan, rng.uniform(0, 1, 10))
    with pytest.raises(TypeError, match="dtype"):
        nufft.exec_type1(plan, np.zeros(10, np.complex64))


def test_wrong_uniform_shape(rng):
    plan = nufft.PlanNUFFT(np.complex128, (16, 16))
    plan = nufft.set_points(plan, rng.uniform(0, 1, (2, 10)))
    with pytest.raises(ValueError, match="shape"):
        nufft.exec_type2(plan, np.zeros((16, 8), np.complex128))


def test_wrong_ntransforms(rng):
    plan = nufft.PlanNUFFT(np.complex128, (16,), ntransforms=2)
    plan = nufft.set_points(plan, rng.uniform(0, 1, 10))
    with pytest.raises(ValueError, match="ntransforms"):
        nufft.exec_type1(plan, np.zeros(10, np.complex128))
    with pytest.raises(ValueError, match="ntransforms"):
        nufft.exec_type1(plan, np.zeros((3, 10), np.complex128))


def test_mismatched_coordinate_lengths():
    plan = nufft.PlanNUFFT(np.complex128, (16, 16))
    with pytest.raises(ValueError, match="equal lengths"):
        nufft.set_points(plan, (np.zeros(5), np.zeros(6)))


def test_wrong_dimension_count():
    plan = nufft.PlanNUFFT(np.complex128, (16, 16))
    with pytest.raises(ValueError):
        nufft.set_points(plan, (np.zeros(5),))
    with pytest.raises(ValueError):
        nufft.PlanNUFFT(np.complex128, (8, 8, 8, 8))


def test_removed_options_rejected():
    """Options that selected kernel variants of earlier platforms are gone;
    passing one is an error, not a silent no-op."""
    for kw in ({"fft_method": "matmul"}, {"precision": "double"},
               {"layout": "slots"}, {"batch_size": 128}):
        with pytest.raises(TypeError):
            nufft.PlanNUFFT(np.complex64, (16, 16), **kw)


def test_interpret_refused_on_gpu_backend(monkeypatch):
    """interpret=True is a test hook for hosts without a GPU; on a GPU the
    kernel must run compiled."""
    from nonuniformffts_tpu import backend

    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    with pytest.raises(ValueError, match="interpret"):
        nufft.PlanNUFFT(np.complex64, (16, 16), spread_method="blocked",
                        interpret=True)
