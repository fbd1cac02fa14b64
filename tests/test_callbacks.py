"""Fused user callbacks.

Port of the reference's test/callbacks.jl: the fused callbacks must produce
exactly the result of manually applying the same operations before/after a
plain transform.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nufft_test_utils import random_values


@pytest.fixture
def setup(rng):
    shape = (32, 28)
    Np = 150
    pts = rng.uniform(0, 2 * np.pi, (2, Np))
    v = random_values(rng, np.complex128, Np)
    weights = jnp.asarray(rng.uniform(0.5, 1.5, Np))
    plan = nufft.PlanNUFFT(np.complex128, shape, sigma=2.0)
    plan = nufft.set_points(plan, pts)
    return plan, v, weights, shape


def test_nonuniform_callback_type1(setup):
    plan, v, weights, shape = setup
    cb = nufft.NUFFTCallbacks(nonuniform=lambda vs, n: tuple(x * weights[n] for x in vs))
    fused = np.asarray(nufft.exec_type1(plan, v, callbacks=cb))
    manual = np.asarray(nufft.exec_type1(plan, (v * np.asarray(weights)).astype(v.dtype)))
    np.testing.assert_allclose(fused, manual, rtol=1e-13)


def test_uniform_callback_type1(setup):
    """uniform callback multiplies each output mode by |k|^2 (the example from
    the reference docs, src/plan.jl:124-143)."""
    plan, v, _, shape = setup
    kx = jnp.asarray(np.fft.fftfreq(shape[0], 1.0) * shape[0])
    ky = jnp.asarray(np.fft.fftfreq(shape[1], 1.0) * shape[1])

    def cb_u(ws, idx):
        i, j = idx
        k2 = kx[i] ** 2 + ky[j] ** 2
        return tuple(w * k2 for w in ws)

    cb = nufft.NUFFTCallbacks(uniform=cb_u)
    fused = np.asarray(nufft.exec_type1(plan, v, callbacks=cb))
    plain = np.asarray(nufft.exec_type1(plan, v))
    k2 = np.add.outer(np.asarray(kx) ** 2, np.asarray(ky) ** 2)
    np.testing.assert_allclose(fused, plain * k2, rtol=1e-12, atol=1e-12)


def test_callbacks_type2(setup, rng):
    plan, _, weights, shape = setup
    u = random_values(rng, np.complex128, shape)
    scale = 2.5

    cb = nufft.NUFFTCallbacks(
        uniform=lambda ws, idx: tuple(w * scale for w in ws),
        nonuniform=lambda vs, n: tuple(x * weights[n] for x in vs),
    )
    fused = np.asarray(nufft.exec_type2(plan, u, callbacks=cb))
    plain = np.asarray(nufft.exec_type2(plan, (u * scale)))
    np.testing.assert_allclose(fused, plain * np.asarray(weights), rtol=1e-12)


def test_callbacks_multiple_transforms(setup, rng):
    """Callbacks see the full tuple of components (reference: callback
    signature docs, src/plan.jl:80-97)."""
    _, _, weights, shape = setup
    Np = weights.shape[0]
    pts = rng.uniform(0, 2 * np.pi, (2, Np))
    v = random_values(rng, np.complex128, (2, Np))
    plan = nufft.PlanNUFFT(np.complex128, shape, ntransforms=2, sigma=2.0)
    plan = nufft.set_points(plan, pts)
    # Swap components in the callback: output c0 <- v1, c1 <- v0.
    cb = nufft.NUFFTCallbacks(nonuniform=lambda vs, n: (vs[1], vs[0]))
    fused = np.asarray(nufft.exec_type1(plan, v, callbacks=cb))
    swapped = np.asarray(nufft.exec_type1(plan, v[::-1].copy()))
    np.testing.assert_allclose(fused, swapped, rtol=1e-13)


def test_inputs_never_modified(setup):
    plan, v, weights, _ = setup
    v0 = v.copy()
    cb = nufft.NUFFTCallbacks(nonuniform=lambda vs, n: tuple(x * weights[n] for x in vs))
    nufft.exec_type1(plan, v, callbacks=cb)
    np.testing.assert_array_equal(v, v0)


def test_callbacks_f64_plans(rng):
    """Callbacks on complex128 plans keep f64 accuracy with reference
    fusion semantics (the reference supports callbacks on every plan type
    including f64, src/plan.jl:62-164).  Fused must equal manually applying
    the same ops around a plain transform."""
    shape, Np = (24, 20), 400
    pts = rng.uniform(0, 2 * np.pi, (2, Np))
    v = random_values(rng, np.complex128, Np)
    weights = rng.uniform(0.5, 1.5, Np)

    plan = nufft.set_points(
        nufft.PlanNUFFT(np.complex128, shape, m=6, sigma=2.0), pts,
    )
    w_j = jnp.asarray(weights)
    cb_nu = nufft.NUFFTCallbacks(
        nonuniform=lambda vs, n: tuple(x * w_j[n] for x in vs)
    )
    fused = np.asarray(nufft.exec_type1(plan, v, callbacks=cb_nu))
    manual = np.asarray(nufft.exec_type1(plan, v * weights))
    np.testing.assert_allclose(fused, manual, rtol=1e-10, atol=1e-12)

    # uniform callback, type-1 and type-2 (sees the deconvolution-scaled
    # spectrum in type 2 — reference src/NonuniformFFTs.jl:453-480).
    kx = jnp.asarray(np.fft.fftfreq(shape[0], 1.0) * shape[0])
    ky = jnp.asarray(np.fft.fftfreq(shape[1], 1.0) * shape[1])

    def cb_u(ws, idx):
        i, j = idx
        k2 = 1.0 + kx[i] ** 2 + ky[j] ** 2
        return tuple(w * k2 for w in ws)

    cb = nufft.NUFFTCallbacks(uniform=cb_u)
    fused1 = np.asarray(nufft.exec_type1(plan, v, callbacks=cb))
    plain1 = np.asarray(nufft.exec_type1(plan, v))
    kxn, kyn = np.asarray(kx), np.asarray(ky)
    k2g = 1.0 + kxn[:, None] ** 2 + kyn[None, :] ** 2
    np.testing.assert_allclose(fused1, plain1 * k2g, rtol=1e-10, atol=1e-12)

    uhat = plain1
    fused2 = np.asarray(nufft.exec_type2(plan, uhat, callbacks=cb))
    manual2 = np.asarray(nufft.exec_type2(plan, uhat * k2g))
    np.testing.assert_allclose(fused2, manual2, rtol=1e-10, atol=1e-12)

    # nonuniform on type-2 applies at the result write.
    fused3 = np.asarray(nufft.exec_type2(plan, uhat, callbacks=cb_nu))
    plain3 = np.asarray(nufft.exec_type2(plan, uhat))
    np.testing.assert_allclose(fused3, plain3 * weights, rtol=1e-10, atol=1e-12)
