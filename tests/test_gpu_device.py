"""Compiled-kernel tests on a CUDA GPU (marker ``gpu``).

The CPU suite runs the Pallas spread kernel in the interpreter; here it
runs as Triton compiled it for the card, and the plan's GPU choices (the
spreading method, the stencil chunk size, the refusal of interpret mode)
are checked where they apply.  ``python chip_smoke.py`` runs this file on a
GPU host; elsewhere every test skips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nonuniformffts_tpu.ops.pallas import spread_blocked
from nonuniformffts_tpu.ops.spreading import spread_reference

pytestmark = pytest.mark.gpu


def _rel(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(rng, dtype, D, Np, C=1):
    rdt = np.dtype(dtype).type(0).real.dtype
    pts = rng.uniform(0, 2 * np.pi, (D, Np)).astype(rdt)
    v = rng.standard_normal((C, Np))
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal((C, Np))
    return pts, v.astype(dtype)


@pytest.mark.parametrize("shape", [(64, 64, 64), (96, 80), (512,)])
def test_compiled_spread_matches_reference(shape, rng):
    D = len(shape)
    Np = 20_000
    pts, v = _inputs(rng, np.complex64, D, Np)
    plan = nufft.set_points(
        nufft.PlanNUFFT(np.complex64, shape, m=4, sigma=1.5,
                        spread_method="blocked"), pts,
    )
    ch = jnp.stack([jnp.real(v[0]), jnp.imag(v[0])])
    g = jax.jit(spread_blocked)(plan, ch)
    ref = spread_reference(plan.kernel_data, plan.evalmode, plan.shape_over,
                           plan.points, jnp.asarray(v), chunk_size=None)
    assert _rel(np.asarray(g[0]) + 1j * np.asarray(g[1]), ref[0]) < 5e-6


@pytest.mark.parametrize("dtype,C", [(np.complex64, 1), (np.complex64, 3),
                                     (np.float32, 1), (np.float32, 2)])
def test_blocked_plan_matches_reference(dtype, C, rng):
    shape = (48, 48, 48)
    Np = 50_000
    pts, v = _inputs(rng, dtype, 3, Np, C)
    out = {}
    for method in ("blocked", "reference"):
        p = nufft.set_points(
            nufft.PlanNUFFT(dtype, shape, m=4, sigma=1.5, ntransforms=C,
                            spread_method=method), pts,
        )
        u = nufft.exec_type1(p, v)
        out[method] = (np.asarray(u), np.asarray(nufft.exec_type2(p, u)))
    for a, b in zip(out["blocked"], out["reference"]):
        assert _rel(a, b) < 5e-6


def test_auto_method_follows_density_and_dtype():
    over = nufft.PlanNUFFT(np.complex64, (64, 64, 64), sigma=1.5).shape_over
    cells = int(np.prod(over))
    dense = nufft.PlanNUFFT(np.complex64, (64, 64, 64), sigma=1.5,
                            np_hint=cells // 2)
    sparse = nufft.PlanNUFFT(np.complex64, (64, 64, 64), sigma=1.5,
                             np_hint=cells // 1000)
    wide = nufft.PlanNUFFT(np.complex128, (64, 64, 64), sigma=1.5,
                           np_hint=cells // 2)
    batched = nufft.PlanNUFFT(np.complex64, (64, 64, 64), sigma=1.5,
                              ntransforms=2, np_hint=cells // 2)
    assert dense.spread_method == "blocked"
    assert sparse.spread_method == "reference"
    assert wide.spread_method == "reference"
    assert batched.spread_method == "reference"


def test_auto_method_resolves_at_set_points(rng):
    plan = nufft.PlanNUFFT(np.complex64, (32, 32, 32), sigma=1.5)
    assert plan.spread_method == "auto"
    pts = rng.uniform(0, 2 * np.pi, (3, 40_000)).astype(np.float32)
    assert nufft.set_points(plan, pts).spread_method == "blocked"


def test_interpret_refused_on_gpu():
    with pytest.raises(ValueError, match="interpret"):
        nufft.PlanNUFFT(np.complex64, (32, 32), spread_method="blocked",
                        interpret=True)


def test_chunk_size_follows_device_memory():
    from nonuniformffts_tpu.plan import stencil_bytes_per_point

    limit = jax.devices()[0].memory_stats()["bytes_limit"]
    plan = nufft.PlanNUFFT(np.complex64, (256, 256, 256), m=4, sigma=1.5)
    per_point = stencil_bytes_per_point(np.complex64, 3, 4, 1)
    assert plan.chunk_size == (limit // 8) // per_point
