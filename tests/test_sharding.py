"""Multi-device sharded execution on a virtual 8-device CPU mesh.

The reference has no distributed mode; this validates our extension
(parallel/sharded.py): point-parallel spreading with a psum grid merge must
reproduce the single-device result exactly, and type-2 must be a
zero-communication local gather.
"""

import jax
import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nonuniformffts_tpu.parallel import (
    exec_type1_sharded,
    exec_type2_sharded,
    make_mesh,
    shard_points,
)
from nufft_test_utils import random_values


@pytest.mark.parametrize("chunk_size", [None, 16])
@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_sharded_matches_single_device(dtype, chunk_size, rng):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(8)
    shape = (24, 18)
    Np = 8 * 50
    pts = rng.uniform(0, 2 * np.pi, (2, Np))
    v = random_values(rng, dtype, (1, Np))

    # chunk_size=16 makes every device scan over stencil chunks.
    plan = nufft.PlanNUFFT(dtype, shape, sigma=2.0, spread_method="reference",
                           chunk_size=chunk_size)
    is_real = not np.issubdtype(np.dtype(dtype), np.complexfloating)
    v_ch = v if is_real else np.stack([v.real, v.imag], axis=1)

    pts_d, v_d = shard_points(mesh, pts, v_ch)
    u_ch = np.asarray(exec_type1_sharded(plan, pts_d, v_d, mesh=mesh))

    ref = nufft.set_points(plan, pts)
    u_ref = np.asarray(nufft.exec_type1(ref, v))
    got = u_ch[:, 0] + 1j * u_ch[:, 1]
    np.testing.assert_allclose(got, u_ref, rtol=1e-12, atol=1e-12)

    # Type 2 round.
    v2_ch = np.asarray(exec_type2_sharded(plan, pts_d, u_ch, mesh=mesh))
    v2_ref = np.asarray(nufft.exec_type2(ref, u_ref.astype(plan.complex_dtype)))
    got2 = v2_ch if is_real else v2_ch[:, 0] + 1j * v2_ch[:, 1]
    np.testing.assert_allclose(got2, v2_ref, rtol=1e-11, atol=1e-11)


def test_sharded_is_actually_distributed(rng):
    """The compiled type-1 must contain a cross-device reduction (psum) and
    sharded point inputs."""
    mesh = make_mesh(8)
    plan = nufft.PlanNUFFT(np.complex128, (16, 16), sigma=2.0,
                           spread_method="reference")
    pts = rng.uniform(0, 2 * np.pi, (2, 160))
    v = random_values(rng, np.complex128, (1, 160))
    v_ch = np.stack([v.real, v.imag], axis=1)
    pts_d, v_d = shard_points(mesh, pts, v_ch)
    lowered = exec_type1_sharded.lower(plan, pts_d, v_d, mesh=mesh)
    assert "num_partitions = 8" in lowered.as_text()
    compiled = lowered.compile().as_text()
    assert "all-reduce" in compiled
