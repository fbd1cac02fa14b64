"""The single platform decision (backend.py) and what the plan derives
from it: the spreading method 'auto' resolves to and the stencil chunk
size of the jnp paths."""

import os
from pathlib import Path

import jax
import numpy as np
import pytest

import nonuniformffts_tpu as nufft
from nonuniformffts_tpu import backend
from nonuniformffts_tpu.ops.pallas.spread import padded_buffer_bytes
from nonuniformffts_tpu.plan import (
    BLOCKED_MIN_DENSITY,
    auto_chunk_size,
    resolve_method,
    stencil_bytes_per_point,
)

PKG = Path(nufft.__file__).resolve().parent


def test_platform_is_read_in_one_module():
    """Only backend.py asks JAX which platform it runs on."""
    readers = [
        p.relative_to(PKG).as_posix()
        for p in PKG.rglob("*.py")
        if "default_backend" in p.read_text()
    ]
    assert readers == ["backend.py"]


def test_cpu_backend_is_not_gpu():
    assert backend.platform() == "cpu"
    assert not backend.on_gpu()


def test_stencil_budget_without_memory_stats():
    # The host CPU backend reports no memory statistics.
    assert jax.devices()[0].memory_stats() is None
    assert backend.stencil_budget_bytes() == backend._FALLBACK_BUDGET_BYTES


def test_stencil_budget_from_memory_stats(monkeypatch):
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 64 << 30, "bytes_in_use": 1 << 30}

    monkeypatch.setattr(backend.jax, "devices", lambda: [Dev()])
    assert backend.stencil_budget_bytes() == 8 << 30


@pytest.mark.parametrize(
    "dtype,D,m,C",
    [(np.complex64, 3, 4, 1), (np.complex128, 3, 8, 1), (np.float32, 2, 4, 3),
     (np.float64, 1, 6, 2)],
)
def test_auto_chunk_size_bounds_the_stencil(dtype, D, m, C):
    plan = nufft.PlanNUFFT(dtype, (32,) * D, m=m, ntransforms=C)
    per_point = stencil_bytes_per_point(dtype, D, m, C)
    assert per_point == (2 * m) ** D * (
        4 + np.dtype(dtype).type(0).real.dtype.itemsize
        + C * np.dtype(dtype).itemsize
    )
    assert plan.chunk_size == auto_chunk_size(dtype, D, m, C)
    assert plan.chunk_size * per_point <= backend.stencil_budget_bytes()
    # An explicit chunk size wins.
    assert nufft.PlanNUFFT(dtype, (32,) * D, m=m, ntransforms=C,
                           chunk_size=100).chunk_size == 100


def test_spread_buffer_budget_from_memory_stats(monkeypatch):
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 64 << 30, "bytes_in_use": 1 << 30}

    monkeypatch.setattr(backend.jax, "devices", lambda: [Dev()])
    assert backend.spread_buffer_budget_bytes() == 16 << 30


@pytest.mark.parametrize(
    "dtype,D,m,C,density,gpu,want",
    [
        (np.complex64, 3, 4, 1, 1.0, True, "blocked"),
        (np.complex64, 3, 4, 1, 2 * BLOCKED_MIN_DENSITY, True, "blocked"),
        (np.complex64, 3, 4, 1, BLOCKED_MIN_DENSITY / 4, True, "reference"),
        (np.complex64, 3, 4, 1, 1.0, False, "reference"),
        # Outside the measured series (one complex64 transform, 3-D, M=4):
        # the jnp path until a run brackets the crossover there.
        (np.float32, 3, 4, 1, 1.0, True, "reference"),
        (np.complex128, 3, 8, 1, 1.0, True, "reference"),
        (np.complex64, 2, 4, 1, 1.0, True, "reference"),
        (np.complex64, 3, 5, 1, 1.0, True, "reference"),
        (np.complex64, 3, 4, 4, 1.0, True, "reference"),
    ],
)
def test_resolve_method(dtype, D, m, C, density, gpu, want, monkeypatch):
    monkeypatch.setattr(backend, "on_gpu", lambda: gpu)
    shape_over = (96,) * D
    np_pts = int(density * np.prod(shape_over))
    assert resolve_method(dtype, shape_over, m, C, np_pts) == want


#: A quarter of an 80 GB card's allocatable memory (75% of it).
_CARD_BUFFER_BUDGET = (80 << 30) * 3 // 4 // 4


@pytest.mark.parametrize(
    "n,want", [(384, "blocked"), (512, "blocked"), (1024, "reference")]
)
def test_resolve_method_bounds_the_block_buffer(n, want, monkeypatch):
    """'auto' keeps the blocked path only while its padded buffer (8x the
    grid) and the grid fit a quarter of the device memory."""
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    monkeypatch.setattr(backend, "spread_buffer_budget_bytes",
                        lambda: _CARD_BUFFER_BUDGET)
    shape_over = (n,) * 3
    need = padded_buffer_bytes(shape_over, 4, 2) + 2 * 4 * n**3
    assert (need <= _CARD_BUFFER_BUDGET) == (want == "blocked")
    assert resolve_method(np.complex64, shape_over, 4, 1, n**3) == want


@pytest.mark.parametrize("n,C", [(384, 1), (512, 8), (1024, 1)])
def test_padded_buffer_bytes(n, C):
    """One 16^3 float32 padded block per 8^3 core and real channel."""
    assert padded_buffer_bytes((n,) * 3, 4, 2 * C) == (
        2 * C * (n // 8) ** 3 * 16**3 * 4
    )


def test_auto_blocked_plan_gets_block_geometry(monkeypatch):
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    plan = nufft.PlanNUFFT(np.complex64, (64, 64, 64), sigma=1.5,
                           np_hint=96**3)
    assert plan.spread_method == "blocked"
    assert plan.block_dims == (8, 8, 8)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert backend.setup_compile_cache() == str(tmp_path)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        got = backend.setup_compile_cache()
        assert got == str(PKG.parent / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_path_is_fixed():
    """No temp name, pid or time in the default path: a moving directory
    never hits."""
    env = os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert backend.setup_compile_cache("/a/b") == "/a/b/.jax_cache"
        assert backend.setup_compile_cache("/a/b") == "/a/b/.jax_cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        if env is not None:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env


@pytest.mark.parametrize("np_,chunk", [(1_000_000, 915_000), (10, 3),
                                       (4096, 4096), (4097, 4096)])
def test_balanced_chunks(np_, chunk):
    """Equal chunks of at most chunk_size, padding < one point per chunk."""
    from nonuniformffts_tpu.ops.spreading import balanced_chunks

    n, c = balanced_chunks(np_, chunk)
    assert c <= chunk and n * c >= np_ and n * c - np_ < n
