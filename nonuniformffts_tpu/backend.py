"""The one place the library reads which platform JAX runs on.

Every platform-dependent choice (the spreading method that ``'auto'``
resolves to, whether the Pallas kernel may run compiled, the memory budget
for transient stencils) asks this module, so supporting another platform
means changing one file.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: Transient-stencil budget when the device reports no memory statistics
#: (the host CPU backend).
_FALLBACK_BUDGET_BYTES = 1 << 30


def platform() -> str:
    """JAX's default platform: ``'gpu'``, ``'cpu'``, ..."""
    return jax.default_backend()


def on_gpu() -> bool:
    """True when arrays live on a CUDA GPU, where the Pallas spread kernel
    compiles through Triton."""
    return platform() == "gpu"


def _memory_share(divisor: int) -> int:
    """``1/divisor`` of the device memory JAX may allocate
    (``memory_stats()['bytes_limit']``)."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return _FALLBACK_BUDGET_BYTES
    return int(limit) // divisor


def stencil_budget_bytes() -> int:
    """Bytes a transient per-chunk stencil may take: one eighth of the
    device memory, so the grid, the point state and XLA's own temporaries
    keep the rest."""
    return _memory_share(8)


def spread_buffer_budget_bytes() -> int:
    """Bytes the blocked spread's padded block buffer and the grid may take
    together: one quarter of the device memory, so the overlap-add's
    temporaries (up to about the buffer's size again), the point state and
    the FFT keep the rest."""
    return _memory_share(4)


def setup_compile_cache(checkout: Path | str | None = None) -> str:
    """Point JAX's persistent compilation cache at ``JAX_COMPILATION_CACHE_DIR``
    when that is set, otherwise at ``<checkout>/.jax_cache`` (a fixed path:
    the cache key includes it, so a moving directory never hits).  Returns
    the directory used."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        root = Path(checkout) if checkout else Path(__file__).resolve().parents[1]
        path = str(root / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
