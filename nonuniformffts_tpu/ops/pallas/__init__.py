"""Pallas kernels (Triton route) of the blocked fast path."""

from .spread import spread_blocked

__all__ = ["spread_blocked"]
