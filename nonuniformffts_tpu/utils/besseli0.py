"""Zeroth-order modified Bessel function of the first kind.

Needed by the Kaiser-Bessel window (direct evaluation, reference:
src/Kernels/kaiser_bessel.jl:196-210) and the backwards-KB Fourier factors
(src/Kernels/kaiser_bessel_backwards.jl:138-145).  Routes through
``jax.scipy.special.i0`` (accurate to ~4e-14 in f64).
"""

import jax.numpy as jnp
import jax.scipy.special as _jsp


def besseli0(x):
    return _jsp.i0(jnp.asarray(x))
