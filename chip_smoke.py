"""Run the NUFFT main path once on a GPU at the reference benchmark's size.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the multi-device paths only

Phase 0 names the card and runs the GPU-only tests (``pytest -m gpu``) in
this same process.  Phase 1 checks that a complex64 plan compiles to 32-bit
operations with ``jax_enable_x64`` on.  Phase 2 compares the compiled
Pallas spread kernel with ``spread_reference`` at Np = 1e6.  Phase 3 runs
``PlanNUFFT -> set_points -> exec_type1 -> exec_type2`` at 256^3 (points
uniform in [0, 2pi)^3 from ``--seed``, backwards Kaiser-Bessel kernel) for
each case of CASES and checks type 1 on 384 random modes and type 2 on
4,096 random points against exact DFT sums in float64.

With ``--four-cards`` it runs the point-parallel ``exec_type{1,2}_sharded``
and the grid-sharded ``SpatialNUFFT`` on a 1-D mesh of four GPUs at 256^3,
complex64, rho = 1, and compares both with the one-card result.

Every phase prints one line; the script exits nonzero if any phase fails
or if JAX finds no GPU.  The last line of a passing run is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 256
RHO1 = N**3  # rho = 1: as many points as output modes

#: (name, dtype, m, sigma, Np, tolerance) — tolerances from the accuracy
#: model (BASELINE.md): ~1.3e-6 at m=4, sigma=1.5 plus float32 storage;
#: ~2e-14 at m=8, sigma=2 plus sums taken in atomic order.
CASES = (
    ("c64_m4_1M", "complex64", 4, 1.5, 1_000_000, 5e-6),
    ("f32_m4_1M", "float32", 4, 1.5, 1_000_000, 5e-6),
    ("c64_m4_rho1", "complex64", 4, 1.5, RHO1, 5e-6),
    ("c128_m8_1M", "complex128", 8, 2.0, 1_000_000, 1e-11),
    ("f64_m8_1M", "float64", 8, 2.0, 1_000_000, 1e-11),
)
N_MODES = 384
N_POINTS = 4096


def _say(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def _run_gpu_tests() -> int:
    import pytest

    os.environ["NUFFT_GPU_TESTS"] = "1"
    return int(pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", str(ROOT / "tests")]
    ))


# ---------------------------------------------------------------------------
# Exact DFT oracles (float64, on the device, independent of the library)
# ---------------------------------------------------------------------------


def _exact_type1(pts, v, kcols):
    """u[k] = sum_j v_j exp(-i k.x_j) for the mode list ``kcols`` (D, K)."""
    import jax
    import jax.numpy as jnp

    pts = jnp.asarray(pts, jnp.float64)
    v = jnp.asarray(v, jnp.complex128)
    kcols = jnp.asarray(kcols, jnp.float64)

    @jax.jit
    def one(k):
        ph = jnp.sum(k[:, None] * pts, axis=0)
        return jnp.sum(v * jnp.exp(-1j * ph))

    return jax.lax.map(one, kcols.T)


def _exact_type2(pts, u, kvecs, real: bool):
    """v_j = sum_k u_k exp(+i k.x_j) at the points ``pts`` (D, J); for
    real-data plans the halved last axis counts its k > 0 planes twice and
    the result is the real part (the c2r convention of the library)."""
    import jax
    import jax.numpy as jnp

    u = jnp.asarray(u, jnp.complex128)
    if real:
        w = jnp.where(jnp.asarray(kvecs[-1]) == 0, 1.0, 2.0)
        u = u * w
    facs = [jnp.exp(1j * jnp.outer(jnp.asarray(p, jnp.float64),
                                   jnp.asarray(k, jnp.float64)))
            for p, k in zip(pts, kvecs)]

    @jax.jit
    def batch(u, f0, f1, f2):
        t = jnp.einsum("abc,jc->jab", u, f2,
                       precision=jax.lax.Precision.HIGHEST)
        t = jnp.einsum("jab,jb->ja", t, f1)
        return jnp.einsum("ja,ja->j", t, f0)

    out = []
    B = 128
    for s in range(0, pts.shape[1], B):
        out.append(batch(u, *(f[s:s + B] for f in facs)))
    v = jnp.concatenate(out)
    return v.real if real else v


def _rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_hlo_32bit() -> bool:
    """A complex64 type-1 call lowers to f32/s32 only, with x64 on."""
    import re

    import jax
    import numpy as np

    import nonuniformffts_tpu as nufft
    from nonuniformffts_tpu.execution import _EMPTY_CALLBACKS, _exec_type1_ch_impl

    ok = True
    for method in ("reference", "blocked"):
        plan = nufft.PlanNUFFT(np.complex64, (64, 64, 64), m=4, sigma=1.5,
                               spread_method=method)
        rng = np.random.default_rng(0)
        plan = nufft.set_points(
            plan, rng.uniform(0, 2 * np.pi, (3, 20_000)).astype(np.float32)
        )
        v = jax.numpy.zeros((1, 2, 20_000), np.float32)
        text = _exec_type1_ch_impl.lower(plan, v, _EMPTY_CALLBACKS).as_text()
        wide = sorted(set(re.findall(r"\b(f64|s64|u64|complex<f64>)\b", text)))
        _say("hlo_32bit", method=method, wide_types=wide, ok=not wide)
        ok &= not wide
    return ok


def phase_kernel_vs_reference(seed: int, np_: int = 1_000_000) -> bool:
    """The compiled Pallas spread against spread_reference at Np = 1e6."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import nonuniformffts_tpu as nufft
    from nonuniformffts_tpu.ops.pallas import spread_blocked
    from nonuniformffts_tpu.ops.spreading import spread_reference

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 2 * np.pi, (3, np_)).astype(np.float32)
    v = (rng.standard_normal(np_) + 1j * rng.standard_normal(np_)).astype(
        np.complex64
    )
    plan = nufft.set_points(
        nufft.PlanNUFFT(np.complex64, (N,) * 3, m=4, sigma=1.5,
                        spread_method="blocked"), pts,
    )
    ch = jnp.stack([jnp.real(v), jnp.imag(v)])
    g_k = jax.jit(spread_blocked)(plan, ch)
    g_r = jax.jit(
        lambda p, x: spread_reference(
            p.kernel_data, p.evalmode, p.shape_over, p.points, x,
            chunk_size=p.chunk_size,
        )
    )(plan, jnp.asarray(v)[None])[0]
    g_k = np.asarray(g_k[0]) + 1j * np.asarray(g_k[1])
    err = _rel_l2(g_k, g_r)
    ok = bool(np.isfinite(err) and err < 5e-6)
    _say("kernel_vs_reference", Np=np_, grid=list(plan.shape_over),
         block_dims=list(plan.block_dims), rel_l2=err, tol=5e-6, ok=ok)
    return ok


def phase_main_path(name, dtype, m, sigma, np_, tol, seed) -> bool:
    import jax
    import numpy as np

    import nonuniformffts_tpu as nufft

    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    rdt = dt.type(0).real.dtype
    t0 = time.perf_counter()
    pts = rng.uniform(0, 2 * np.pi, (3, np_)).astype(rdt)
    if dt.kind == "c":
        v = (rng.standard_normal(np_) + 1j * rng.standard_normal(np_)).astype(dt)
    else:
        v = rng.standard_normal(np_).astype(dt)
    plan = nufft.PlanNUFFT(dt, (N,) * 3, m=m, sigma=sigma)
    plan = nufft.set_points(plan, pts)
    u = nufft.exec_type1(plan, v)
    spec = plan.spectral_shape
    uin = (rng.standard_normal(spec) + 1j * rng.standard_normal(spec)).astype(
        plan.complex_dtype
    )
    v2 = nufft.exec_type2(plan, uin)
    jax.block_until_ready((u, v2))
    t_run = time.perf_counter() - t0

    kv = [np.asarray(k, np.float64) for k in plan.kvec]
    idx = [rng.integers(0, s, N_MODES) for s in spec]
    kcols = np.stack([kv[d][idx[d]] for d in range(3)])
    got1 = np.asarray(u)[tuple(idx)]
    err1 = _rel_l2(got1, _exact_type1(pts, v, kcols))
    sel = rng.choice(np_, N_POINTS, replace=False)
    exact2 = _exact_type2(pts[:, sel], uin, kv, real=dt.kind == "f")
    err2 = _rel_l2(np.asarray(v2)[sel], exact2)
    finite = bool(np.all(np.isfinite(np.asarray(u))) and
                  np.all(np.isfinite(np.asarray(v2))))
    ok = finite and err1 < tol and err2 < tol and u.shape == spec
    _say("main_path", case=name, dtype=dtype, m=m, sigma=sigma, Np=np_,
         grid=list(plan.shape_over), method=plan.spread_method,
         err1=err1, err2=err2, tol=tol, first_run_s=round(t_run, 3),
         ok=bool(ok))
    return bool(ok)


def phase_four_cards(seed: int) -> bool:
    """Point-parallel and grid-sharded runs on four GPUs vs one GPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import nonuniformffts_tpu as nufft
    from nonuniformffts_tpu.parallel import (
        SpatialNUFFT, exec_type1_sharded, exec_type2_sharded, make_mesh,
        shard_points,
    )

    devs = jax.devices()
    if len(devs) < 4:
        _say("four_cards", ok=False, reason=f"{len(devs)} devices")
        return False
    rng = np.random.default_rng(seed)
    np_ = RHO1
    pts = rng.uniform(0, 2 * np.pi, (3, np_)).astype(np.float32)
    v = (rng.standard_normal(np_) + 1j * rng.standard_normal(np_)).astype(
        np.complex64
    )
    kw = dict(m=4, sigma=1.5)
    # One-card reference, kept on device 0.
    with jax.default_device(devs[0]):
        plan = nufft.set_points(nufft.PlanNUFFT(np.complex64, (N,) * 3, **kw), pts)
        u1 = np.asarray(nufft.exec_type1(plan, v))
        v1 = np.asarray(nufft.exec_type2(plan, u1))
        del plan
    v_ch = np.stack([v.real, v.imag])[None]
    u_ch1 = np.stack([u1.real, u1.imag])[None]
    ok = True

    mesh = make_mesh(4)
    base = nufft.PlanNUFFT(np.complex64, (N,) * 3, spread_method="reference", **kw)
    pts_d, v_d = shard_points(mesh, pts, v_ch)
    u_s = exec_type1_sharded(base, pts_d, v_d, mesh=mesh)
    v_s = exec_type2_sharded(base, pts_d, jnp.asarray(u_ch1), mesh=mesh)
    u_s = np.asarray(u_s[0, 0]) + 1j * np.asarray(u_s[0, 1])
    v_s = np.asarray(v_s[0, 0]) + 1j * np.asarray(v_s[0, 1])
    e1, e2 = _rel_l2(u_s, u1), _rel_l2(v_s, v1)
    good = e1 < 1e-5 and e2 < 1e-5
    _say("four_cards", path="exec_type_sharded", devices=4, err1_vs_1card=e1,
         err2_vs_1card=e2, tol=1e-5, ok=bool(good))
    ok &= good

    sp = SpatialNUFFT(np.complex64, (N,) * 3,
                      mesh=Mesh(np.asarray(devs[:4]), ("grid",)), **kw)
    st = sp.set_points(pts)
    u_sp = np.asarray(sp.exec_type1(st, v_ch))
    v_sp = np.asarray(sp.exec_type2(st, u_ch1))
    e1 = _rel_l2(u_sp[0, 0] + 1j * u_sp[0, 1], u1)
    e2 = _rel_l2(v_sp[0, 0] + 1j * v_sp[0, 1], v1)
    good = e1 < 1e-5 and e2 < 1e-5
    _say("four_cards", path="SpatialNUFFT", devices=4, err1_vs_1card=e1,
         err2_vs_1card=e2, tol=1e-5, ok=bool(good))
    return bool(ok and good)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", True)
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    from nonuniformffts_tpu import backend

    cache = backend.setup_compile_cache(ROOT)
    card = _card()
    print(card, flush=True)
    dev = jax.devices()[0]
    _say("setup", card=card, jax=jax.__version__, device_kind=dev.device_kind,
         devices=len(jax.devices()), compile_cache=cache)

    t0 = time.perf_counter()
    if args.four_cards:
        ok = phase_four_cards(args.seed)
    else:
        rc = _run_gpu_tests()
        _say("gpu_tests", pytest_exit=rc, ok=rc == 0)
        ok = rc == 0
        ok &= phase_hlo_32bit()
        ok &= phase_kernel_vs_reference(args.seed)
        for case in CASES:
            ok &= phase_main_path(*case, seed=args.seed)
    _say("done", seconds=round(time.perf_counter() - t0, 1), ok=bool(ok))
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
