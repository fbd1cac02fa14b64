"""Time the 3D NUFFT on one GPU, per spreading method.

    python bench.py                          # Np = 1e6 and rho = 1
    python bench.py --np 1000000 3000000 --methods blocked reference

The reference's protocol (docs/src/benchmarks.md:5-27,
benchmark/CPU+CUDA/run_benchmarks.jl:390-404, BASELINE.md): a 256^3 grid,
sigma = 1.5, m = 4, backwards Kaiser-Bessel kernel, points uniform in
[0, 2pi)^3 from ``--seed``, complex64 data.  For every (Np, method) it
prints one JSON line with the median and quartiles over ``--reps`` warm
runs of ``set_points``, type 1 and type 2 (each ending in
``block_until_ready``) and of their sum, the achieved relative errors
against exact DFT sums (type 1 on 384 modes, type 2 on 4,096 points), the
card and the device count.  It exits nonzero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _quartiles(ts):
    import numpy as np

    q1, med, q3 = np.percentile(np.asarray(ts) * 1e3, [25, 50, 75])
    return {"median_ms": float(med), "q1_ms": float(q1), "q3_ms": float(q3)}


def bench_one(n, np_, method, reps, seed):
    import jax
    import numpy as np

    import nonuniformffts_tpu as nufft
    from chip_smoke import _exact_type1, _exact_type2, _rel_l2

    rng = np.random.default_rng(seed)
    pts = jax.device_put(rng.uniform(0, 2 * np.pi, (3, np_)).astype(np.float32))
    v = jax.device_put(
        (rng.standard_normal(np_) + 1j * rng.standard_normal(np_)).astype(
            np.complex64
        )
    )
    plan0 = nufft.PlanNUFFT(np.complex64, (n,) * 3, m=4, sigma=1.5,
                            spread_method=method)

    def run():
        t = [time.perf_counter()]
        p = jax.block_until_ready(nufft.set_points(plan0, pts))
        t.append(time.perf_counter())
        u = jax.block_until_ready(nufft.exec_type1(p, v))
        t.append(time.perf_counter())
        v2 = jax.block_until_ready(nufft.exec_type2(p, u))
        t.append(time.perf_counter())
        return p, u, v2, np.diff(t)

    t0 = time.perf_counter()
    p, u, v2, _ = run()  # compiles
    compile_s = time.perf_counter() - t0
    stages = np.asarray([run()[3] for _ in range(reps)])
    out = {
        "N": n, "Np": np_, "rho": np_ / n**3, "method": p.spread_method,
        "reps": reps, "compile_s": compile_s,
        "set_points": _quartiles(stages[:, 0]),
        "type1": _quartiles(stages[:, 1]),
        "type2": _quartiles(stages[:, 2]),
        "total": _quartiles(stages.sum(axis=1)),
    }
    pts_h, v_h = np.asarray(pts), np.asarray(v)
    kv = [np.asarray(k, np.float64) for k in p.kvec]
    idx = [rng.integers(0, n, 384) for _ in range(3)]
    kcols = np.stack([kv[d][idx[d]] for d in range(3)])
    out["err1"] = _rel_l2(np.asarray(u)[tuple(idx)],
                          _exact_type1(pts_h, v_h, kcols))
    sel = rng.choice(np_, 4096, replace=False)
    out["err2"] = _rel_l2(np.asarray(v2)[sel],
                          _exact_type2(pts_h[:, sel], np.asarray(u), kv, False))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--np", type=int, nargs="+", default=[1_000_000, 256**3])
    ap.add_argument("--methods", nargs="+", default=["blocked", "reference"])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", True)  # float64 oracles
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    from chip_smoke import _card
    from nonuniformffts_tpu import backend

    backend.setup_compile_cache(ROOT)
    dev = jax.devices()[0]
    info = {"card": _card(), "device_kind": dev.device_kind,
            "devices": len(jax.devices())}
    for np_ in args.np:
        for method in args.methods:
            row = bench_one(args.n, np_, method, args.reps, args.seed)
            print(json.dumps({**info, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
