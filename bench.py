"""Benchmark of the KL fleet on one NVIDIA GPU.

    python bench.py [--rows f32,cross,cert,sweep] [--out FILE]

Rows, each one JSON line naming the device and the card:

  * ``kl_f32``: the f32 fleet solve at n = 100, 10,000 instances, dual dim
    3 (bench family: P(A) >= pA active, P(B) <= pB) and wider (random
    sparse k-row families; ``--dims``, default 3,8,16), by the Triton dual kernel
    (ops/pallas_kl_dual.py, 16 steps) and by the XLA route
    (``DistKL.solve_dual_newton`` under vmap, 30 steps), each with
    the host-side f64 certificate of what it returned.
  * ``kl_cross``: kernel against the XLA route at wider rows
    (n = 1,000 to 10,000) — where the kernel stops paying
    (``backend.TRITON_MAX_N``).
  * ``kl_certified``: ``DistKL.solve_certified_batch`` at the three dims,
    split into the f32 solve and the native-f64 finish.
  * ``kl_tile`` (row group ``sweep``): the kernel's (instances per
    program, warps) choice at the flagship shape.

``--rows`` picks the row groups (default: f32, cross and cert).

Every time is the median of repeated warm runs, each closed with
``block_until_ready``.  Finds no GPU: exits 1.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import chip_smoke as cs


def row(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def family(dim: int, batch: int, n: int = 100):
    return cs.flagship(batch, n) if dim == 3 else cs.wide(dim - 1, batch, n)


def main(argv):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="f32,cross,cert")
    ap.add_argument("--dims", default="3,8,16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from cvx_tpu import backend
    from cvx_tpu.diagnostics import kl_gap_certificate_np
    from cvx_tpu.models import DistKL
    from cvx_tpu.ops.pallas_kl_dual import _tile, kl_dual_fused

    backend.enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    rows = set(args.rows.split(","))
    base = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": cs.card()}
    failed = 0

    def run(name, fn, u, H, u_np, **extra):
        nonlocal failed
        rec = dict(metric=name, **extra)
        try:
            t0 = time.perf_counter()
            x = np.asarray(jax.block_until_ready(fn(u)), np.float64)
            rec["compile_s"] = time.perf_counter() - t0
            rec["ms"] = cs.median_ms(fn, u, reps=7)
            rec["inst_per_s"] = u.shape[0] / (rec["ms"] * 1e-3)
            rec["gap_host_f64_max"] = float(np.max(
                kl_gap_certificate_np(x, H, u_np)))
        except Exception as e:            # keep measuring the other rows
            failed += 1
            rec["error"] = f"{type(e).__name__}: {str(e)[:400]}"
        row(args.out, {**rec, **base})

    def kernel(H, bt=None, num_warps=None):
        k, n = H.shape
        H32 = jnp.asarray(H, jnp.float32)

        @jax.jit
        def solve(u_):
            Hb = jnp.broadcast_to(H32[None], (u_.shape[0], k, n))
            return kl_dual_fused(Hb, u_, n_steps=16, bt=bt,
                                 num_warps=num_warps)[0]
        return solve

    def xla(H, steps):
        k, n = H.shape
        H32 = jnp.asarray(H, jnp.float32)

        @jax.jit
        def solve(u_):
            def one(ui):
                return DistKL.create(n, H=H32, u=ui).solve_dual_newton(
                    steps=steps).x
            return jax.vmap(one)(u_)
        return solve

    dims = [int(d) for d in args.dims.split(",")]
    for dim in (dims if "f32" in rows else ()):
        H, u_np = family(dim, 10000)
        u = jnp.asarray(u_np, jnp.float32)
        bt, nw = _tile(128)
        run(f"kl_f32_dim{dim}_n100_triton", kernel(H), u, H, u_np,
            dim=dim, n=100, batch=10000, bt=bt, num_warps=nw, steps=16)
        run(f"kl_f32_dim{dim}_n100_xla30", xla(H, 30), u, H, u_np,
            dim=dim, n=100, batch=10000, steps=30)

    for n, batch in (((1000, 1000), (4096, 250), (10000, 100))
                     if "cross" in rows else ()):
        H, u_np = family(3, batch, n)
        u = jnp.asarray(u_np, jnp.float32)
        bt, nw = _tile(1 << (n - 1).bit_length())
        run(f"kl_cross_n{n}_triton", kernel(H), u, H, u_np, n=n,
            batch=batch, bt=bt, num_warps=nw)
        run(f"kl_cross_n{n}_xla30", xla(H, 30), u, H, u_np, n=n,
            batch=batch)

    for dim in (dims if "cert" in rows else ()):
        H, u_np = family(dim, 10000)
        u = jnp.asarray(u_np, jnp.float32)
        prob = DistKL.create(100, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((dim - 1,), jnp.float32))
        rec = {"metric": f"kl_certified_dim{dim}_n100", "batch": 10000,
               "route": prob.fleet_route()}
        try:
            cert = jax.jit(lambda u_, p=prob: p.solve_certified_batch(u_))
            f32 = jax.jit(lambda u_, p=prob: p.solve_batch(u_).x)
            s = jax.block_until_ready(cert(u))
            rec["ms"] = cs.median_ms(cert, u, reps=7)
            rec["ms_f32_solve"] = cs.median_ms(f32, u, reps=7)
            rec["ms_certify"] = rec["ms"] - rec["ms_f32_solve"]
            rec["inst_per_s"] = 10000 / (rec["ms"] * 1e-3)
            rec["gap_absmax"] = float(jnp.max(jnp.abs(s.duality_gap)))
            rec["stalled"] = int(jnp.sum(s.stalled))
        except Exception as e:
            failed += 1
            rec["error"] = f"{type(e).__name__}: {str(e)[:400]}"
        row(args.out, {**rec, **base})

    if "sweep" in rows:
        for dim in (3,):
            H, u_np = family(dim, 10000)
            u = jnp.asarray(u_np, jnp.float32)
            for bt, nw in ((1, 1), (2, 1), (4, 1), (4, 2), (8, 2), (8, 4),
                           (16, 4)):
                run(f"kl_tile_dim{dim}_bt{bt}_w{nw}", kernel(H, bt, nw),
                    u, H, u_np, dim=dim, bt=bt, num_warps=nw)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
