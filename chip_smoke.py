"""Smoke test of cvx_tpu on one NVIDIA GPU, through the public entry points.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # phase 5 only: the four-card paths

Phases (each prints one line; any failure exits non-zero):

1. device      platform, device kind and count, and the card's name and
               power limit as nvidia-smi reports them.  Not a GPU: fail.
2. fleet       ``DistKL.solve_batch`` (the f32 dual route) on 10,000 KL
               instances, n = 100, k = 2.  Checks that the route
               ``fleet_route()`` reports is the route in the compiled
               program, and compares with the plain reference: the same
               instances solved by ``solve_dual_newton`` in f64 on the card
               plus the host-side f64 certificate
               ``diagnostics.kl_gap_certificate_np``.
3. certified   ``DistKL.solve_certified_batch`` on the same fleet and on
               10,000-instance families of dual dim 8 and 16: |gap| <= 1e-8
               (SolverParams.scala:41), residuals <= 1e-10, none stalled,
               x within 1e-8 of the f64 reference.
4. qp          the dense n = 1000 QP (m = 500, p = 10): f32 barrier plus the
               f64 ``qp_certify`` finish, against the f64 primal-dual route.
5. four        (``--four`` only) the dp-sharded certified KL fleet of 40,000
               instances against one card (<= 1e-12 apart), the config-5
               Schur-consensus QP sharded over the cards against the
               single-card solve, and ``dryrun_multichip(4)``.

Timings are medians of repeated warm runs, each closed with
``block_until_ready``.  The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
FLEET = 10000
N = 100


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """``name, power.limit`` of the first card, read by a child process
    that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    return out.strip().splitlines()[0]


def median_ms(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` over ``reps`` warm runs."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1e3 * times[len(times) // 2]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- families
# Families are drawn in f64 and rounded to f32: the system solves the f32
# data, and the f64 reference must solve the very same problem.
def _f32_exact(*arrays):
    import numpy as np

    return tuple(np.asarray(a, np.float32).astype(np.float64)
                 for a in arrays)


def flagship(batch: int, n: int = N, seed: int = 0):
    """k = 2: P(A) >= pA (active) and P(B) <= pB — bench.py's family."""
    import numpy as np

    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B])
    u = np.column_stack([-rng.uniform(0.2, 0.5, batch),
                         rng.uniform(0.55, 0.8, batch)])
    return _f32_exact(H, u)


def wide(k: int, batch: int, n: int = N, seed: int = 0):
    """Random sparse k-row family with slack margins (tests/test_round4.py
    and test_round5.py, scaled to a fleet): dual dim k + 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    u = (H @ x0)[None, :] + rng.uniform(0.05, 0.15, (batch, k))
    return _f32_exact(H, u)


def f64_reference(H, u, steps: int = 40):
    """The plain reference: ``solve_dual_newton`` in f64 under vmap."""
    import jax
    import jax.numpy as jnp

    from cvx_tpu.models import DistKL

    H64 = jnp.asarray(H, jnp.float64)
    n = H64.shape[1]

    @jax.jit
    def run(u_):
        def one(ui):
            return DistKL.create(n, H=H64, u=ui).solve_dual_newton(
                steps=steps).x
        return jax.vmap(one)(u_)

    return run(jnp.asarray(u, jnp.float64))


def compile_with_route(fn, *args):
    """Compile ``fn`` for ``args``; returns ``(route, compiled)`` where
    route is "triton" if the compiled program holds the fused dual kernel
    as a Triton call, else "xla"."""
    import jax

    from cvx_tpu.ops.pallas_kl_dual import KERNEL_NAME

    lowered = jax.jit(fn).lower(*args)
    text = lowered.as_text()
    compiled = lowered.compile()
    has = ("__gpu$xla.gpu.triton" in text and KERNEL_NAME in text
           and KERNEL_NAME in compiled.as_text())
    return ("triton" if has else "xla"), compiled


# ------------------------------------------------------------------ phases
def phase_fleet(batch: int = FLEET, interpret: bool = False) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cvx_tpu.diagnostics import kl_gap_certificate_np
    from cvx_tpu.models import DistKL

    H, u_np = flagship(batch)
    prob = DistKL.create(N, H=jnp.asarray(H, jnp.float32),
                         u=jnp.zeros((2,), jnp.float32))
    u = jnp.asarray(u_np, jnp.float32)
    route = prob.fleet_route(interpret)

    def solve(u_):
        s = prob.solve_batch(u_, interpret=interpret)
        return s.x, s.duality_gap

    ran, fn = compile_with_route(solve, u)
    if not interpret:
        check(ran == route, f"fleet_route() says {route!r}, compiled "
                            f"program runs {ran!r}")
    x, gap = jax.block_until_ready(fn(u))
    ms = median_ms(fn, u)
    x = np.asarray(x, np.float64)
    x_ref = np.asarray(f64_reference(H, u_np))
    cert = kl_gap_certificate_np(x, H, u_np)
    out = {"route": route, "ms": ms,
           "inst_per_s": batch / (ms * 1e-3),
           "gap_host_f64_max": float(np.max(cert)),
           "gap_kernel_max": float(np.max(np.asarray(gap))),
           "sum_err_max": float(np.max(np.abs(x.sum(axis=1) - 1.0))),
           "x_err_max": float(np.max(np.abs(x - x_ref)))}
    check(out["gap_host_f64_max"] <= 1e-5, f"fleet gap {out}")
    check(out["sum_err_max"] <= 1e-6, f"fleet |sum x - 1| {out}")
    check(out["x_err_max"] <= 1e-5, f"fleet x vs f64 reference {out}")
    return out


def phase_certified(batch: int = FLEET, interpret: bool = False) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cvx_tpu.models import DistKL

    out = {}
    for name, (H, u_np) in (("dim3", flagship(batch)),
                            ("dim8", wide(7, batch)),
                            ("dim16", wide(15, batch))):
        k, n = H.shape
        prob = DistKL.create(n, H=jnp.asarray(H, jnp.float32),
                             u=jnp.zeros((k,), jnp.float32))
        u = jnp.asarray(u_np, jnp.float32)
        route = prob.fleet_route(interpret)

        def cert(u_, prob=prob):
            s = prob.solve_certified_batch(u_, interpret=interpret)
            return s.x, s.duality_gap, s.ineq_res, s.eq_gap, s.stalled

        def f32(u_, prob=prob):
            return prob.solve_batch(u_, interpret=interpret).x

        ran, fn = compile_with_route(cert, u)
        if not interpret:
            check(ran == route, f"{name}: fleet_route() says {route!r}, "
                                f"compiled program runs {ran!r}")
        x, gap, ineq, eq, stalled = jax.block_until_ready(fn(u))
        ms = median_ms(fn, u)
        ms_f32 = median_ms(jax.jit(f32), u)
        x_ref = np.asarray(f64_reference(H, u_np))
        rec = {"route": route, "ms": ms, "ms_f32_solve": ms_f32,
               "ms_certify": ms - ms_f32,
               "inst_per_s": batch / (ms * 1e-3),
               "gap_absmax": float(np.max(np.abs(np.asarray(gap)))),
               "ineq_res_max": float(np.max(np.asarray(ineq))),
               "eq_res_max": float(np.max(np.asarray(eq))),
               "stalled": int(np.sum(np.asarray(stalled))),
               "x_err_max": float(np.max(np.abs(np.asarray(x) - x_ref)))}
        check(rec["gap_absmax"] <= 1e-8, f"{name} gap {rec}")
        check(rec["ineq_res_max"] <= 1e-10, f"{name} ineq {rec}")
        check(rec["eq_res_max"] <= 1e-10, f"{name} eq {rec}")
        check(rec["stalled"] == 0, f"{name} stalled {rec}")
        check(rec["x_err_max"] <= 1e-8, f"{name} x vs f64 reference {rec}")
        out[name] = rec
    return out


def qp_problem(n: int = 1000, m: int = 500, p: int = 10):
    """bench_scaling.py's dense QP: x0 = 0 is strictly feasible."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    dtype = jnp.float32
    ks = jax.random.split(jax.random.PRNGKey(2), 5)
    M = jax.random.normal(ks[0], (n, n), dtype) / float(np.sqrt(n))
    with jax.default_matmul_precision("highest"):
        P = M @ M.T + jnp.eye(n, dtype=dtype)
        z = jax.random.normal(ks[1], (n,), dtype)
        a = -(P @ z)
    G = jax.random.normal(ks[2], (m, n), dtype) / float(np.sqrt(n))
    h = jax.random.uniform(ks[3], (m,), dtype, 0.5, 1.5)
    A = jax.random.normal(ks[4], (p, n), dtype) / float(np.sqrt(n))
    b = jnp.zeros((p,), dtype)
    return P, a, G, h, A, b


def phase_qp(n: int = 1000, m: int = 500, p: int = 10) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cvx_tpu.models.qp import QP
    from cvx_tpu.solvers.types import SolverParams

    data = qp_problem(n, m, p)
    pars = SolverParams(tol=1e-7, mu=20.0, kkt_method="chol", kkt_refine=1)
    prob = QP.create(*data)
    x0 = jnp.zeros((n,), jnp.float32)
    fn = jax.jit(lambda q: q.solve_certified(x0, pars=pars, method="BR"))
    sol = jax.block_until_ready(fn(prob))
    ms = median_ms(fn, prob, reps=3)

    prob64 = QP.create(*(jnp.asarray(d, jnp.float64) for d in data))
    pars64 = SolverParams(tol=1e-10, mu=20.0)
    ref = jax.jit(lambda q: q.solve_jittable(
        jnp.zeros((n,), jnp.float64), "PD", pars64))(prob64)

    def f(x):
        P, a = (np.asarray(d, np.float64) for d in data[:2])
        return float(a @ x + 0.5 * x @ P @ x)

    f_sys, f_ref = f(np.asarray(sol.x)), f(np.asarray(ref.x))
    out = {"ms": ms, "newton_iters": int(sol.iters),
           "gap": float(sol.duality_gap),
           "ineq_res": float(sol.ineq_res), "eq_res": float(sol.eq_gap),
           "obj_rel_err": abs(f_sys - f_ref) / abs(f_ref)}
    check(out["obj_rel_err"] <= 1e-6, f"qp objective vs f64 PD {out}")
    check(bool(np.isfinite(out["gap"])) and not bool(sol.stalled),
          f"qp certificate {out}")
    return out


def phase_four(per_card: int = FLEET) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cvx_tpu import parallel
    from cvx_tpu.models import DistKL
    from cvx_tpu.parallel.schur import (SeparableProblem,
                                        make_sharded_schur_solver,
                                        separable_barrier_solve,
                                        separable_certify)
    from cvx_tpu.solvers.types import SolverParams

    nd = len(jax.devices())
    check(nd == 4, f"--four needs 4 devices, found {nd}")
    out = {}

    # dp: the certified KL fleet, 10,000 instances per card
    batch = nd * per_card
    H, u_np = flagship(batch)
    prob = DistKL.create(N, H=jnp.asarray(H, jnp.float32),
                         u=jnp.zeros((2,), jnp.float32))
    u = jnp.asarray(u_np, jnp.float32)
    mesh = parallel.instance_mesh(nd, axis="dp")

    def local(u_):
        s = prob.solve_certified_batch(u_)
        return s.x, s.duality_gap

    sharded = jax.jit(shard_map(local, mesh=mesh, in_specs=P("dp"),
                                out_specs=P("dp"), check_vma=False))
    u_sh = parallel.shard_batch(u, mesh, axis="dp")
    xs, gs = jax.block_until_ready(sharded(u_sh))
    ms4 = median_ms(sharded, u_sh)
    one = jax.jit(local)
    u1 = jax.device_put(u, jax.devices()[0])
    x1, _ = jax.block_until_ready(one(u1))
    ms1 = median_ms(one, u1)
    out["dp"] = {"batch": batch, "ms_4cards": ms4, "ms_1card": ms1,
                 "scaling_eff": ms1 / (nd * ms4),
                 "gap_absmax": float(jnp.max(jnp.abs(gs))),
                 "x_diff_max": float(np.max(np.abs(np.asarray(xs)
                                                   - np.asarray(x1))))}
    check(out["dp"]["x_diff_max"] <= 1e-12, f"dp sharded != one card {out}")
    check(out["dp"]["gap_absmax"] <= 1e-8, f"dp certificate {out}")

    # blocks: config 5, n = 9,984 in 64 blocks, Schur consensus
    dtype = jnp.float64
    K, nb, mb, p = 64, 156, 32, 8
    ks = jax.random.split(jax.random.PRNGKey(5), 4)
    eye = jnp.eye(nb, dtype=dtype)
    M = jax.random.normal(ks[0], (K, nb, nb), dtype) / float(np.sqrt(nb))
    Pm = jnp.einsum("kij,klj->kil", M, M, precision="highest") + eye[None]
    a = jax.random.normal(ks[1], (K, nb), dtype)
    G = jnp.tile(jnp.concatenate([eye, -eye], axis=0)[None],
                 (K, 1, 1))[:, :mb]
    ub = jnp.full((K, mb), 10.0, dtype)
    C = jax.random.normal(ks[2], (K, p, nb), dtype) / float(np.sqrt(nb))
    c = 0.1 * jax.random.normal(ks[3], (p,), dtype)
    sep = SeparableProblem(P=Pm, a=a, G=G, u=ub, C=C, c=c)
    pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
    x0 = jnp.zeros((K, nb), dtype)
    bmesh = parallel.block_mesh(nd, axis="blocks")
    solver = make_sharded_schur_solver(bmesh, axis="blocks")

    def run(kkt):
        def go(prob_):
            s = separable_barrier_solve(prob_, x0, pars, kkt_solver=kkt)
            cert = separable_certify(prob_, s.x, s.lam, s.nu)
            return s.x, cert.gap
        return jax.jit(go)

    run4, run1 = run(solver), run(None)
    x4, g4 = jax.block_until_ready(run4(sep))
    x1s, g1 = jax.block_until_ready(run1(sep))
    out["schur"] = {"n": K * nb, "blocks": K,
                    "ms_4cards": median_ms(run4, sep, reps=3),
                    "ms_1card": median_ms(run1, sep, reps=3),
                    "gap_4cards": float(g4), "gap_1card": float(g1),
                    "x_diff_max": float(jnp.max(jnp.abs(x4 - x1s)))}
    check(out["schur"]["x_diff_max"] <= 1e-8, f"schur sharded != local {out}")
    check(abs(out["schur"]["gap_4cards"]) <= 1e-8, f"schur gap {out}")

    sys.path.insert(0, str(HERE))
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(nd)
    out["dryrun_multichip"] = "ok"
    return out


def main(argv: list[str]) -> int:
    four = "--four" in argv
    sys.path.insert(0, str(HERE))
    import jax

    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU found (platform {dev['platform']!r})",
              file=sys.stderr)
        return 1
    import cvx_tpu

    if pathlib.Path(cvx_tpu.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: cvx_tpu must come from {HERE}, got "
              f"{cvx_tpu.__file__}", file=sys.stderr)
        return 1
    from cvx_tpu import backend

    backend.enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    name_power = card()
    log(f"device: {dev}  card: {name_power}  "
        f"compile cache: {backend.compile_cache_dir()}")

    phases = ([("four", phase_four)] if four else
              [("fleet", phase_fleet), ("certified", phase_certified),
               ("qp", phase_qp)])
    for name, fn in phases:
        t0 = time.perf_counter()
        res = fn()
        log(f"{name}: ok in {time.perf_counter() - t0:.1f}s "
            f"[{name_power}] {json.dumps(res)}")
    log(f"card: {name_power}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
