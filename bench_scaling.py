"""Scaling ladder on one NVIDIA GPU: the BASELINE.json metric ladder.

    python bench_scaling.py [--out FILE]   (default results/bench_scaling.json)

BASELINE.json's primary metric is "Newton iterations/s and KKT
factorizations/s (n = 100 / 1k / 10k)" plus the config ladder.  Groups
(each can be switched off with SCALE_<GROUP>=0):

  KL      batched KL solves at n = 100 / 1000 / 10000: the structured
          primal barrier (BR_fast) and the f32 fleet route
          (``DistKL.solve_batch``), a general-prior row, the dual dim 20
          XLA-only row, and the certified route split into f32 solve and
          f64 finish — every row with its measured certificate.
  PHASE1  fleet phase-I on a mixed feasible/infeasible family: the game
          screen at 2k and 10k lanes, the coupled ``feasibility_batch``
          and generic ``feasibility_analysis`` routes, and the certified
          route's stall flags.
  QP      config 3: the dense n = 1000 QP, and QP fleets finished by
          ``qp_certify``.
  SEP     config 5: the block-separable Schur-consensus QP (n = 9,984).
  CHOL    KKT factorize+solve at n = 1k-8k, one large Cholesky (XLA and
          ops/blocked_chol.py), batched small Cholesky, and the
          row-sharded TP Cholesky on a 1-device mesh.

Every time is the median of repeated warm runs, each closed with
``block_until_ready``.  Rows print as JSON lines and go, with a header
naming the device and the card, to a fresh file (never merged into an
older one).  Finds no GPU: exits 1.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as cs

# Published dense peaks per device kind: NVIDIA H100 data sheet (SXM part,
# no sparsity), at the full 700 W power limit.  A device missing here is
# an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "tf32_flops": 495e12,
                              "bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peak(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {kind!r}; add it "
                       "to bench_scaling.PEAKS with its source")
    return PEAKS[kind]


def timed(fn, *args, reps=5):
    """(median seconds per call, outputs as numpy) after one warm call."""
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], jax.tree_util.tree_map(np.asarray, out)


class Ladder:
    def __init__(self, out_path):
        dev = jax.devices()[0]
        self.kind = dev.device_kind
        self.out_path = out_path
        self.header = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices()), "card": cs.card()}
        self.records = [self.header]

    def add(self, rec):
        self.records.append(rec)
        print(json.dumps(rec), flush=True)

    def write(self):
        os.makedirs(os.path.dirname(self.out_path) or ".", exist_ok=True)
        with open(self.out_path, "w") as f:
            json.dump(self.records, f, indent=1)
        print(f"wrote {self.out_path} ({len(self.records)} records)",
              file=sys.stderr)


def _f32(H, u):
    return jnp.asarray(H, jnp.float32), jnp.asarray(u, jnp.float32)


def kl_group(lad):
    from cvx_tpu.diagnostics import kl_gap_certificate_np
    from cvx_tpu.models import DistKL
    from cvx_tpu.solvers import SolverParams

    for n, batch in ((100, 10000), (1000, 1000), (10000, 100)):
        H_np, u_np = cs.flagship(batch, n)
        H, u = _f32(H_np, u_np)
        prob = DistKL.create(n, H=H, u=jnp.zeros((2,), jnp.float32))

        # structured primal barrier from the analytic strictly feasible
        # start (weight pA + 0.05 on A)
        pars = SolverParams(tol=1e-8, mu=30.0, kkt_method="chol",
                            kkt_refine=1, max_iter=8)
        I_A = jnp.asarray(np.arange(n) < 3, jnp.float32)

        @jax.jit
        def structured(u_, H=H, I_A=I_A, n=n):
            def one(ui):
                w = -ui[0] + 0.05
                x0 = (w / 3) * I_A + ((1.0 - w) / (n - 3)) * (1.0 - I_A)
                s = DistKL.create(n, H=H, u=ui).solve_jittable(
                    x0, method="BR_fast", pars=pars)
                return s.x, s.iters
            return jax.vmap(one)(u_)

        sec, (xs, iters) = timed(structured, u, reps=3)
        lad.add({"metric": f"kl_batch_structured_n{n}", "batch": batch,
                 "value": batch / sec, "unit": "instances/s",
                 "ms_per_batch": sec * 1e3,
                 "newton_iters_per_s": float(np.sum(iters)) / sec,
                 "gap_cert_max": float(np.max(
                     kl_gap_certificate_np(xs, H_np, u_np)))})

        f32 = jax.jit(lambda u_, p=prob: p.solve_batch(u_).x)
        sec, xs = timed(f32, u)
        lad.add({"metric": f"kl_batch_fleet_n{n}", "batch": batch,
                 "route": prob.fleet_route(),
                 "value": batch / sec, "unit": "instances/s",
                 "ms_per_batch": sec * 1e3,
                 "gap_cert_max": float(np.max(
                     kl_gap_certificate_np(xs, H_np, u_np)))})

        cert = jax.jit(lambda u_, p=prob: p.solve_certified_batch(u_))
        sec_c, s = timed(cert, u)
        gaps = np.asarray(s.duality_gap)
        lad.add({"metric": f"kl_certified_1e8_n{n}", "batch": batch,
                 "route": prob.fleet_route(),
                 "value": batch / sec_c, "unit": "instances/s",
                 "ms_per_batch": sec_c * 1e3,
                 "ms_f32_solve": sec * 1e3,
                 "ms_certify": (sec_c - sec) * 1e3,
                 "gap_measured_maxabs": float(np.max(np.abs(gaps))),
                 "ineq_res_max": float(np.max(np.asarray(s.ineq_res))),
                 "contract_1e8": bool(np.max(np.abs(gaps)) <= 1e-8)})

    # general prior (shared log-prior row) at the flagship shape
    n, batch = 100, 10000
    H_np, u_np = cs.flagship(batch, n)
    H, u = _f32(H_np, u_np)
    p = np.exp(0.7 * np.random.default_rng(0).standard_normal(n))
    p = np.asarray(p / p.sum(), np.float32).astype(np.float64)
    prob = DistKL.create(n, H=H, u=jnp.zeros((2,), jnp.float32),
                         prior=jnp.asarray(p, jnp.float32))
    f32 = jax.jit(lambda u_: prob.solve_batch(u_).x)
    sec, xs = timed(f32, u)
    lad.add({"metric": f"kl_batch_fleet_prior_n{n}", "batch": batch,
             "route": prob.fleet_route(), "value": batch / sec,
             "unit": "instances/s", "ms_per_batch": sec * 1e3,
             "gap_cert_max": float(np.max(kl_gap_certificate_np(
                 xs, H_np, u_np, prior=np.asarray(prob.prior))))})

    # dual dim 20: beyond the kernel envelope, the XLA route only
    H_np, u_np = cs.wide(19, batch, n)
    H, u = _f32(H_np, u_np)
    prob = DistKL.create(n, H=H, u=jnp.zeros((19,), jnp.float32))
    f32 = jax.jit(lambda u_: prob.solve_batch(u_).x)
    sec, xs = timed(f32, u)
    lad.add({"metric": f"kl_batch_fleet_dim20_n{n}", "batch": batch,
             "route": prob.fleet_route(), "value": batch / sec,
             "unit": "instances/s", "ms_per_batch": sec * 1e3,
             "gap_cert_max": float(np.max(
                 kl_gap_certificate_np(xs, H_np, u_np)))})


def phase1_group(lad):
    from cvx_tpu.models import DistKL
    from cvx_tpu.solvers import SolverParams
    from cvx_tpu.solvers.phase1 import feasibility_analysis

    n = 100

    def mixed(batch, seed):
        # P(A) >= pA and P(A) <= qA, with qA < pA on every 10th instance
        rng = np.random.default_rng(seed)
        pA = rng.uniform(0.3, 0.5, batch)
        qA = pA + rng.uniform(0.05, 0.2, batch)
        bad = np.zeros(batch, bool); bad[::10] = True
        qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
        return jnp.asarray(np.stack([-pA, qA], axis=1), jnp.float32), bad

    I_A = np.zeros(n); I_A[:3] = 1.0
    H = jnp.asarray(np.stack([-I_A, I_A]), jnp.float32)
    prob0 = DistKL.create(n, H=H, u=jnp.zeros((2,), jnp.float32))

    for batch in (2000, 10000):
        u, bad = mixed(batch, 7)
        screen = jax.jit(lambda u_: prob0.feasibility_screen_batch(u_))
        sec, s = timed(screen, u)
        lad.add({"metric": f"phase1_screen_game_n{n}_B{batch}",
                 "batch": batch, "value": batch / sec,
                 "unit": "instances/s", "ms_per_batch": sec * 1e3,
                 "flags_exact": bool(np.array_equal(s.infeasible, bad)),
                 "undecided": int(np.sum(s.undecided))})

    # the coupled routes (one while_loop over all lanes) at 2k lanes, with
    # screening tolerances: the flag is the sign of s* against O(0.05)
    # margins
    batch = 2000
    u, bad = mixed(batch, 0)
    pars = SolverParams(tol=1e-6, max_iter=60)
    fleet = jax.jit(lambda u_: prob0.feasibility_batch(u_, pars))
    sec, (s_max, _) = timed(fleet, u, reps=3)
    lad.add({"metric": f"phase1_fleet_n{n}", "batch": batch,
             "value": batch / sec, "unit": "instances/s",
             "ms_per_batch": sec * 1e3,
             "flags_exact": bool(np.array_equal(s_max > 0.0, bad))})

    x_start = jnp.full((n,), 1.0 / n, jnp.float32)

    @jax.jit
    def generic(u_):
        def one(ui):
            prob = DistKL.create(n, H=H, u=ui)
            rep = feasibility_analysis(prob.inequalities, x_start, pars,
                                       prob.equalities)
            return rep.s_max
        return jax.vmap(one)(u_)

    sec, s_max = timed(generic, u, reps=3)
    lad.add({"metric": f"phase1_fleet_generic_n{n}", "batch": batch,
             "value": batch / sec, "unit": "instances/s",
             "ms_per_batch": sec * 1e3,
             "flags_exact": bool(np.array_equal(s_max > 0.0, bad))})

    mixed_cert = jax.jit(lambda u_: prob0.solve_certified_batch(u_))
    sec, s = timed(mixed_cert, u)
    gaps = np.asarray(s.duality_gap)
    lad.add({"metric": f"certified_mixed_fleet_n{n}", "batch": batch,
             "route": prob0.fleet_route(), "value": batch / sec,
             "unit": "instances/s", "ms_per_batch": sec * 1e3,
             "stall_flags_exact": bool(np.array_equal(s.stalled, bad)),
             "feasible_gap_max": float(np.max(np.abs(gaps[~bad])))})


def qp_group(lad):
    from cvx_tpu.models.qp import QP
    from cvx_tpu.solvers.types import SolverParams

    out = cs.phase_qp()
    lad.add({"metric": "qp_dense_n1000_certified", "value": out["ms"],
             "unit": "ms/solve", **out})

    for n, m, p, batch in ((128, 64, 4, 512), (512, 256, 8, 128),
                           (1000, 500, 10, 100)):
        ks = jax.random.split(jax.random.PRNGKey(n), 6)
        dtype = jnp.float32
        M = jax.random.normal(ks[0], (n, n), dtype) / float(np.sqrt(n))
        with jax.default_matmul_precision("highest"):
            P = M @ M.T + jnp.eye(n, dtype=dtype)
        G = jax.random.normal(ks[2], (m, n), dtype) / float(np.sqrt(n))
        A = jax.random.normal(ks[4], (p, n), dtype) / float(np.sqrt(n))
        b = jnp.zeros((p,), dtype)                      # x0 = 0 on Ax = b
        a_b = jax.random.normal(ks[1], (batch, n), dtype)
        ub_b = jax.random.uniform(ks[3], (batch, m), dtype, 0.5, 1.5)
        # max_iter=40: under vmap every lane pays the slowest lane's inner
        # iterations; a rare lane spins at the f32 resolution floor, and
        # its accuracy comes from qp_certify, not the f32 barrier tail
        pars = SolverParams(tol=1e-7, mu=20.0, kkt_method="chol",
                            kkt_refine=1, max_iter=40)
        x0 = jnp.zeros((n,), dtype)

        @jax.jit
        def solve(a_b, ub_b, P=P, G=G, A=A, b=b, pars=pars, x0=x0):
            def one(ai, ubi):
                prob = QP.create(P=P, a=ai, G=G, h=ubi, A=A, b=b)
                s = prob.solve_certified(x0, pars=pars, method="BR")
                return s.iters, s.duality_gap, s.ineq_res, s.eq_gap
            return jax.vmap(one)(a_b, ub_b)

        sec, (iters, gap, ineq, eq) = timed(solve, a_b, ub_b, reps=3)
        lad.add({"metric": f"qp_fleet_n{n}", "batch": batch,
                 "value": batch / sec, "unit": "instances/s",
                 "ms_per_batch": sec * 1e3,
                 "newton_iters_per_s": float(np.sum(iters)) / sec,
                 "gap_measured_max": float(np.max(np.abs(gap))),
                 "ineq_res_max": float(np.max(ineq)),
                 "eq_res_max": float(np.max(eq)),
                 "contract_1e8": bool(np.max(np.abs(gap)) <= 1e-8)})


def sep_group(lad):
    from cvx_tpu.parallel.schur import (SeparableProblem, separable_certify,
                                        separable_barrier_solve)
    from cvx_tpu.solvers.types import SolverParams

    dtype = jnp.float32
    K, nb, mb, p = 64, 156, 32, 8
    ks = jax.random.split(jax.random.PRNGKey(5), 4)
    eye = jnp.eye(nb, dtype=dtype)
    M = jax.random.normal(ks[0], (K, nb, nb), dtype) / float(np.sqrt(nb))
    P = jnp.einsum("kij,klj->kil", M, M, precision="highest") + eye[None]
    a = jax.random.normal(ks[1], (K, nb), dtype)
    G = jnp.tile(jnp.concatenate([eye, -eye], axis=0)[None],
                 (K, 1, 1))[:, :mb]
    u = jnp.full((K, mb), 10.0, dtype)
    C = jax.random.normal(ks[2], (K, p, nb), dtype) / float(np.sqrt(nb))
    c = 0.1 * jax.random.normal(ks[3], (p,), dtype)
    pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
    x0 = jnp.zeros((K, nb), dtype)

    @jax.jit
    def barrier(a_):
        prob = SeparableProblem(P=P, a=a_, G=G, u=u, C=C, c=c)
        return separable_barrier_solve(prob, x0, pars)

    @jax.jit
    def certified(a_):
        prob = SeparableProblem(P=P, a=a_, G=G, u=u, C=C, c=c)
        sol = separable_barrier_solve(prob, x0, pars)
        cert = separable_certify(prob, sol.x, sol.lam, sol.nu)
        return sol.iters, cert.gap, cert.ineq_res, cert.eq_res

    sec_b, _ = timed(barrier, a, reps=3)
    sec, (iters, gap, ineq, eq) = timed(certified, a, reps=3)
    lad.add({"metric": "separable_config5_n9984_64blocks",
             "value": sec * 1e3, "unit": "ms/solve (incl. certify)",
             "ms_barrier": sec_b * 1e3, "ms_certify": (sec - sec_b) * 1e3,
             "newton_iters": int(iters), "gap_measured": float(gap),
             "ineq_res": float(ineq), "eq_err": float(eq),
             "contract_1e8": bool(abs(float(gap)) <= 1e-8)})


def chol_group(lad):
    from cvx_tpu.ops.blocked_chol import cholesky_blocked
    from cvx_tpu.ops.kkt import kkt_solve
    from cvx_tpu.parallel.tp_chol import make_sharded_cholesky
    from jax.sharding import Mesh

    pk = peak(lad.kind)
    dtype = jnp.float32

    def spd(n, seed, batch=None):
        shape = (n, n) if batch is None else (batch, n, n)
        M = jax.random.normal(jax.random.PRNGKey(seed), shape, dtype) \
            / float(np.sqrt(n))
        with jax.default_matmul_precision("highest"):
            return (jnp.einsum("...ij,...kj->...ik", M, M)
                    + 2.0 * jnp.eye(n, dtype=dtype))

    with jax.default_matmul_precision("highest"):
        for n in (1024, 2048, 4096, 8192):
            p = 16
            H = spd(n, n)
            A = jax.random.normal(jax.random.PRNGKey(n + 1), (p, n),
                                  dtype) / float(np.sqrt(n))
            q = jnp.ones((n,), dtype)
            b = jnp.zeros((p,), dtype)
            fn = jax.jit(lambda H, A, q, b: kkt_solve(
                H, A, q, b, method="chol", refine=1)[2])
            sec, rr = timed(fn, H, A, q, b)
            flops = n ** 3 / 3 + 6 * n ** 2
            lad.add({"metric": f"kkt_factorize_solve_n{n}",
                     "value": 1.0 / sec, "unit": "factorizations/s",
                     "ms_per_solve": sec * 1e3, "relres": float(rr),
                     "share_of_f32_peak": flops / sec / pk["f32_flops"]})

        mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
        for n in (2048, 4096, 8192):
            H = spd(n, n)
            tp = make_sharded_cholesky(mesh, n, block=128)
            for meth, fn in (("xla", jnp.linalg.cholesky),
                             ("blocked", lambda A: cholesky_blocked(A,
                                                                    bk=512)),
                             ("tp1dev", tp)):
                run = jax.jit(fn)
                sec, L = timed(run, H, reps=3)
                Lh = np.tril(np.asarray(L, np.float64))
                idx = np.linspace(0, n - 1, 32).astype(int)
                err = float(np.max(np.abs(
                    Lh[idx] @ Lh.T - np.asarray(H, np.float64)[idx])))
                lad.add({"metric": f"chol_{meth}_n{n}",
                         "value": sec * 1e3, "unit": "ms/factorization",
                         "max_abs_err_sampled": err,
                         "share_of_f32_peak":
                             n ** 3 / 3 / sec / pk["f32_flops"]})

        for n, batch in ((128, 4096), (256, 1024), (512, 256)):
            Hb = spd(n, n, batch)
            sec, L = timed(jax.jit(jnp.linalg.cholesky), Hb)
            L0 = np.tril(np.asarray(L[0], np.float64))
            lad.add({"metric": f"batched_chol_n{n}_b{batch}",
                     "value": batch / sec, "unit": "factorizations/s",
                     "ms_per_batch": sec * 1e3,
                     "max_abs_err": float(np.max(np.abs(
                         L0 @ L0.T - np.asarray(Hb[0], np.float64))))})


GROUPS = (("KL", kl_group), ("PHASE1", phase1_group), ("QP", qp_group),
          ("SEP", sep_group), ("CHOL", chol_group))


def main(argv):
    out = argv[argv.index("--out") + 1] if "--out" in argv else \
        os.path.join("results", "bench_scaling.json")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_scaling: no GPU found (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from cvx_tpu import backend

    backend.enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    lad = Ladder(out)
    print(json.dumps(lad.header), flush=True)
    try:
        for name, group in GROUPS:
            if os.environ.get(f"SCALE_{name}", "1") == "1":
                group(lad)
    finally:
        lad.write()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
