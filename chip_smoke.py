"""Smoke test of the multigrid solvers on one NVIDIA GPU, through the public
entry points, at the sizes users of this solver run.

    python chip_smoke.py               # phases env .. xl on one card
    python chip_smoke.py --chips 4     # only the sharded phase, on 4 cards

Phases, in order, each printing one result line before the next starts:

1. env      — JAX version, device, card name and power limit, compile cache,
              whether the native host helper loaded;
2. kernels  — every fused smoother kernel against the plain ``jax.numpy``
              sweeps (``bt_matvec`` + ``apply_smoother``) at bs = 4, n = 2^22
              (DG p = 3) and bs = 2, n = 3 * 2^24 (the north-star fine level),
              with the kernel and XLA times side by side;
3. ff       — the float-float defect against a true f64 defect on the card,
              fenced and unfenced (``ops.df64.FENCE_EFT``);
4. mixed    — ``multigrid_mixed`` on the 2.1M-DoF DG chain to 1e-10, with the
              default kernel route and with ``use_pallas=False``;
5. flagship — BASELINE config 5's CG-topped chain to 1e-10 with f64
              ``multigrid`` and ``multigrid_mixed``;
6. xl       — the north star: ``multigrid_true`` on the 1.007e8-DoF DG p = 1
              chain to 1e-8.

Every residual is checked with an f64 defect.  ``--chips 4`` runs only the
sharded phase: the phase-4 problem on a 4-device mesh (``fused_shard_spec``)
against the same solves and the same f32 V-cycle on one of the cards.  A failed phase makes the script
exit non-zero; it never falls back to the CPU.  The last line is one JSON
object ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PHASES = ("env", "kernels", "ff", "mixed", "flagship", "xl")


class PhaseFailed(RuntimeError):
    pass


def line(phase: str, **fields) -> None:
    parts = []
    for k, v in fields.items():
        if isinstance(v, float):
            v = f"{v:.3e}" if (v != 0 and (abs(v) < 1e-3 or abs(v) >= 1e5)) else f"{v:.4g}"
        parts.append(f"{k}={v}")
    print(f"[{phase}] " + " ".join(parts), flush=True)


def check(phase: str, cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(f"{phase}: {what}")


def card_info() -> list[str]:
    """``name, power.limit`` per card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _timed(fn, *args, reps: int = 10) -> float:
    """Seconds per call, after one warm-up call (compile excluded)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def _rel(got, want) -> float:
    """max |got - want| / max |want|, reduced on the device."""
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))


def random_system(key, bs: int, n: int):
    """Diagonally dominant f32 block-tridiagonal system with the exact
    block-Jacobi inverse, generated on the device."""
    import jax
    import jax.numpy as jnp

    from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag

    k = jax.random.split(key, 5)
    f32 = jnp.float32
    q = jax.random.normal(k[0], (bs, bs, n), f32)
    q = q / jnp.sqrt(jnp.sum(q * q, axis=(0, 1), keepdims=True))
    diag = 8.0 * jnp.eye(bs, dtype=f32)[:, :, None] + q
    lower = (0.25 * jax.random.normal(k[1], (bs, bs, n), f32)).at[:, :, 0].set(0.0)
    upper = (0.25 * jax.random.normal(k[2], (bs, bs, n), f32)).at[:, :, -1].set(0.0)
    if bs == 2:  # closed form: a batched LU over 5e7 tiny blocks is slow
        det = diag[0, 0] * diag[1, 1] - diag[0, 1] * diag[1, 0]
        inv = jnp.stack([
            jnp.stack([diag[1, 1], -diag[0, 1]]), jnp.stack([-diag[1, 0], diag[0, 0]])
        ]) / det
    else:
        inv = jnp.moveaxis(jnp.linalg.inv(jnp.moveaxis(diag, -1, 0)), 0, -1)
    x = jax.random.normal(k[3], (bs, n), f32)
    b = jax.random.normal(k[4], (bs, n), f32)
    return BlockTridiag(lower=lower, diag=diag, upper=upper), inv, x, b


def phase_env(cards: list[str]) -> dict:
    import jax

    from agglomerationmultigrid1d.ops.native import have_native

    dev = jax.devices()[0]
    cache = jax.config.jax_compilation_cache_dir
    line(
        "env", jax=jax.__version__, platform=dev.platform, kind=repr(dev.device_kind),
        count=len(jax.devices()), card=repr(cards[0] if cards else None),
        matmul_precision=jax.config.jax_default_matmul_precision,
        compile_cache=cache, native_helper=have_native(),
    )
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def phase_kernels(sizes=((4, 1 << 22), (2, 3 << 24)), card: str = "", interpret=False,
                  reps: int = 10) -> None:
    """Each fused kernel vs the plain jnp sweeps; kernel and XLA times."""
    import jax
    import jax.numpy as jnp

    from agglomerationmultigrid1d.ops.block_tridiag import block_mul, bt_matvec
    from agglomerationmultigrid1d.ops.pallas import (
        chebyshev_coefficients,
        pallas_block_jacobi_multisweep,
        pallas_chebyshev_multisweep,
    )
    from agglomerationmultigrid1d.parallel import make_solver_mesh, sharded_multisweep
    from agglomerationmultigrid1d.smoothers.smoother import (
        BlockJacobiSmoother,
        apply_smoother,
    )

    tol_x, tol_r = 3e-5, 3e-4
    coef = chebyshev_coefficients(0.2, 2.0, 3)

    @jax.jit
    def ref_jacobi(a, inv, x, b):
        sm = BlockJacobiSmoother(inv=inv)
        for _ in range(3):
            x = x + apply_smoother(sm, b - bt_matvec(a, x), alpha=2.0 / 3.0)
        return x, b - bt_matvec(a, x)

    @jax.jit
    def ref_cheb(a, inv, x, b):
        d = jnp.zeros_like(x)
        for s in range(3):
            z = jnp.einsum("ijn,jn->in", inv, b - bt_matvec(a, x))
            d = coef[s, 0] * d + coef[s, 1] * z
            x = x + d
        return x, b - bt_matvec(a, x)

    mesh = make_solver_mesh(1)
    for bs, n in sizes:
        a, inv, x, b = random_system(jax.random.PRNGKey(bs), bs, n)
        ml, mu = block_mul(inv, a.lower), block_mul(inv, a.upper)
        jac = jax.jit(lambda a, i, ml, mu, x, b: pallas_block_jacobi_multisweep(
            a, i, x, b, n_sweeps=3, emit_residual=True, ml=ml, mu=mu, interpret=interpret))
        jac_x = jax.jit(lambda a, i, ml, mu, x, b: pallas_block_jacobi_multisweep(
            a, i, x, b, n_sweeps=3, ml=ml, mu=mu, interpret=interpret))
        cheb = jax.jit(lambda a, i, ml, mu, x, b: pallas_chebyshev_multisweep(
            a, i, x, b, coef, 3, emit_residual=True, ml=ml, mu=mu, interpret=interpret))
        shard = jax.jit(lambda a, i, ml, mu, x, b: sharded_multisweep(
            mesh, "x", a, i, x, b, n_sweeps=3, emit_residual=True, ml=ml, mu=mu,
            interpret=interpret))
        args = (a, inv, ml, mu, x, b)
        xr, rr = ref_jacobi(a, inv, x, b)
        xc, rc = ref_cheb(a, inv, x, b)
        errs = {}
        got = jac(*args)
        errs["jacobi_x"], errs["jacobi_r"] = _rel(got[0], xr), _rel(got[1], rr)
        errs["jacobi_noresid_x"] = _rel(jac_x(*args), xr)
        got = cheb(*args)
        errs["cheb_x"], errs["cheb_r"] = _rel(got[0], xc), _rel(got[1], rc)
        got = shard(*args)
        errs["ghosted_x"], errs["ghosted_r"] = _rel(got[0], xr), _rel(got[1], rr)
        del got
        ok = all(v < (tol_r if k.endswith("_r") else tol_x) for k, v in errs.items())
        times = {}
        if not interpret:
            times["jacobi_kernel_ms"] = 1e3 * _timed(jac, *args, reps=reps)
            times["jacobi_xla_ms"] = 1e3 * _timed(ref_jacobi, a, inv, x, b, reps=reps)
            times["cheb_kernel_ms"] = 1e3 * _timed(cheb, *args, reps=reps)
            times["cheb_xla_ms"] = 1e3 * _timed(ref_cheb, a, inv, x, b, reps=reps)
            # one XLA matvec against a plain copy of as many bytes
            mv = jax.jit(bt_matvec)
            mv_bytes = (3 * bs * bs + 2 * bs) * n * 4
            buf = jnp.ones((mv_bytes // 8,), jnp.float32)
            cp = jax.jit(lambda v: v + 1.0)
            t_mv, t_cp = _timed(mv, a, x, reps=reps), _timed(cp, buf, reps=reps)
            times["matvec_gbps"] = mv_bytes / t_mv / 1e9
            times["copy_gbps"] = mv_bytes / t_cp / 1e9
            del buf
        line("kernels", bs=bs, n=n, ok=ok, tol_x=tol_x, tol_r=tol_r,
             operands="f32", matmul_precision=jax.config.jax_default_matmul_precision,
             **{f"err_{k}": v for k, v in errs.items()}, **times,
             card=repr(card) if times else None)
        check("kernels", ok, f"bs={bs} n={n} errors {errs}")
        del a, inv, x, b, ml, mu, args, xr, rr, xc, rc


def _traced_with_fences(fenced: bool, fn, *args):
    """``jax.jit(fn)`` traced (and run once) with ``FENCE_EFT = fenced``."""
    import jax

    from agglomerationmultigrid1d.ops import df64

    old = df64.FENCE_EFT
    df64.FENCE_EFT = fenced
    try:
        jitted = jax.jit(lambda *a: fn(*a))  # fresh closure: read at trace time
        return jitted, jitted(*args)
    finally:
        df64.FENCE_EFT = old


def phase_ff(n_dense: int = 1 << 22, n_stencil: int = 3 << 24, card: str = "",
             reps: int = 5) -> None:
    """Float-float defects (dense bs = 4, the bs = 2 north-star stencil, and
    a p = 8 CG band) vs the true f64 defect on the device, fenced and
    unfenced."""
    import jax
    import jax.numpy as jnp

    from agglomerationmultigrid1d.ops import df64
    from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag, bt_matvec
    from agglomerationmultigrid1d.ops.df64 import BTFFStencil, bt_split, ff_split

    tol = 1e-10
    key = jax.random.PRNGKey(3)
    a, _, x, b = random_system(key, 4, n_dense)
    k = jax.random.split(key, 4)
    # f64 operator with a nonzero lo part; x with a nonzero lo part
    a64 = BlockTridiag(*(
        m.astype(jnp.float64) * (1.0 + 1e-9 * jax.random.normal(kk, m.shape, jnp.float64))
        for m, kk in zip(a, k[:3])
    ))
    x64 = x.astype(jnp.float64) * (1.0 + 1e-9)
    b64 = b.astype(jnp.float64)
    r64 = jax.jit(lambda a, x, b: b - bt_matvec(a, x))(a64, x64, b64)
    a_ff, xf, bf = bt_split(a64), ff_split(x64), ff_split(b64)
    del a, x, b, a64

    # stencil operator (the north-star fine level): bs = 2, bw boundary columns
    bs, bw = 2, 4

    def blocks(kk, w, scale):
        ks = jax.random.split(kk, 3)
        return BlockTridiag(*(scale * jax.random.normal(q, (bs, bs, w), jnp.float64)
                              for q in ks))

    ks = jax.random.split(k[3], 6)
    mid = blocks(ks[0], 1, 1.0)
    mid = mid._replace(diag=mid.diag + 8.0 * jnp.eye(bs)[:, :, None])
    left, right = blocks(ks[1], bw, 1.0), blocks(ks[2], bw, 1.0)
    split = lambda t: (bt_split(t).hi, bt_split(t).lo)  # noqa: E731
    (hl, ll), (hm, lm), (hr, lr) = split(left), split(mid), split(right)
    st = BTFFStencil(hi_left=hl, hi_mid=hm, hi_right=hr, lo_left=ll, lo_mid=lm,
                     lo_right=lr, n=n_stencil)
    xs64 = jax.random.normal(ks[3], (bs, n_stencil), jnp.float64)
    bs64 = jax.random.normal(ks[4], (bs, n_stencil), jnp.float64)
    xs, bs_ = ff_split(xs64), ff_split(bs64)

    def materialized(sel):  # the stencil's exact f64 values, full length
        m = jnp.broadcast_to(sel(mid), (bs, bs, n_stencil))
        m = m.at[..., :bw].set(sel(left))
        return m.at[..., n_stencil - bw:].set(sel(right))

    a_st = BlockTridiag(*(materialized(lambda t, f=f: getattr(t, f))
                          for f in ("lower", "diag", "upper")))
    rs64 = jax.jit(lambda a, x, b: b - bt_matvec(a, x))(
        a_st, xs.hi.astype(jnp.float64) + xs.lo.astype(jnp.float64),
        bs_.hi.astype(jnp.float64) + bs_.lo.astype(jnp.float64))
    del a_st

    # CG band (p = 8: 17 diagonals) on n_dense nodes, split from f64
    from agglomerationmultigrid1d.ops.shifts import shift

    p = 8
    kc = jax.random.split(k[3], 3)
    band64 = jax.random.normal(kc[0], (2 * p + 1, n_dense), jnp.float64)
    xc64 = jax.random.normal(kc[1], (n_dense,), jnp.float64)
    bc64 = jax.random.normal(kc[2], (n_dense,), jnp.float64)
    rc64 = jax.jit(lambda band, x, b: b - sum(
        band[o + p] * shift(x, o) for o in range(-p, p + 1)))(band64, xc64, bc64)
    cg_ff, xc, bc = df64.cg_band_split(band64), ff_split(xc64), ff_split(bc64)

    def err(r_ff, ref, scale):
        v = r_ff.hi.astype(jnp.float64) + r_ff.lo.astype(jnp.float64)
        return float(jnp.max(jnp.abs(v - ref)) / scale)

    cases = {
        "dense": (df64.ff_bt_defect, (a_ff, xf, bf), r64, b64),
        "stencil": (df64.ff_bt_defect_stencil, (st, xs, bs_), rs64, bs64),
        "cg": (df64.ff_cg_defect, (cg_ff, xc, bc), rc64, bc64),
    }
    # the true-f64 stencil defect multigrid_true's outer loop uses
    res = {"stencil_f64_err": err(jax.jit(df64.f64_bt_defect_stencil)(st, xs, bs_), rs64,
                                  float(jnp.max(jnp.abs(bs64))))}
    for fenced in (True, False):
        tag = "fenced" if fenced else "unfenced"
        for name, (fn, args, ref, bref) in cases.items():
            jitted, r_ff = _traced_with_fences(fenced, fn, *args)
            res[f"{name}_{tag}_err"] = err(r_ff, ref, float(jnp.max(jnp.abs(bref))))
            res[f"{name}_{tag}_ms"] = 1e3 * _timed(jitted, *args, reps=reps)
    in_use = "fenced" if df64.FENCE_EFT else "unfenced"
    ok = res["stencil_f64_err"] < tol and all(res[f"{name}_{in_use}_err"] < tol for name in cases)
    line("ff", n_dense=n_dense, n_stencil=n_stencil, tol=tol, in_use=in_use, ok=ok,
         **res, card=repr(card))
    check("ff", ok, f"{in_use} float-float defect error above {tol}: {res}")


def _f64_rel(h, x, b) -> float:
    """||b - A x|| / ||b|| with the f64 fine operator."""
    import jax
    import jax.numpy as jnp

    from agglomerationmultigrid1d.models.solvers import _flatten_level_vec, level_matvec

    @jax.jit
    def rel(h, x, b):
        r = b - level_matvec(h.levels[0], x.astype(jnp.float64))
        return jnp.linalg.norm(_flatten_level_vec(r)) / jnp.linalg.norm(_flatten_level_vec(b))

    return float(rel(h, x, b))


def _solve_twice(fn):
    """(result, steady seconds): the first call compiles."""
    import jax

    jax.block_until_ready(fn().x)
    t0 = time.perf_counter()
    res = fn()
    jax.block_until_ready(res.x)
    return res, time.perf_counter() - t0


def dg_problem(n: int):
    from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy

    return poisson_dg_hierarchy(n=n, max_p=3, n_dg=2, n_agg=max(int(np.log2(n // 4)) - 5, 1))


def phase_mixed(n: int = 1 << 19, card: str = "", tol: float = 1e-10) -> dict:
    import jax.numpy as jnp

    from agglomerationmultigrid1d.models.solvers import (
        make_low_precision_hierarchy,
        multigrid_mixed,
    )

    t0 = time.perf_counter()
    prob = dg_problem(n)
    setup_s = time.perf_counter() - t0
    h, b = prob.hierarchy, prob.b
    h32 = make_low_precision_hierarchy(h)
    out = {}
    for tag, kw in (("kernel", {}), ("xla", {"use_pallas": False})):
        res, dt = _solve_twice(
            lambda: multigrid_mixed(h, h32, jnp.zeros_like(b), b, 80, tol, **kw)
        )
        rel = _f64_rel(h, res.x, b)
        out[tag] = dict(iterations=int(res.iterations), cycles=int(res.inner_cycles),
                        rel=rel, s=dt)
    ok = all(v["rel"] < tol for v in out.values())
    line("mixed", dof=int(b.size), levels=h.n_levels, host_setup_s=setup_s, tol=tol, ok=ok,
         **{f"{t}_{k}": v for t, d in out.items() for k, v in d.items()}, card=repr(card))
    check("mixed", ok, f"f64-checked residuals {out}")
    return out


def phase_flagship(n: int = 1 << 16, small_n: int = 1 << 8, card: str = "",
                   tol: float = 1e-10) -> None:
    """CG-topped chain (p = 8, 4, 2, 1 + agglomerated levels, CDir = 1000 n,
    Neumann left / Dirichlet right) with f64 ``multigrid`` and
    ``multigrid_mixed``; the f64 cycle count is compared with the same solve
    on the CPU backend at ``small_n`` (the reference is h-independent)."""
    import jax
    import jax.numpy as jnp

    from agglomerationmultigrid1d.models.problems import poisson_full_hierarchy
    from agglomerationmultigrid1d.models.solvers import (
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
    )

    t0 = time.perf_counter()
    prob = poisson_full_hierarchy(n=n)
    setup_s = time.perf_counter() - t0
    h, b = prob.hierarchy, prob.b
    r64, dt64 = _solve_twice(
        lambda: multigrid(h, jnp.zeros_like(b), b, 100, tol, compute_error=False)
    )
    h32 = make_low_precision_hierarchy(h)
    rmx, dtmx = _solve_twice(lambda: multigrid_mixed(h, h32, jnp.zeros_like(b), b, 100, tol))
    rel64, relmx = _f64_rel(h, r64.x, b), _f64_rel(h, rmx.x, b)

    cpu = jax.local_devices(backend="cpu")[0]
    small = poisson_full_hierarchy(n=small_n)
    hs, bs = jax.device_put((small.hierarchy, small.b), cpu)
    with jax.default_device(cpu):
        rs = multigrid(hs, jnp.zeros_like(bs), bs, 100, tol, compute_error=False)
    cycles, cycles_small = int(r64.iterations), int(rs.iterations)
    ok = rel64 < tol and relmx < tol and cycles == cycles_small
    line("flagship", dof=int(b.size), levels=h.n_levels, host_setup_s=setup_s, tol=tol,
         ok=ok, f64_cycles=cycles, f64_rel=rel64, f64_s=dt64,
         mixed_iterations=int(rmx.iterations), mixed_cycles=int(rmx.inner_cycles),
         mixed_rel=relmx, mixed_s=dtmx, cpu_small_n=small_n, cpu_f64_cycles=cycles_small,
         card=repr(card))
    check("flagship", ok, f"rel64={rel64} relmx={relmx} cycles {cycles} vs cpu {cycles_small}")


def phase_xl(n_el: int = 3 << 24, card: str = "", tol: float = 1e-8) -> None:
    """The north star, exactly as ``examples/xl_north_star.py`` runs it."""
    import jax

    from agglomerationmultigrid1d.models import multigrid_true
    from agglomerationmultigrid1d.models.stencil_setup import build_xl_problem
    from agglomerationmultigrid1d.utils.config import HierarchySpec

    n_agg = max(int(np.ceil(np.log2(max(n_el / 12288, 4)) / 2)), 1)
    spec = HierarchySpec(
        cg_orders=(), dg_orders=(1,), n_agg_levels=n_agg, p_agg=1,
        agg_factor=4, c_dir=1000.0 * n_el,
    )
    t0 = time.perf_counter()
    h32, ffops, b_ff, norm_b = build_xl_problem(spec, n_el, slim_fine=True, ff_levels=True)
    jax.block_until_ready(h32.levels[0].a)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = multigrid_true(h32, ffops, b_ff, norm_b, maxiter=40, tol=tol)
    jax.block_until_ready(res.x)
    solve_s = time.perf_counter() - t0
    it = int(res.iterations)
    # the outer defect of multigrid_true is the true-f64 stencil defect
    rel = float(np.asarray(res.res_history)[it - 1]) / norm_b if it else float("inf")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    ok = rel < tol
    line("xl", dof=2 * n_el, levels=h32.n_levels, setup_s=setup_s,
         solve_incl_compile_s=solve_s, cycles=it, rel=rel, tol=tol, ok=ok,
         peak_bytes_in_use=peak, card=repr(card))
    check("xl", ok, f"relative residual {rel} after {it} cycles")


def phase_sharded(n: int = 1 << 19, n_devices: int = 4, cards: list[str] | None = None,
                  tol: float = 1e-10, contraction_rtol: float = 1e-3) -> None:
    """The phase-4 problem on an ``n_devices`` mesh (``fused_shard_spec``) vs
    the same solves on one device, in one process.

    - f64 ``multigrid``: the same iteration count, and the residual history
      within 1e-8 of its scale.
    - The f32 inner V-cycle of ``multigrid_mixed`` (the ghosted fused kernel,
      and the XLA halo sweeps with ``use_pallas=False``): one cycle from zero
      on ``r = b`` must contract the residual ``||r - A e|| / ||r||`` on the
      mesh as on one device, within ``contraction_rtol``.  A wrong ghost or
      halo changes that factor by orders of magnitude; f32 rounding moved it
      by at most 7.6e-5 (4 CPU devices, n up to 2^18).
    - ``multigrid_mixed`` on both routes must reach ``tol`` on the mesh and
      on one device, checked in f64.  Its outer count and history are
      printed, not compared: they follow the f32 rounding of the compiled
      program, which the mesh changes (one f32 V-cycle's output moves by
      2.6e-3 between mesh and one device on the CPU at n = 2^18, and by
      7e-2 under a 1e-7 perturbation of its input).  On one H100 a fresh
      compile of the same single-device call already moved the XLA route
      from 21 to 22 outer steps.
    """
    import jax
    import jax.numpy as jnp

    from agglomerationmultigrid1d.models.solvers import (
        _flatten_level_vec,
        level_matvec,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        v_cycle,
    )
    from agglomerationmultigrid1d.parallel import (
        fused_shard_spec,
        make_solver_mesh,
        shard_hierarchy,
    )
    from agglomerationmultigrid1d.parallel.distributed import shard_vector

    check("sharded", len(jax.devices()) >= n_devices,
          f"{n_devices} devices needed, {len(jax.devices())} visible")
    prob = dg_problem(n)
    h, b = prob.hierarchy, prob.b
    h32 = make_low_precision_hierarchy(h)
    mesh = make_solver_mesh(n_devices)
    hs = shard_hierarchy(h, mesh)
    hs32 = shard_hierarchy(h32, mesh)
    bsh = shard_vector(b, mesh)
    spec64, spec32 = fused_shard_spec(hs, mesh), fused_shard_spec(hs32, mesh)
    out, ok = {}, True

    r1, t1 = _solve_twice(lambda: multigrid(h, jnp.zeros_like(b), b, 80, tol,
                                            compute_error=False))
    r4, t4 = _solve_twice(lambda: multigrid(hs, jnp.zeros_like(bsh), bsh, 80, tol,
                                            compute_error=False, shard=spec64))
    it1, it4 = int(r1.iterations), int(r4.iterations)
    h1 = np.asarray(r1.res_history)[:it1]
    h4 = np.asarray(r4.res_history)[:it4]
    # rtol against the history's scale: entry-wise relative differences grow
    # as the residual falls toward the f64 evaluation noise floor
    hist_dev = float(np.max(np.abs(h4 - h1)) / np.max(h1)) if it1 == it4 else float("nan")
    rel1, rel4 = _f64_rel(h, r1.x, b), _f64_rel(h, jax.device_put(r4.x, jax.devices()[0]), b)
    ok &= it1 == it4 and hist_dev < 1e-8 and max(rel1, rel4) < tol
    out.update(f64_it_1=it1, f64_it_mesh=it4, f64_hist_dev=hist_dev, f64_rel_1=rel1,
               f64_rel_mesh=rel4, f64_s_1=t1, f64_s_mesh=t4)

    vc = jax.jit(v_cycle, static_argnames=("use_pallas", "shard"))

    @jax.jit
    def contraction(hh, e, r):
        def nrm(v):
            return jnp.sqrt(jnp.sum(jnp.square(_flatten_level_vec(v).astype(jnp.float64))))

        return nrm(r - level_matvec(hh.levels[0], e)) / nrm(r)

    r32 = b.astype(jnp.float32)
    r32s = shard_vector(r32, mesh)
    for route, up in (("kernel", True), ("xla", False)):
        c1 = float(contraction(h32, vc(h32, jnp.zeros_like(r32), r32, use_pallas=up), r32))
        c4 = float(contraction(hs32, vc(hs32, jnp.zeros_like(r32s), r32s, use_pallas=up,
                                        shard=spec32), r32s))
        dev = abs(c4 - c1) / c1
        ok &= dev < contraction_rtol
        out.update({f"vcycle_{route}_contraction_1": c1,
                    f"vcycle_{route}_contraction_mesh": c4,
                    f"vcycle_{route}_contraction_dev": dev})

        kw = {} if up else {"use_pallas": False}
        m1, s1 = _solve_twice(lambda: multigrid_mixed(h, h32, jnp.zeros_like(b), b, 80, tol, **kw))
        m4, s4 = _solve_twice(lambda: multigrid_mixed(hs, hs32, jnp.zeros_like(bsh), bsh, 80,
                                                      tol, shard=spec32, **kw))
        i1, i4 = int(m1.iterations), int(m4.iterations)
        g1 = np.asarray(m1.res_history)[:i1]
        g4 = np.asarray(m4.res_history)[:i4]
        k = min(i1, i4)
        mrel1 = _f64_rel(h, m1.x, b)
        mrel4 = _f64_rel(h, jax.device_put(m4.x, jax.devices()[0]), b)
        ok &= max(mrel1, mrel4) < tol
        out.update({f"mixed_{route}_it_1": i1, f"mixed_{route}_it_mesh": i4,
                    f"mixed_{route}_hist_entry_maxrel": float(np.max(np.abs(g4[:k] - g1[:k])
                                                                     / g1[:k])),
                    f"mixed_{route}_rel_1": mrel1, f"mixed_{route}_rel_mesh": mrel4,
                    f"mixed_{route}_s_1": s1, f"mixed_{route}_s_mesh": s4})
    line("sharded", dof=int(b.size), devices=n_devices, fused_levels=sum(spec32[2]), tol=tol,
         contraction_rtol=contraction_rtol, ok=ok, **out, cards=repr(cards))
    check("sharded", ok, f"sharded vs single mismatch {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase on a 4-card mesh")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of phases to run (default: all)")
    args = ap.parse_args(argv)

    try:
        import jax

        import agglomerationmultigrid1d  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the solver package: {e}", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})", file=sys.stderr)
        return 3
    cards = card_info()
    device = phase_env(cards)
    card = cards[0]
    try:
        if args.chips == 4:
            phase_sharded(n_devices=4, cards=cards[:4])
        else:
            for p in args.phases.split(","):
                if p == "kernels":
                    phase_kernels(card=card)
                elif p == "ff":
                    phase_ff(card=card)
                elif p == "mixed":
                    phase_mixed(card=card)
                elif p == "flagship":
                    phase_flagship(card=card)
                elif p == "xl":
                    phase_xl(card=card)
                elif p != "env":
                    raise PhaseFailed(f"unknown phase {p!r}")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED {e}", file=sys.stderr)
        return 1
    print("; ".join(cards[: args.chips]))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
