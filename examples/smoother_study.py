"""Smoother analysis (mirrors tests/cg_smoother_test.jl).

(a) Richardson-with-smoother solve of -u'' = 1; (b) damping of sin(i pi x)
modes after 10 sweeps; (c) spectral radius of I - alpha S A.

Pass ``--plot [out.png]`` to also render the reference's MATLAB figures
(``cg_smoother_test.jl:83-126``) — the iteration-matrix spectrum in the complex
plane and the per-mode damping factors — to a file via matplotlib.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root


import numpy as np
import jax.numpy as jnp

from agglomerationmultigrid1d.assembly import cg_stiffness_and_rhs
from agglomerationmultigrid1d.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
from agglomerationmultigrid1d.models import iterative_smoother_solve, mode_damping, smoother_spectrum
from agglomerationmultigrid1d.models.hierarchy import CgLevel
from agglomerationmultigrid1d.smoothers import cg_smoother
from agglomerationmultigrid1d.utils import on_host


def plot_study(results, out_path):
    """Render the spectrum + mode-damping figures (the matplotlib counterpart
    of the reference's MATLAB session plots, cg_smoother_test.jl:83-126)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_spec, ax_damp) = plt.subplots(1, 2, figsize=(11, 4.5))
    theta = np.linspace(0, 2 * np.pi, 200)
    ax_spec.plot(np.cos(theta), np.sin(theta), color="0.8", lw=1, zorder=0)
    for kind, alpha, spec, damp in results:
        label = f"{kind} (alpha={alpha:.2f})"
        ax_spec.scatter(spec.real, spec.imag, s=14, label=label)
        ax_damp.semilogy(np.arange(1, len(damp) + 1), damp, marker="o", label=label)
    ax_spec.set_title("eig(I - alpha S A)")
    ax_spec.set_xlabel("Re")
    ax_spec.set_ylabel("Im")
    ax_spec.set_aspect("equal")
    ax_spec.legend(fontsize=8)
    ax_damp.set_title("damping of sin(i pi x) modes after 10 sweeps")
    ax_damp.set_xlabel("mode i")
    ax_damp.set_ylabel("||E^10 v_i|| / ||v_i||")
    ax_damp.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=140)
    print(f"wrote {out_path}")


def main(argv=None):
    argv = _sys.argv[1:] if argv is None else argv
    plot_path = None
    if argv and argv[0] == "--plot":
        plot_path = argv[1] if len(argv) > 1 else "smoother_study.png"

    results = []
    with on_host():
        cg = make_cg_mesh(create_uniform_mesh(16, 0.0, 1.0), 2)
        bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
        a, f = cg_stiffness_and_rhs(cg, lambda x: jnp.ones_like(x), bc)
        for kind, alpha in [("jac", 2 / 3), ("addSchwarz", 1 / 3), ("hybridSchwarz", 2 / 3)]:
            level = CgLevel(a=a, smoother=cg_smoother(a, kind))
            res = iterative_smoother_solve(level, jnp.zeros_like(f), f,
                                           maxiter=20000, tol=1e-8, alpha=alpha)
            print(f"{kind:15s}: {int(res.iterations)} Richardson iterations")
            spec = smoother_spectrum(level, alpha)
            damp = mode_damping(level, modes=8, sweeps=10, alpha=alpha)
            print(f"{'':15s}  spectral radius {np.abs(spec[0]):.4f}; "
                  f"mode damping (i=1..8): {np.array2string(damp, precision=3)}")
            results.append((kind, alpha, spec, damp))

    if plot_path is not None:
        plot_study(results, plot_path)


if __name__ == "__main__":
    main()
