"""agglomerationmultigrid1d — an agglomeration-multigrid framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
``mheinz757/AgglomerationMultigrid1D`` (pure-Julia, serial): high-order CG / DG /
agglomerated-DG discretizations of the 1D Poisson problem, inter-level transfer
operators, Jacobi / block-Jacobi / Schwarz smoothers, Galerkin coarse operators and a
multigrid V-cycle solver — all expressed as batched dense block tensors in a
structure-of-arrays layout (element axis last) instead of general sparse
matrices.

Design notes
------------
* Every operator in the 1D problem family is (block-)banded with a uniform block
  size (reference: ``src/dg_mesh.jl``, ``src/block_diagonal.jl``).  We therefore use
  three core operator formats (`ops`):
    - ``BlockDiag``     blocks ``(bs, bs, n)``           (mass matrices)
    - ``BlockTridiag``  diagonals ``3 x (bs, bs, n)``    (DG/agg G, D, C, A)
    - ``CgOperator``    overlapping element windows ``(n_el, p+1, p+1)`` plus the
      assembled scalar DIA band ``(2p+1, n_nodes)``      (CG mass/stiffness)
  The trailing axis is the element/node axis and is contiguous, so block
  matvecs and smoother sweeps become bandwidth-bound elementwise passes rather
  than tiny (<= 9x9) matrix products.
* Double precision is enabled by default for numerical parity with the reference
  (tolerances down to 1e-10 relative residuals).  Set
  ``AGGMG_NO_X64=1`` before import to keep JAX's default f32.
* Multi-device scaling lives in `parallel`: element-axis domain decomposition via
  ``jax.sharding.Mesh`` + ``shard_map``, one-block halo exchange with
  ``lax.ppermute``, ``psum`` norms, and replicated coarse solves.
"""

import os as _os

import jax as _jax

if not _os.environ.get("AGGMG_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

# On GPUs XLA may run f32 matmuls/einsums in TF32 (~3 decimal digits); every
# contraction here (transfers, Galerkin triple products, block matvecs) feeds
# a solver with 1e-10 relative-residual targets, where that noise makes the
# f32 V-cycle non-contractive.  Force true-f32 contractions (set
# AGGMG_FAST_MATMUL=1 to restore the backend default).
if not _os.environ.get("AGGMG_FAST_MATMUL"):
    _jax.config.update("jax_default_matmul_precision", "highest")


def _cpu_fingerprint() -> str:
    """Hash of the host CPU's model and feature flags.  JAX's cache key does
    NOT include the host's CPU features, so a CPU executable cached on another
    machine loads anyway and can SIGILL."""
    import hashlib
    import platform

    keys = ("flags", "Features", "CPU part", "model name")
    try:
        with open("/proc/cpuinfo") as f:
            stanza = []
            for line in f:
                if not line.strip():  # end of the first processor stanza
                    break
                stanza.append(line)
        picked = [ln for ln in stanza if ln.startswith(keys)] or stanza
        if picked:
            return hashlib.sha1("".join(picked).encode()).hexdigest()[:12]
    except OSError:
        pass
    return hashlib.sha1(platform.processor().encode()).hexdigest()[:12]


# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
# when it is unset, the cache lives at a fixed directory inside the checkout
# (``.jax_cache/``, git-ignored), one subdirectory per host CPU.
if not (_os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.environ.get("AGGMG_NO_COMPILE_CACHE")):
    _cache_dir = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
        _cpu_fingerprint(),
    )
    _os.makedirs(_cache_dir, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from . import numerics, mesh, ops, assembly, transfer, smoothers, models, parallel, utils  # noqa: E402,F401

__version__ = "0.1.0"
