"""Card-only checks: the fused multisweep compiled by Triton for the GPU (no
interpret mode) against the plain XLA sweeps.  They skip without a GPU;
``chip_smoke.py`` phase 2 runs the same comparison at full width."""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    return gpus[0]


@pytest.mark.parametrize("bs", [2, 4])
def test_compiled_multisweep_matches_xla(gpu, bs):
    import chip_smoke

    with jax.default_device(gpu):
        chip_smoke.phase_kernels(sizes=((bs, 1 << 16),), reps=1)


def test_float_float_defect_on_gpu(gpu):
    import chip_smoke

    with jax.default_device(gpu):
        chip_smoke.phase_ff(n_dense=1 << 16, n_stencil=3 << 16, reps=1)
