"""``chip_smoke.py``'s phases, rehearsed on the CPU at tiny sizes (the fused
kernel in interpret mode): the same code paths, checks and result lines the
GPU run takes, so a broken phase shows up before any chip time is spent."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main(["--phases", "env"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_kernels_interpret(capsys):
    chip_smoke.phase_kernels(sizes=((4, 1500), (2, 1200)), interpret=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[kernels]")]
    assert len(lines) == 2 and all("ok=True" in ln for ln in lines)


def test_phase_ff():
    chip_smoke.phase_ff(n_dense=2048, n_stencil=3 * 2**12, reps=1)


def test_phase_mixed():
    out = chip_smoke.phase_mixed(n=2**8)
    assert out["kernel"]["rel"] < 1e-10 and out["xla"]["rel"] < 1e-10


def test_phase_flagship():
    chip_smoke.phase_flagship(n=2**7, small_n=2**6)


def test_phase_xl():
    chip_smoke.phase_xl(n_el=2**13)


def test_phase_sharded():
    chip_smoke.phase_sharded(n=2**9, n_devices=4)


def test_check_raises_phase_failure():
    with pytest.raises(chip_smoke.PhaseFailed, match="xl: bad"):
        chip_smoke.check("xl", False, "bad")
