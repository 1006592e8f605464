"""The deprecated import name next to the package resolves to the package's
own module objects."""

import importlib
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALIASES = sorted(p.parent.name for p in ROOT.glob("agglomerationmultigrid1d_*/__init__.py"))


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_shares_module_objects(alias):
    code = f"""
import warnings
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    import {alias}.models.solvers as old
    from {alias}.ops.block_tridiag import BlockTridiag as OldBT
import agglomerationmultigrid1d as pkg
import agglomerationmultigrid1d.models.solvers as new
from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag
assert old is new and OldBT is BlockTridiag
assert importlib.import_module("{alias}") is pkg
assert new.__spec__.name == "agglomerationmultigrid1d.models.solvers"
assert any(issubclass(x.category, DeprecationWarning) for x in w)
"""
    subprocess.run([sys.executable, "-c", "import importlib\n" + code], cwd=ROOT, check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_alias_found():
    assert ALIASES, "no deprecated alias package next to the package"
    assert importlib.util.find_spec(ALIASES[0]) is not None
