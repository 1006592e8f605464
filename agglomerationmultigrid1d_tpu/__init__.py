"""Deprecated import name of :mod:`agglomerationmultigrid1d`.

The package was renamed; this alias keeps old imports working.  Every
``<this name>.<sub>`` import resolves to the very module object of
``agglomerationmultigrid1d.<sub>`` (no second copy of any module, so types
and module state are shared), and importing it warns once.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

_NEW = "agglomerationmultigrid1d"
_OLD = __name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        self._spec = module.__spec__  # the import system overwrites it next
        return module

    def exec_module(self, module):
        module.__spec__ = self._spec


warnings.warn(
    f"'{_OLD}' is a deprecated name of '{_NEW}'; import '{_NEW}' instead",
    DeprecationWarning, stacklevel=2,
)
sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = importlib.import_module(_NEW)
