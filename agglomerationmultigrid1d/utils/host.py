"""Host-side setup execution.

Hierarchy construction is thousands of tiny eager array ops; dispatching those
to an accelerator one by one pays a launch and a compilation per op.  All setup
therefore runs on the JAX CPU backend and only the finished operator pytrees
are transferred to the accelerator — mirroring how the reference does all
assembly in plain serial Julia before the solve.  So the CPU backend must be
available beside the accelerator (do not set ``JAX_PLATFORMS`` to the
accelerator alone).
"""

from __future__ import annotations

import contextlib
import functools

import jax


def cpu_device():
    return jax.local_devices(backend="cpu")[0]


@contextlib.contextmanager
def on_host():
    """Run eager jnp ops on the CPU backend inside this context."""
    with jax.default_device(cpu_device()):
        yield


def to_accelerator(tree, device=None):
    """Move an array pytree to the default accelerator (no-op on CPU-only)."""
    if device is None:
        device = jax.devices()[0]
    return jax.device_put(tree, device)


def host_setup(fn):
    """Decorator: run ``fn`` on the CPU backend (results stay on CPU; move what
    you need with :func:`to_accelerator`)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with on_host():
            return fn(*args, **kwargs)

    return wrapper
