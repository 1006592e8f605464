from .block_kernels import (
    chebyshev_coefficients,
    kernel_halo,
    pallas_block_jacobi_multisweep,
    pallas_chebyshev_multisweep,
    use_multisweep_kernel,
)

__all__ = [
    "chebyshev_coefficients",
    "kernel_halo",
    "pallas_block_jacobi_multisweep",
    "pallas_chebyshev_multisweep",
    "use_multisweep_kernel",
]
