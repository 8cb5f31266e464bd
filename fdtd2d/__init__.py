"""fdtd2d — a 2D Maxwell solver framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference repo skunnavakkam/fdtd-2d (see SURVEY.md at the repo root):

- ``core``     — scenes: Yee grids, materials (image -> permittivity),
                 sources, geometry rasterization, physics guards.
- ``fdtd``     — TE-mode leapfrog time stepping: NumPy oracle, pure-JAX
                 ``lax.scan`` driver, K-step CUDA kernel for NVIDIA Hopper.
- ``fdfd``     — steady-state Helmholtz solves: matrix-free UPML operator,
                 preconditioned Krylov solvers, differentiable ``custom_vjp``
                 solve, tiled (Schwarz) domain decomposition.
- ``ops``      — numeric kernels: stencil applies, the CUDA FDTD kernel, sparse
                 primitives (scipy-parity layer), DST-based fast solvers.
- ``parallel`` — device meshes, sharded solvers (halo exchange between
                 devices), additive-Schwarz preconditioning across devices.
- ``models``   — diffusion surrogate: plain-JAX UNet, DDPM schedule, SNR-weighted
                 training, vmapped on-device data generation.
- ``viz``      — field snapshot rendering, video export, diagnostic plots.
"""

__version__ = "0.1.0"

from fdtd2d import constants as constants
