"""tpufem_torch — the PyTorch/CUDA port of tpufem for NVIDIA Hopper (H100).

The JAX package ``tpufem`` stays the reference.  This package mirrors its
layout (``ops``, ``operators``, ``solvers``, ``apps``) and shares its host
substrate (``tpufem.fem``, ``tpufem.utils.config``), which imports no JAX.
Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel
for ``sm_90a`` (``tpufem_torch/csrc``), built with ``nvcc`` at first use
(``tpufem_torch.utils.build``); on CPU tensors each kernel wrapper runs its
plain PyTorch version instead.

Ported so far: the 2D/3D Q_p Poisson Jacobi-CG on the separable tier
(``apps.poisson.solve_poisson`` with ``scatter="separable"``), with the
flat (K2) and solver-resident (K1) Laplace kernels.
"""

from tpufem_torch.utils.precision import configure_precision

configure_precision()

__version__ = "0.1.0"
