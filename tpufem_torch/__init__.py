"""tpufem_torch — the PyTorch/CUDA port of tpufem for NVIDIA Hopper (H100).

The JAX package ``tpufem`` stays the reference.  This package mirrors its
layout (``fem``, ``ops``, ``operators``, ``solvers``, ``apps``) and imports
nothing of it: the numpy host setup it needs (mesh, DoFs, quadrature,
shapes, mapping, assembly, ``FemConfig``, VTU output) is its own copy in
``tpufem_torch.fem`` and ``tpufem_torch.utils``, pinned equal to the
reference by ``tests/test_torch_fem.py``.  Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel
for ``sm_90a`` (``tpufem_torch/csrc``), built with ``nvcc`` at first use
(``tpufem_torch.utils.build``); on CPU tensors each kernel wrapper runs its
plain PyTorch version instead.

Ported so far: the 2D/3D Q_p Poisson Jacobi-CG on the separable tier
(``apps.poisson.solve_poisson`` with ``scatter="separable"``) on the
hyper_cube and the curved hyper_shell, with separable or CP-expanded
variable coefficients, with the flat (K2) and solver-resident (K1)
Laplace kernels and the solver-resident sum-of-tensor-products kernels
(K4 in 3D, K3 in 2D); Chebyshev and geometric-multigrid preconditioning
(``solvers.chebyshev``, ``solvers.multigrid``, ``apps.poisson_mg``,
``solvers.resident.resident_gmg_cg``), every level on the same kernels.
"""

from tpufem_torch.utils.precision import configure_precision

configure_precision()

__version__ = "0.1.0"
