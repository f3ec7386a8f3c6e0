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

Ported: everything the JAX package does, apart from ``bench.py`` (the
port's bench is yet to be written) and the JAX-only tooling (the compile
cache, ``scripts/_micro.py``, ``scripts/_check_*.py``):

- ``fem``, ``utils``: the numpy host setup (mesh, DoFs, quadrature,
  shapes, mapping, assembly, coloring, hanging-node constraints, the
  Kelly estimator, transfers, the g++ helper), config, VTU output,
  precision, timing, metrics and debug helpers, the kernel build;
- ``ops``: the apply tiers, separable (K2 flat, K1 resident, K3/K4 terms:
  hand-written CUDA for ``sm_90a``), structured, dense, incidence and
  colored with hanging nodes, the adaptive box tier, the ELL SpMV;
- ``operators``: Laplace, the generic quadrature-point functors (mass,
  Helmholtz, convection-diffusion, nonlinear), the tensor-product tier,
  vector elasticity;
- ``solvers``: CG and the resident CGs, Chebyshev, geometric and box
  multigrid, vector multigrid, GMRES, BiCGStab, AD Newton;
- ``parallel``: the distributed layer on an in-process shard mesh;
- ``apps``: poisson (uniform, shell, adaptive, AMR), poisson_mg, heat,
  nonlinear, elasticity, bmop, bmspmv, multichip (``dryrun``,
  ``entry``), the chip checks with their H100 golden
  (``chip_checks``, ``check_chip_goldens``), ``run_sweep``,
  ``plot_benchmarks``;
- ``lab``: the kernel labs (L1, L2, the toolchain probes) and the solver
  labs (``cg_blas1_lab``, ``resident_mask_lab``, ``adaptive_prec_lab``,
  ``adaptive_solve_lab``).
"""

from tpufem_torch.utils.precision import configure_precision

configure_precision()

__version__ = "0.1.0"
