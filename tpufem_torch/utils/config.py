"""Run-time configuration.

Reference analogue: the reference's compile-time configuration surface —
template parameters (dim, fe_degree), ``defs.h`` macros (parallelization
scheme, coloring on/off) and argv refinement levels (SURVEY.md §5 "Config /
flag system"). Here dim/degree become jit-static fields; the jit cache per
(dim, p, scheme) mirrors the reference's template instantiation strategy.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

ScatterScheme = Literal[
    "auto", "incidence", "colored", "structured", "dense", "separable"
]
MetricMode = Literal["cartesian", "affine", "general"]


@dataclasses.dataclass(frozen=True)
class FemConfig:
    """Static configuration of a matrix-free operator instance."""

    dim: int = 2
    degree: int = 1
    n_q_1d: int | None = None  # default: degree + 1 (QGauss(p+1))
    # auto -> "structured" on uniform Cartesian meshes (gather-free blocked
    # cell loop, the TPU fast path), else "incidence"
    scatter: ScatterScheme = "auto"
    use_pallas: bool = False
    dtype: str = "float64"  # compute dtype for device arrays
    # x-matmul precision of the resident Pallas kernel: "f32" (HIGHEST,
    # ~1e-7 rel) or "bf16" (bf16x3, ~3e-6 rel, ~25% faster apply)
    pallas_mode: str = "f32"
    # fuse the hyper_cube Dirichlet mask algebra y = m·A(m·x) + (1-m)·x
    # into the resident kernel (separable iota masks, saves 2 HBM
    # elementwise passes per apply in the resident CG loop; measured
    # 1.15x on the flagship resident Jacobi-CG, identical iteration
    # counts — scripts/resident_mask_lab.py).  None = auto: fuse exactly
    # when the constraint set is the plain full-boundary Dirichlet mask
    # (the only mask the separable iota factorization can represent);
    # True raises if it is not.
    pallas_dirichlet: bool | None = None

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        if not (1 <= self.degree <= 12):
            raise ValueError("degree out of supported range")
        if self.pallas_mode not in ("f32", "bf16", "bf16s"):
            raise ValueError(
                f"pallas_mode must be 'f32', 'bf16' or 'bf16s', got "
                f"{self.pallas_mode!r}")

    @property
    def n_dofs_per_cell(self) -> int:
        return (self.degree + 1) ** self.dim

    @property
    def nq1(self) -> int:
        return self.n_q_1d if self.n_q_1d is not None else self.degree + 1

    @property
    def n_q_points(self) -> int:
        return self.nq1**self.dim
