"""Distributed vector-valued operators (multi-component FEEvaluation over
the general partitioner).

Port of ``tpufem/parallel/vector.py``.  deal.II's ``FESystem`` block
convention gives every component the scalar DoF layout, so a vector field
rides as a ``(C, NL)`` tensor a shard through the same owned/ghost
machinery as the scalar one (``parallel.general``, whose exchanges and
local ops index the last axis):

- ghost exchange / compress: the scalar pairwise all_to_all or
  all_gather plans with a leading component axis (one collective moves
  all components);
- the cell kernel: ``operators.generic``'s transforms with the components
  in the cell batch, the component coupling in the quadrature functor
  (elasticity's stress), as the single-device ``operators.vector``;
- constraints: the scalar tables over every component;
- dots: owned-masked, flattened per-shard dots + ``psum``.

Global vectors are (C, n_dofs); the JAX package's stacked local layout is
(n_shards, C, NL).
"""

from __future__ import annotations

import numpy as np

from tpufem_torch.parallel.general import (
    GeneralDistributedOperator,
    GeneralPartitioner,
)
from tpufem_torch.parallel.mesh import Sharded, ShardMesh


class GeneralDistributedVectorOperator(GeneralDistributedOperator):
    """Distributed constrained vector operator + CG over a
    GeneralPartitioner.

    ``quad_op``: the multi-component functor contract of
    ``operators/vector.py`` — (values (C, nc, nq) | None,
    grads (C, nc, dim, nq) | None, ctx) -> (submit_values | None,
    submit_grads | None)."""

    def __init__(self, part: GeneralPartitioner, quad_op, n_components: int,
                 needs_values: bool = True, needs_gradients: bool = True,
                 device_mesh=None, exchange: str = "auto"):
        if quad_op is None:
            raise ValueError("the vector operator requires a quad_op")
        self.C = int(n_components)
        super().__init__(part, device_mesh=device_mesh, exchange=exchange,
                         quad_op=quad_op, needs_values=needs_values,
                         needs_gradients=needs_gradients)

    # -- component-axis hooks -----------------------------------------
    @property
    def _global_shape(self):
        return (self.C, self.part.n_dofs)

    def _to_global(self, arr):
        """(n_shards, C, NL) (or Sharded) -> (C, n_dofs) from owned
        slots."""
        a = ShardMesh.stack(arr) if isinstance(arr, Sharded) \
            else np.asarray(arr)
        return np.stack([
            self.part.to_global(a[:, c]) for c in range(self.C)
        ])

    def put_vector(self, u_global) -> Sharded:
        u = np.asarray(u_global, np.float64)
        if u.shape != (self.C, self.part.n_dofs):
            raise ValueError(
                f"expected ({self.C}, {self.part.n_dofs}), got {u.shape}")
        loc = np.stack([self.part.to_local(u[c]) for c in range(self.C)],
                       axis=1)  # (n_shards, C, NL)
        return self.mesh.put(loc, dtype=self.part.dtype)


def distributed_elasticity_operator(
    part: GeneralPartitioner, mu=1.0, lam=1.0, **kw
) -> GeneralDistributedVectorOperator:
    """Distributed step-8 elasticity over an arbitrary cell partition."""
    from tpufem_torch.operators.vector import elasticity_qop

    return GeneralDistributedVectorOperator(
        part, elasticity_qop(part.dim, mu, lam), n_components=part.dim,
        needs_values=False, needs_gradients=True, **kw)
