"""``tpufem_torch.apps.multichip``, the port's counterpart of
``__graft_entry__.py::dryrun_multichip``: at 4 shards on the CPU every
section holds its own parity (each distributed count equal to the
single-device count, x within 1e-9); section 8, the distributed
Newton-Krylov on the adaptive hanging-node mesh (its Jacobian
``torch.func.linearize`` through the exchanges), takes the Newton and
Krylov counts of tpufem's distributed solve at 4 devices (run here) and
of the JAX record; and the record's lines (MULTICHIP_r05.json) parse into
the section keys the card's run prints them beside."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufem.fem.assemble import assemble_rhs
from tpufem.fem.constraints import make_hanging_node_constraints
from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.ops.matrix_free import MatrixFree
from tpufem.parallel.general import (
    GeneralDistributedOperator,
    GeneralPartitioner,
)
from tpufem.utils.config import FemConfig
from tpufem_torch.apps import multichip


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its sharded applies are
    many small torch ops, which a worker sharing the cores with five others
    would otherwise run on eight spinning threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parent.parent


def test_dryrun_four_shards_on_the_cpu():
    lines = multichip.dryrun(4, device="cpu", log=lambda m: None)
    assert [ln["section"] for ln in lines] == [
        "1-axis Jacobi-CG", "2-axis Jacobi-CG", "slab GMG-CG",
        "general adaptive Jacobi-CG", "box-tier CG", "box-tier GMG-CG",
        "2-level Jacobi-CG", "2-level box GMG-CG", "Newton-Krylov"]
    for ln in lines:
        assert ln["iterations"] == ln["single"] and ln["rel"] <= 1e-9, ln
    newton = lines[-1]
    assert newton["krylov"] == newton["krylov_single"]
    # tpufem's distributed Newton on section 8's problem, 4 devices
    mesh = Mesh.hyper_cube(2, 3)
    c = (mesh.origins + mesh.sizes[:, None] * 0.5) / mesh.U
    mesh = mesh.refine(np.linalg.norm(c - 0.3, axis=1) < 0.4)
    dofs = DoFHandler(mesh, 2)
    mf = MatrixFree.build(mesh, dofs, FemConfig(2, 2, scatter="incidence"),
                          constraints=make_hanging_node_constraints(dofs))
    b = assemble_rhs(dofs, lambda pts: np.sin(np.pi * pts[:, 0])
                     * np.cos(np.pi * pts[:, 1]))
    jop = GeneralDistributedOperator(
        GeneralPartitioner.build(mf, 4), needs_values=True,
        quad_op=lambda v, g, ctx: (None, (1.0 + v**2)[:, None, :] * g))
    rj = jop.newton_solve(b, rtol=1e-11)
    assert newton["iterations"] == int(rj.iterations) == 4
    assert newton["krylov"] == int(rj.linear_iterations) == 159


def test_record_counts_parse_the_jax_record():
    tail = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
    counts = multichip.record_counts(tail)
    assert counts == {
        "1-axis Jacobi-CG": 101, "2-axis Jacobi-CG": 100,
        "slab GMG-CG": 8, "general adaptive Jacobi-CG": 90,
        "box-tier CG": 37, "box-tier GMG-CG": 7,
        "2-level Jacobi-CG": 100, "2-level box GMG-CG": 7,
        "Newton-Krylov": 4}
