"""Port parity for the whole slice: tpufem_torch solve_poisson against
tpufem solve_poisson(scatter="separable", use_pallas=True) in f64 on the
CPU (the port runs its plain version there, the JAX package its Pallas
kernels in interpret mode)."""

import json

import numpy as np
import pytest

from tpufem.apps.poisson import solve_poisson as j_solve_poisson
from tpufem_torch.apps import poisson as tpoisson


def _rough(x):
    """A RHS far from an eigenvector, so the solve takes many iterations."""
    return np.cos(7 * x[:, 0]) + x[:, 2] ** 3 + np.sin(13 * x[:, 0] * x[:, 2])


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=1, refine=5),  # BASELINE config 1
    dict(dim=3, degree=2, refine=3),  # BASELINE config 2
    dict(dim=3, degree=4, refine=1),
    dict(dim=3, degree=2, refine=3, rhs=_rough),
], ids=["2d_q1_r5", "3d_q2_r3", "3d_q4_r1", "3d_q2_r3_rough"])
def test_solve_poisson_matches_tpufem(kw):
    rt = tpoisson.solve_poisson(**kw, scatter="separable", use_pallas=True,
                                device="cpu")
    rj = j_solve_poisson(**kw, scatter="separable", use_pallas=True)
    assert rt.converged and rt.n_dofs == rj.n_dofs
    assert rt.iterations == rj.iterations
    assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * rj.l2_error
    if "rhs" in kw:
        assert rt.iterations > 20  # the rough RHS exercises CG for real


def test_plain_and_kernel_wrapper_solves_agree():
    """use_pallas only swaps the apply: on the CPU both paths are the plain
    version and give the identical solve."""
    a = tpoisson.solve_poisson(dim=2, degree=3, refine=3, device="cpu",
                               use_pallas=True)
    b = tpoisson.solve_poisson(dim=2, degree=3, refine=3, device="cpu")
    assert a.iterations == b.iterations
    assert np.array_equal(a.solution, b.solution)


def test_cli_json(capsys):
    tpoisson.main(["--dim", "2", "--degree", "2", "--refine", "3", "--pallas",
                   "--device", "cpu", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rj = j_solve_poisson(dim=2, degree=2, refine=3, scatter="separable")
    assert line["n_dofs"] == rj.n_dofs and line["iterations"] == rj.iterations
    assert abs(line["l2_error"] - rj.l2_error) <= 1e-10 * rj.l2_error


@pytest.mark.parametrize("kw,match", [
    (dict(scatter="auto"), "structured"),
    (dict(scatter="incidence"), "hanging nodes"),
    (dict(shards=2), "distributed"),
    (dict(precond="gmg"), "GMG"),
    (dict(mesh_kind="shell"), "K4"),
    (dict(adaptive_steps=1), "hanging nodes"),
    (dict(coefficient=lambda x: 1.0 + x[:, 0]), "coefficient"),
])
def test_unported_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        tpoisson.solve_poisson(dim=2, degree=1, refine=2, device="cpu", **kw)
