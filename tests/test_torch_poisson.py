"""Port parity for the whole slice: tpufem_torch solve_poisson against
tpufem solve_poisson(scatter="separable", use_pallas=True) in f64 on the
CPU (the port runs its plain version there, the JAX package its Pallas
kernels in interpret mode)."""

import json

import numpy as np
import pytest

from tpufem.apps.poisson import solve_poisson as j_solve_poisson
from tpufem_torch.apps import poisson as tpoisson
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.utils.config import FemConfig


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


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=2, refine=4),
    dict(dim=3, degree=2, refine=2),
    dict(dim=2, degree=3, refine=3, rhs=lambda x: np.cos(5 * x[:, 0])
         + x[:, 1] ** 3),
], ids=["2d_q2_r4", "3d_q2_r2", "2d_q3_r3_rough"])
def test_solve_poisson_shell_matches_tpufem(kw):
    """The curved hyper_shell through the terms tier (K4 in 3D, K3 in 2D
    under use_pallas), inhomogeneous Dirichlet data from the manufactured
    solution: equal CG iterations, L2 to 1e-10."""
    rt = tpoisson.solve_poisson(**kw, mesh_kind="shell", scatter="separable",
                                use_pallas=True, device="cpu")
    rj = j_solve_poisson(**kw, mesh_kind="shell", scatter="separable",
                         use_pallas=True)
    assert rt.converged and rt.n_dofs == rj.n_dofs
    assert rt.iterations == rj.iterations
    assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * rj.l2_error


def test_cli_shell(capsys):
    tpoisson.main(["--dim", "3", "--degree", "2", "--refine", "2", "--mesh",
                   "shell", "--pallas", "--device", "cpu", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rj = j_solve_poisson(dim=3, degree=2, refine=2, mesh_kind="shell",
                         scatter="separable")
    assert line["n_dofs"] == rj.n_dofs and line["iterations"] == rj.iterations
    assert abs(line["l2_error"] - rj.l2_error) <= 1e-10 * rj.l2_error


def test_plain_and_kernel_wrapper_solves_agree():
    """use_pallas only swaps the apply: on the CPU both paths are the plain
    version and give the identical solve."""
    a = tpoisson.solve_poisson(dim=2, degree=3, refine=3, device="cpu",
                               scatter="separable", use_pallas=True)
    b = tpoisson.solve_poisson(dim=2, degree=3, refine=3, device="cpu",
                               scatter="separable")
    assert a.iterations == b.iterations
    assert np.array_equal(a.solution, b.solution)


def test_cli_json(capsys):
    tpoisson.main(["--dim", "2", "--degree", "2", "--refine", "3", "--pallas",
                   "--device", "cpu", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rj = j_solve_poisson(dim=2, degree=2, refine=3, scatter="separable")
    assert line["n_dofs"] == rj.n_dofs and line["iterations"] == rj.iterations
    assert abs(line["l2_error"] - rj.l2_error) <= 1e-10 * rj.l2_error


def _build_boxes():
    mesh = Mesh.hyper_cube(2, 2)
    MatrixFree.build(mesh, DoFHandler(mesh, 1),
                     FemConfig(dim=2, degree=1, scatter="boxes"), "cpu")


@pytest.mark.parametrize("call,match", [
    (lambda: tpoisson.solve_poisson(scatter="boxes", device="cpu"),
     "box tier"),
    (lambda: tpoisson.solve_poisson(precond="gmg-bf16", device="cpu"),
     "GMG"),
    (lambda: tpoisson.solve_poisson(shards=2, device="cpu"), "distributed"),
    (lambda: tpoisson.solve_poisson(precond="gmg", device="cpu"), "GMG"),
    (lambda: tpoisson.solve_poisson(precond="chebyshev", device="cpu"),
     "chebyshev"),
    (_build_boxes, "box tier"),
    (lambda: tpoisson.main(["--amr", "2", "--precond", "chebyshev",
                            "--device", "cpu"]), "chebyshev"),
], ids=["scatter-boxes", "gmg-bf16", "shards", "gmg", "chebyshev",
        "build-boxes", "cli-amr-chebyshev"])
def test_unported_options_raise(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()


def test_pallas_on_the_default_tier_attaches_a_kernel(monkeypatch):
    """use_pallas with the default scatter takes the separable scheme and
    attaches its kernels; the flag is never left unread."""
    built = []
    build = MatrixFree.build

    def spy(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(MatrixFree, "build", spy)
    r = tpoisson.solve_poisson(dim=2, degree=2, refine=2, use_pallas=True,
                               device="cpu")
    assert r.converged
    mf = built[-1]
    assert mf.scheme == "separable"
    assert mf.kernel is not None and mf.resident is not None


@pytest.mark.parametrize("kw", [
    dict(scatter="structured"), dict(scatter="dense"),
    dict(scatter="incidence"), dict(scatter="colored"),
    dict(adaptive_steps=1)])
def test_pallas_on_a_cell_loop_tier_raises(kw):
    """The cell-loop tiers run no kernel: use_pallas there raises instead
    of running the plain apply."""
    with pytest.raises(ValueError, match="separable"):
        tpoisson.solve_poisson(dim=2, degree=1, refine=2, use_pallas=True,
                               device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(scatter="auto"),
    dict(scatter="incidence"),
    dict(adaptive_steps=1),
    dict(coefficient=lambda x: 1.0 + x[:, 0]),
])
def test_formerly_unported_options_match_tpufem(kw):
    """The four options that raised before the cell-loop tiers: each solve
    now equals tpufem's (iterations, L2 within 1e-10)."""
    rt = tpoisson.solve_poisson(dim=2, degree=1, refine=2, device="cpu",
                                **kw)
    rj = j_solve_poisson(dim=2, degree=1, refine=2, **kw)
    assert rt.n_dofs == rj.n_dofs and rt.iterations == rj.iterations
    assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * rj.l2_error
