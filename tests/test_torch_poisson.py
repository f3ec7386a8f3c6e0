"""Port parity for the whole slice: tpufem_torch solve_poisson against
tpufem solve_poisson(scatter="separable", use_pallas=True) in f64 on the
CPU (the port runs its plain version there, the JAX package its Pallas
kernels in interpret mode)."""

import json

import numpy as np
import pytest

from tpufem.apps import bmop as j_bmop
from tpufem.apps.poisson import solve_poisson as j_solve_poisson
from tpufem_torch.apps import bmop as tbmop
from tpufem_torch.apps import poisson as tpoisson
from tpufem_torch.ops.matrix_free import MatrixFree
from torch_threads import one_torch_thread  # noqa: F401


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


BMOP_SHARDS = ["--cpu", "--dim", "3", "--degrees", "2", "--refine", "1",
               "--adaptive", "1", "--shards", "2x2", "--reps", "2"]


@pytest.mark.parametrize("case", ["shards", "bmop_shards"])
def test_unported_options_raise(case, capsys):
    """The two options this test held to NotImplementedError are ported
    (``tpufem_torch.parallel``): each now runs on the CPU and matches
    tpufem — the distributed box-tier solve (iterations, L2 and solution
    to 1e-10) and ``bmop --shards`` (its record's keys and non-timing
    values)."""
    if case == "shards":
        rt = tpoisson.solve_poisson(shards=2, device="cpu")
        rj = j_solve_poisson(shards=2)
        assert rt.iterations == rj.iterations and rt.converged
        assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * rj.l2_error
        xj = np.asarray(rj.solution)
        assert (np.linalg.norm(rt.solution - xj)
                <= 1e-10 * np.linalg.norm(xj))
        return
    tbmop.main(BMOP_SHARDS)
    rt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    j_bmop.main(BMOP_SHARDS)
    rj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rt) == set(rj)
    # n_devices: the distinct devices the shards sit on (the reference's
    # shards are devices)
    for key in set(rj) - {"s_per_apply", "gdofs_per_s", "ts", "n_devices"}:
        assert rt[key] == rj[key], key
    assert rt["n_devices"] == 1 and rj["n_devices"] == 4
    assert rt["gdofs_per_s"] > 0 and rt["shards"] == "2x2"


@pytest.mark.parametrize("precond", ["gmg", "gmg-bf16"])
def test_gmg_precond_off_the_box_tier_raises(precond):
    """GMG belongs to the box tier and to poisson_mg: both packages refuse
    it on the uniform tiers with the same ValueError."""
    with pytest.raises(ValueError, match="box tier") as et:
        tpoisson.solve_poisson(dim=2, degree=1, refine=2, precond=precond,
                               device="cpu")
    with pytest.raises(ValueError, match="box tier") as ej:
        j_solve_poisson(dim=2, degree=1, refine=2, precond=precond)
    assert str(et.value) == str(ej.value)


@pytest.fixture
def same_start(monkeypatch):
    """The port's Chebyshev power iteration starts from tpufem's draw."""
    import jax
    import jax.numpy as jnp
    import torch

    from tpufem_torch.solvers import chebyshev

    def draw(n, seed, dtype, device):
        v = jax.random.normal(jax.random.PRNGKey(seed), (n,),
                              dtype=jnp.float64)
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    monkeypatch.setattr(chebyshev, "power_start", draw)


def _rough_any(x):
    """A rough RHS in 2D and 3D (x and the last axis)."""
    return (np.cos(7 * x[:, 0]) + x[:, -1] ** 3
            + np.sin(13 * x[:, 0] * x[:, -1]))


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=2, refine=3),
    dict(dim=3, degree=2, refine=2),
    dict(dim=2, degree=1, refine=2, adaptive_steps=1),
], ids=["2d-auto", "3d-auto", "adaptive"])
def test_chebyshev_precond_matches_tpufem(same_start, kw):
    """precond="chebyshev" on the default tier (structured; incidence with
    hanging nodes on the adaptive mesh), on a rough RHS: tpufem's
    iterations, L2 to 1e-10, fewer iterations than Jacobi."""
    kw = dict(kw, rhs=_rough_any)
    rt = tpoisson.solve_poisson(**kw, precond="chebyshev", device="cpu")
    rj = j_solve_poisson(**kw, precond="chebyshev")
    assert rt.converged and rt.n_dofs == rj.n_dofs
    assert rt.iterations == rj.iterations
    assert abs(rt.l2_error - rj.l2_error) <= 1e-10 * rj.l2_error
    jacobi = tpoisson.solve_poisson(**kw, device="cpu")
    assert rt.iterations < jacobi.iterations


def test_cli_amr_chebyshev_matches_tpufem(same_start, capsys):
    """--amr 2 --precond chebyshev through main: each cycle's DoFs,
    iterations and L2 equal to tpufem's loop.  At Q2 refine 2: at the
    CLI's default Q1 refine 3 the Kelly indicators of symmetric cells tie
    at the 30% cut to the last bits, and the two packages refine different
    cells from cycle 1 on, with Jacobi as with Chebyshev (ROADMAP.md queue
    3, the AMR observation)."""
    from tpufem.apps.poisson import solve_poisson_amr as j_amr

    tpoisson.main(["--amr", "2", "--precond", "chebyshev", "--degree", "2",
                   "--refine", "2", "--json", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rj = j_amr(dim=2, degree=2, refine=2, cycles=2, precond="chebyshev")
    assert [x["n_dofs"] for x in lines] == [r.n_dofs for r in rj]
    assert [x["iterations"] for x in lines] == [r.iterations for r in rj]
    for x, r in zip(lines, rj):
        assert abs(x["l2_error"] - r.l2_error) <= 1e-10 * r.l2_error


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
