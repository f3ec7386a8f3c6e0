"""The entry points' ``shards`` (``tpufem_torch.parallel`` behind the
apps) against tpufem's on the 8 virtual CPU devices of tests/conftest.py,
in f64: ``solve_poisson(shards=...)`` (Jacobi, Chebyshev and GMG, 1-axis
and 2-axis, its CLI's ``--shards SZxSY``), ``run_heat(shards=...)`` in 3D,
``run_elasticity(shards=...)`` (Jacobi, and ``gmg``, which the reference
runs as distributed Jacobi) and ``bmop.bench_distributed``;
iterations equal, L2 and solutions to 1e-10; and the refusals with the
reference's messages where it has the check (scatter, the 2-axis grid in
2D), plus the port's own ``fast`` with ``shards``.  Chebyshev and GMG take
tpufem's power-iteration start (the ``power_start`` seam)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps import bmop as j_bmop
from tpufem.apps.elasticity import run_elasticity as j_run_elasticity
from tpufem.apps.heat import run_heat as j_run_heat
from tpufem.apps.poisson import solve_poisson as j_solve_poisson
from tpufem_torch.apps import bmop, elasticity, heat, poisson
from tpufem_torch.solvers import chebyshev as t_cheb


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its sharded applies are
    many small torch ops, which a worker sharing the cores with five others
    would otherwise run on eight spinning threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tpufem_start(n, seed, dtype, device):
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float64)
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


@pytest.fixture(autouse=True)
def same_start(monkeypatch):
    monkeypatch.setattr(t_cheb, "power_start", tpufem_start)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("precond,shards", [
    ("jacobi", (4, 1)), ("chebyshev", (2, 2)), ("gmg", 4)])
def test_solve_poisson_shards_matches_tpufem(precond, shards):
    kw = dict(dim=3, degree=2, refine=1, adaptive_steps=2, precond=precond,
              shards=shards)
    rt = poisson.solve_poisson(device="cpu", **kw)
    rj = j_solve_poisson(**kw)
    assert rt.iterations == int(rj.iterations) and rt.converged
    assert rt.l2_error == pytest.approx(rj.l2_error, rel=1e-10)
    assert rel(rt.solution, rj.solution) < 1e-10
    single = poisson.solve_poisson(device="cpu", scatter="boxes",
                                   **{**kw, "shards": None})
    assert rt.iterations == single.iterations


def test_poisson_cli_shards(capsys):
    argv = ["--dim", "3", "--degree", "2", "--refine", "1",
            "--adaptive-steps", "1", "--precond", "gmg", "--shards", "2x2",
            "--json"]
    poisson.main(argv + ["--device", "cpu"])
    lt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rj = j_solve_poisson(dim=3, degree=2, refine=1, adaptive_steps=1,
                         precond="gmg", shards=(2, 2))
    assert lt["iterations"] == int(rj.iterations)
    assert lt["l2_error"] == pytest.approx(rj.l2_error, rel=1e-10)


def test_poisson_shards_refusals():
    """The reference's checks, with its messages."""
    for kw in (dict(scatter="incidence", shards=2),
               dict(dim=2, degree=1, refine=2, shards=(2, 2))):
        with pytest.raises((ValueError, NotImplementedError)) as et:
            poisson.solve_poisson(device="cpu", **kw)
        with pytest.raises((ValueError, NotImplementedError)) as ej:
            j_solve_poisson(**kw)
        assert type(et.value) is type(ej.value)
        assert str(et.value) == str(ej.value)


def test_run_heat_shards_3d_matches_tpufem():
    kw = dict(dim=3, degree=2, refine=2, steps=3, shards=4)
    rt = heat.run_heat(device="cpu", **kw)
    rj = j_run_heat(**kw)
    assert rel(rt["u"], rj["u"]) < 1e-10
    assert rt["l2_error"] == pytest.approx(rj["l2_error"], rel=1e-10)
    single = heat.run_heat(device="cpu", **{**kw, "shards": None})
    assert rt["iterations"] == single["iterations"]


@pytest.mark.parametrize("dim,precond", [(3, "jacobi"), (2, "gmg")])
def test_run_elasticity_shards_matches_tpufem(dim, precond):
    kw = dict(dim=dim, degree=2, refine=3 if dim == 2 else 1,
              precond=precond, shards=4)
    mt, xt = elasticity.run_elasticity(device="cpu", **kw)
    mj, xj = j_run_elasticity(**kw)
    for key in ("n_dofs", "iterations", "precond", "converged"):
        assert mt[key] == mj[key], key
    assert mt["l2_error"] == pytest.approx(mj["l2_error"], rel=1e-10)
    assert rel(xt, xj) < 1e-10
    if precond == "jacobi":
        m1, x1 = elasticity.run_elasticity(device="cpu",
                                           **{**kw, "shards": 0})
        assert m1["iterations"] == mt["iterations"]


def test_elasticity_fast_with_shards_raises():
    """The port refuses the fast tier with shards; the reference builds
    it and leaves it unused (ROADMAP queue 3, deliberate divergences)."""
    with pytest.raises(ValueError, match="--fast"):
        elasticity.run_elasticity(dim=2, degree=1, refine=2, shards=2,
                                  fast=True, device="cpu")


@pytest.mark.parametrize("shards", [(2, 2)])
def test_bench_distributed_matches_tpufem(shards):
    rt = bmop.bench_distributed(3, 2, 1, 1, "float64", 2, shards,
                                device="cpu")
    rj = j_bmop.bench_distributed(3, 2, 1, 1, "float64", 2, shards)
    assert set(rt) == set(rj)
    for key in set(rj) - {"s_per_apply", "gdofs_per_s", "n_devices"}:
        assert rt[key] == rj[key], key
    assert rt["n_devices"] == 1 and rt["gdofs_per_s"] > 0


@pytest.mark.parametrize("given,grid", [
    ("2x2", (2, 2)), ("4X1", (4, 1)), ("4", (4, 1)), (3, (3, 1)),
    (np.int64(2), (2, 1)), ((2, 2), (2, 2)), ([4, 1], (4, 1))])
def test_parse_shards(given, grid):
    """One reading of a shard grid for both CLIs and solve_poisson."""
    from tpufem_torch.parallel.boxes import parse_shards

    assert parse_shards(given) == grid


def test_distributed_probe_split(capsys):
    """The apply-split probe runs on the CPU: one line a shard grid and one
    for the single-device apply, every time positive."""
    import json

    from tpufem_torch.apps import distributed_probe

    distributed_probe.main(["--cpu", "--refine", "1", "--steps", "1",
                            "--degree", "2"])
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["shards"] for r in recs] == ["2x2", "4x1", "single"]
    for r in recs[:2]:
        assert r["local"] > 0 and r["vmult"] > 0
        assert np.isfinite(r["reconcile"])
    assert recs[2]["vmult"] > 0
