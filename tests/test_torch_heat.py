"""Port parity for the heat app (``apps/heat.py``): implicit-Euler
stepping on the generic-functor tier and on the tensor-product tier
(``resident``: K4 in 3D, K3 in 2D, their plain versions on the CPU)
against tpufem in f64 (u and L2 to 1e-10), the two tiers against each
other, the decay accuracy, the bitwise checkpoint resume, and the
distributed run (``shards``) against tpufem's."""

import numpy as np
import pytest

from tpufem.apps.heat import run_heat as j_run_heat
from tpufem_torch.apps import heat as theat
from torch_threads import one_torch_thread  # noqa: F401


def run_heat(**kw):
    return theat.run_heat(device="cpu", **kw)


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kw", [
    dict(dim=2, degree=2, refine=3, dt=1e-3, steps=4),
    dict(dim=3, degree=2, refine=2, dt=1e-3, steps=3, resident=True),
    dict(dim=2, degree=3, refine=3, dt=2e-3, steps=3, resident=True)],
    ids=["flat-2d", "resident-3d-k4", "resident-2d-k3"])
def test_heat_matches_tpufem(kw):
    """Each step's CG (Jacobi-CG through the terms kernel with
    ``resident``) reproduces tpufem's run: u and the L2 error to 1e-10."""
    rj, rt = j_run_heat(**kw), run_heat(**kw)
    assert rt["n_dofs"] == rj["n_dofs"] and rt["t_end"] == rj["t_end"]
    assert rel(rt["u"], np.asarray(rj["u"])) < 1e-10
    assert rt["l2_error"] == pytest.approx(rj["l2_error"], rel=1e-10)
    assert len(rt["iterations"]) == kw["steps"]


def test_heat_resident_matches_flat():
    """The tensor-product tier (K4's plain version) reproduces the
    generic-tier run, as tpufem's tests hold them."""
    kw = dict(dim=3, degree=2, refine=3, dt=1e-3, steps=4)
    flat, fast = run_heat(**kw), run_heat(resident=True, **kw)
    assert fast["l2_error"] == pytest.approx(flat["l2_error"], rel=1e-8)
    assert rel(fast["u"], flat["u"]) < 1e-9


def test_heat_decay_accuracy():
    """Implicit Euler on u_t = Δu decays at exp(-dim pi^2 t); halving dt
    roughly halves the time-discretization error."""
    r = run_heat(dim=2, degree=2, refine=4, dt=5e-4, steps=20)
    assert r["l2_error"] < 5e-3, r["l2_error"]
    r2 = run_heat(dim=2, degree=2, refine=4, dt=2.5e-4, steps=40)
    assert r2["l2_error"] < 0.7 * r["l2_error"]


@pytest.mark.parametrize("resident", [False, True])
def test_heat_checkpoint_resume_exact(tmp_path, resident):
    ck = str(tmp_path / "ck.npz")
    kw = dict(dim=2, degree=1, refine=3, dt=1e-3, resident=resident)
    full = run_heat(steps=10, **kw)
    run_heat(steps=5, checkpoint=ck, checkpoint_every=5, **kw)
    resumed = run_heat(steps=10, resume=ck, **kw)
    assert np.array_equal(resumed["u"], full["u"]), (
        "resume must be bitwise identical to the uninterrupted run")
    with pytest.raises(ValueError, match="dt"):
        run_heat(steps=10, resume=ck, **{**kw, "dt": 2e-3})


def test_heat_shards_not_ported():
    """``shards`` is ported (the generic tier on the general partitioner,
    ``tpufem_torch.parallel``): u and L2 equal tpufem's distributed run to
    1e-10 (the reference returns no counts), each step's CG count equals
    the port's single-device run; ``resident`` with ``shards`` raises the
    reference's ValueError."""
    kw = dict(dim=2, degree=1, refine=2, steps=2)
    r = run_heat(shards=2, **kw)
    rj = j_run_heat(shards=2, **kw)
    assert rel(r["u"], np.asarray(rj["u"])) < 1e-10
    assert r["l2_error"] == pytest.approx(rj["l2_error"], rel=1e-10)
    assert r["iterations"] == run_heat(**kw)["iterations"]
    with pytest.raises(ValueError) as et:
        run_heat(resident=True, shards=2, **kw)
    with pytest.raises(ValueError) as ej:
        j_run_heat(resident=True, shards=2, **kw)
    assert str(et.value) == str(ej.value)


def test_heat_cli(capsys):
    theat.main(["--dim", "2", "--degree", "2", "--refine", "3", "--steps",
                "3", "--resident", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "L2 error vs analytic decay" in out and "dofs: 289" in out
