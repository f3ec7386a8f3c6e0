"""Port parity for the solver labs (``tpufem_torch.lab``: ``cg_blas1_lab``,
``resident_mask_lab``, ``adaptive_prec_lab``, ``adaptive_solve_lab``)
against tpufem on the CPU, at small sizes.

- cg_blas1_lab: the records' keys at a tiny shape; the hand-fused body's
  iterate after k steps equal to ``cg_solve``'s in f64 (1e-12).
- resident_mask_lab at 3D Q4 refine 2, f64: flat and fused take equal
  iterations and agree in x (1e-12), with tpufem's ``resident_jacobi_cg``
  count (Pallas in interpret mode) on the same rng(42) b.
- adaptive_prec_lab: the f32 apply against tpufem's box ``_vmult_p`` in
  f32 (1e-6), bf16-patch in its 5e-3 class, and every patched attribute
  and precision setting restored after a variant made to raise.
- adaptive_solve_lab at 3D Q2 refine 2, one adaptive step (1,657 DoFs), on
  a prebuilt f64 operator: its counts equal to the port's
  ``bmop.bench_adaptive_solve`` and to tpufem's, with tpufem's
  power-iteration start in the port's seam (``chebyshev.power_start``), as
  ``tests/test_torch_bmop_adaptive.py`` holds them; in f32 on a prebuilt
  operator, diagonal and hierarchy (as ``chip_smoke.py`` passes phase
  10's) only the solve stages, with the bf16-cycle count equal to bmop's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps import bmop as j_bmop
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.solvers.resident import resident_jacobi_cg as j_resident_cg
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.apps import bmop
from tpufem_torch.lab import (
    adaptive_prec_lab,
    adaptive_solve_lab,
    cg_blas1_lab,
    resident_mask_lab,
)
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.solvers import chebyshev as t_cheb
from tpufem_torch.solvers.box_multigrid import BoxMultigrid
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.solvers.resident import _dot3
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (3, 2, 2, 1)  # dim, p, refine, steps
BOX_BF16_TOL = 5e-3  # chip_smoke.BOX_BF16_TOL


def tpufem_start(n, seed, dtype, device):
    """tpufem's power-iteration start (``jax.random.normal``)."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jdt)
    return torch.tensor(np.asarray(v.astype(jnp.float64)), dtype=dtype,
                        device=device)


def test_cg_blas1_records_and_default_shape():
    lines = []
    recs = cg_blas1_lab.main((9, 9, 16), 3, device="cpu", log=lines.append)
    assert len(lines) == len(recs) == 7
    assert [r["check"] for r in recs] == [
        "config", "axpy_pass", "dot_cg_default", "dot_resident_dot3",
        "cg_body_track_best", "cg_body_no_track", "hand_fused_body"]
    assert recs[0]["elements"] == 9 * 9 * 16
    for r in recs[1:]:
        assert {"ms_per_iter", "eff_gbps_at_assumed_passes",
                "assumed_passes", "bound_ms_per_iter", "bound_by"} <= set(r)
        assert r["ms_per_iter"] > 0 and r["bound_ms_per_iter"] > 0
    assert recs[4]["iters"] == 3 and recs[6]["assumed_passes"] == 18
    # the resident layout of 3D Q4 refine 6, from the ring's row length
    assert cg_blas1_lab.resident_shape() == (257, 257, 272)
    assert cg_blas1_lab.resident_shape(2, 2, torch.bfloat16) == (9, 9, 32)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_hand_fused_body_is_cg(k):
    g = torch.Generator().manual_seed(k)
    b = torch.randn(9, 9, 16, dtype=torch.float64, generator=g)
    idiag = 1.0 + 0.1 * torch.randn(9, 9, 16, dtype=torch.float64,
                                    generator=g) ** 2
    x, r, _, _ = cg_blas1_lab.fused_cg(b, idiag, k)
    ref = cg_solve(lambda v: v * cg_blas1_lab.A_SCALE, b,
                   M_inv=lambda v: idiag * v, rtol=1e-30, maxiter=k,
                   dot=_dot3)
    assert ref.iterations == k
    assert float((x - ref.x).norm() / ref.x.norm()) <= 1e-12
    r_true = b - cg_blas1_lab.A_SCALE * x
    assert float((r - r_true).norm() / b.norm()) <= 1e-12


def test_resident_mask_lab_matches_tpufem():
    out = resident_mask_lab.run(2, "f32", 1e-8, dtype="float64",
                                device="cpu", log=lambda s: None)
    fl, fu = out["flat"], out["fused"]
    assert out["verdict"]["same_iterations"]
    assert fl["converged"] and fu["converged"]
    xf, xu = out["x"]["flat"], out["x"]["fused"]
    assert float((xf - xu).norm() / xf.norm()) <= 1e-12
    mesh = JMesh.hyper_cube(3, 2)
    dofs = JDoFHandler(mesh, 4)
    b_host = np.random.default_rng(42).standard_normal(dofs.n_dofs)
    jmf = JMatrixFree.build(mesh, dofs, JFemConfig(
        dim=3, degree=4, dtype="float64", scatter="separable",
        use_pallas=True, pallas_mode="f32", pallas_dirichlet=False))
    jop = JLaplace(jmf)
    b = jnp.asarray(np.asarray(jmf.interior_mask) * b_host)
    rj = j_resident_cg(jop, b, diag=jop.diagonal(), rtol=1e-8)
    assert fl["iterations"] == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(xf.numpy() - xj) <= 1e-10 * np.linalg.norm(xj)


def test_resident_mask_lab_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resident_mask_lab.run(1)


@pytest.fixture(scope="module")
def prebuilt32():
    return (bmop.build_adaptive_op(*SHAPE, "float32", device="cpu"),
            j_bmop.build_adaptive_op(*SHAPE, "float32"))


def test_adaptive_prec_lab_against_tpufem(prebuilt32):
    pre_t, pre_j = prebuilt32
    out = adaptive_prec_lab.main(prebuilt=pre_t[:3], device="cpu",
                                 log=lambda s: None)
    assert not out["failed"]
    assert set(out["gdofs"]) == set(adaptive_prec_lab.VARIANTS)
    jop = pre_j[3]
    xj = jop.to_patch(np.ones(pre_j[1].n_dofs))
    yj = np.asarray(jop._vmult_p(jop.params, xj), np.float64)
    y = out["y"]["f32"]
    assert np.linalg.norm(y - yj) / np.linalg.norm(yj) <= 1e-6
    # on the CPU TF32 does not exist: both TF32 variants compute f32
    assert out["rel_err"]["cells-tf32"] <= 1e-6
    assert out["rel_err"]["all-tf32"] <= 1e-6
    assert 0 < out["rel_err"]["bf16-patch"] <= BOX_BF16_TOL


def test_adaptive_prec_lab_restores_its_patches(prebuilt32, monkeypatch):
    saved = {name: BoxLaplaceOperator.__dict__[name]
             for name in adaptive_prec_lab.TRANSFERS}
    seen = {}
    real = adaptive_prec_lab.chain_seconds

    def chain(apply, x, n, what):
        if what.startswith("cells-tf32"):
            seen["tf32"] = torch.backends.cuda.matmul.allow_tf32
            seen["patched"] = all(
                BoxLaplaceOperator.__dict__[name] is not saved[name]
                for name in saved)
            raise FloatingPointError("made to raise")
        return real(apply, x, 2, what)

    monkeypatch.setattr(adaptive_prec_lab, "chain_seconds", chain)
    out = adaptive_prec_lab.main(prebuilt=prebuilt32[0], device="cpu",
                                 log=lambda s: None)
    assert seen == {"tf32": True, "patched": True}
    assert out["failed"] == {"cells-tf32": "FloatingPointError: made to "
                                           "raise"}
    assert set(out["gdofs"]) == {"f32", "all-tf32", "bf16-patch"}
    for name, sm in saved.items():
        assert BoxLaplaceOperator.__dict__[name] is sm
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_adaptive_solve_lab_counts():
    mp = pytest.MonkeyPatch()
    mp.setattr(t_cheb, "power_start", tpufem_start)
    try:
        pre64 = bmop.build_adaptive_op(*SHAPE, "float64", device="cpu")
        lab = adaptive_solve_lab.main(*SHAPE[2:], device="cpu",
                                      prebuilt=pre64, log=lambda s: None)
        rb = bmop.bench_adaptive_solve(*SHAPE, "float64", device="cpu")
    finally:
        mp.undo()
    rj = j_bmop.bench_adaptive_solve(*SHAPE, "float64")
    it = lab["iterations"]
    assert (lab["n_dofs"], lab["n_hanging"]) == (1657, 378)
    assert lab["levels"] == rb["levels"] == rj["levels"]
    assert it == {name: rb[f"{name}_iterations"] for name in ("jacobi",
                                                             "gmg")}
    for name in ("jacobi", "gmg"):
        assert it[name] == rj[f"{name}_iterations"], name
    assert list(lab["stages"]) == [
        "cuda_warmup", "diagonal", "mg_f32_build", "jacobi_warm",
        "jacobi_timed", "gmg_warm", "gmg_timed"]
    # f32 with the diagonal and hierarchy prebuilt, as chip_smoke.py passes
    # phase 10's: only the solves are timed, the bf16 cycle's count is
    # bmop's
    pre = bmop.build_adaptive_op(*SHAPE, "float32", device="cpu")
    r32 = bmop.bench_adaptive_solve(*SHAPE, "float32", prebuilt=pre,
                                    device="cpu", bf16_cycle=True)
    op = pre[3]
    diag = op.diagonal()
    mg = BoxMultigrid(pre[0], pre[1], constraints=pre[2], dtype="float32",
                      fine_op=op, fine_diag=diag, device=op.device)
    lab32 = adaptive_solve_lab.main(*SHAPE[2:], device="cpu",
                                    prebuilt=(*pre, diag, mg),
                                    log=lambda s: None)
    assert lab32["iterations"] == {
        "jacobi": r32["jacobi_iterations"], "gmg": r32["gmg_iterations"],
        "gmg16": r32["gmg_bf16cycle_iterations"]}
    assert list(lab32["stages"]) == [
        "cuda_warmup", "jacobi_warm", "jacobi_timed", "gmg_warm",
        "gmg_timed", "mg_bf16_recast", "gmg16_warm", "gmg16_timed"]


def test_labs_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: cg_blas1_lab.main((9, 9, 16), 1),
                 lambda: adaptive_prec_lab.main(1, 1),
                 lambda: adaptive_solve_lab.main(1, 1)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
