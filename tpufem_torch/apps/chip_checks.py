"""On-card determinism and accuracy checks, diffed against a golden.

Port of ``scripts/chip_checks.py``: the same six records under the same
names and keys, each with ``"device"`` (the card's name, or "cpu") added.
The port's solvers take fixed-order dots and run deterministic
algorithms (``utils.precision``), so two runs of the same solve must take
the same iterations and return bitwise-equal solutions; this script holds
that on the card in f32 and spot-checks the kernels' accuracy classes:

  - two Jacobi-CG solves (3D Q4 refine 5, ``scatter="separable",
    use_pallas=True``: K2) with equal iterations and bitwise-equal x;
  - the same for the GMG-CG (``GeometricMultigrid(3, 4, 5,
    coarsest_refine=1, use_pallas=True)``: K2 on every level);
  - K2's apply against the structured tier's (rel < 1e-6);
  - GMRES (2D Q2 refine 4, convection-diffusion, restart 30) twice;
  - the quasilinear Newton solve (rtol 1e-4) twice, which must converge;
  - K4 (``ResidentTerms``) on the Helmholtz terms at npts 65 against the
    f64 tensor-product oracle (rel < 5e-6).

On the CPU, as the reference does there: refine 3 and the structured
tier; the ``ResidentTerms`` record, which the reference leaves out there,
holds K4's plain version (an artifact that must not be diffed against a
card's golden: its platform is "cpu").

Every failing check raises ``AssertionError`` after its record is printed.
``--out`` writes ``{"platform", "records"}`` for
``tpufem_torch.apps.check_chip_goldens``, which diffs it against the
committed H100 golden (``tpufem_torch/goldens/chip_checks_h100.json``).

Run:  python -m tpufem_torch.apps.chip_checks [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.generic import (
    NonlinearOperator,
    convection_diffusion_operator,
)
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.operators.tensor_product import helmholtz_separable_terms
from tpufem_torch.ops.kernel_terms import ResidentTerms
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.solvers.cg import cg_solve
from tpufem_torch.solvers.gmres import gmres_solve
from tpufem_torch.solvers.multigrid import GeometricMultigrid
from tpufem_torch.utils.config import FemConfig
from tpufem_torch.utils.timer import synchronize

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "chiprun_out"
               / "chip_checks.json")


def platform_of(device: torch.device) -> str:
    """The artifact's platform: "gpu" on a CUDA device, else its type."""
    return "gpu" if device.type == "cuda" else device.type


def quasi_qop(vals, grads, ctx):
    return None, (1.0 + vals**2)[:, None, :] * grads


def main(out: str | Path | None = None,
         device: torch.device | str = "cuda", log=print) -> list[dict]:
    """Run the checks on ``device``; returns the records (and writes the
    artifact to ``out`` when given).  Raises AssertionError on the
    first failing check, after printing its record.  The
    ``ResidentTerms`` record is written on every device: on the CPU it
    holds K4's plain version (the reference skips it there, having no
    Pallas kernel to run)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else device.type
    records: list[dict] = []

    def record(rec):
        rec["device"] = name
        records.append(rec)
        log(json.dumps(rec))

    def twice(fn):
        r1 = fn()
        synchronize(device)
        r2 = fn()
        synchronize(device)
        return r1, r2

    refine = 5 if on_card else 3
    dim, p = 3, 4
    mesh = Mesh.hyper_cube(dim, refine)
    dofs = DoFHandler(mesh, p)
    mf = MatrixFree.build(
        mesh, dofs,
        FemConfig(dim=dim, degree=p, dtype="float32",
                  scatter="separable" if on_card else "structured",
                  use_pallas=on_card), device)
    op = LaplaceOperator(mf)
    diag = op.diagonal()
    rng = np.random.default_rng(42)
    mask = mf.interior_mask.to("cpu", torch.float64).numpy()
    b = torch.as_tensor(mask * rng.standard_normal(dofs.n_dofs),
                        dtype=torch.float32, device=device)

    inv_diag = 1.0 / diag
    r1, r2 = twice(lambda: cg_solve(op.vmult, b,
                                    M_inv=lambda r: inv_diag * r, rtol=1e-5))
    bitwise = bool(torch.equal(r1.x, r2.x))
    same_iters = r1.iterations == r2.iterations
    record({
        "check": "jacobi_cg_run_to_run_determinism",
        "platform": platform_of(device),
        "n_dofs": dofs.n_dofs, "dtype": "float32",
        "iterations": [r1.iterations, r2.iterations],
        "bitwise_identical_solutions": bitwise,
        "pass": bool(bitwise and same_iters),
    })
    assert bitwise and same_iters

    gmg = GeometricMultigrid(dim, p, refine, coarsest_refine=1,
                             dtype="float32", use_pallas=on_card,
                             device=device)
    m_inv = gmg.preconditioner()
    m1, m2 = twice(lambda: cg_solve(gmg.fine.op.vmult, b, M_inv=m_inv,
                                    rtol=1e-5))
    bitwise_mg = bool(torch.equal(m1.x, m2.x))
    same_mg = m1.iterations == m2.iterations
    record({
        "check": "gmg_cg_run_to_run_determinism",
        "n_dofs": dofs.n_dofs,
        "iterations": [m1.iterations, m2.iterations],
        "bitwise_identical_solutions": bitwise_mg,
        "pass": bool(bitwise_mg and same_mg),
    })
    assert bitwise_mg and same_mg
    del gmg, m_inv, m1, m2

    # the apply's accuracy against the structured tier (f32 both)
    mf_s = MatrixFree.build(mesh, dofs, FemConfig(
        dim=dim, degree=p, dtype="float32", scatter="structured"), device)
    y_ref = LaplaceOperator(mf_s).vmult_raw(b).to("cpu", torch.float64)
    y = op.vmult_raw(b).to("cpu", torch.float64)
    rel = float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref))
    record({
        "check": "fused_kernel_accuracy_vs_structured",
        "rel_err": rel, "pass": rel < 1e-6,
    })
    assert rel < 1e-6
    del mf_s, mf, op, diag, inv_diag, r1, r2

    # the solver family: GMRES and Newton-CG run to run
    mesh2 = Mesh.hyper_cube(2, 4)
    dofs2 = DoFHandler(mesh2, 2)
    mf2 = MatrixFree.build(mesh2, dofs2, FemConfig(
        dim=2, degree=2, dtype="float32", scatter="incidence"), device)
    cd = convection_diffusion_operator(
        mf2,
        lambda pts: np.tile(np.array([0.7, -0.4]), (pts.shape[0], 1)),
        nu=0.05)
    b2 = torch.as_tensor(
        mf2.interior_mask.to("cpu", torch.float64).numpy()
        * rng.standard_normal(dofs2.n_dofs), dtype=torch.float32,
        device=device)
    g1, g2 = twice(lambda: gmres_solve(cd.vmult, b2, rtol=1e-5, restart=30))
    bitwise_g = bool(torch.equal(g1.x, g2.x))
    same_g = g1.iterations == g2.iterations
    record({
        "check": "gmres_run_to_run_determinism",
        "n_dofs": dofs2.n_dofs, "dtype": "float32",
        "iterations": [g1.iterations, g2.iterations],
        "bitwise_identical_solutions": bitwise_g,
        "pass": bool(bitwise_g and same_g),
    })
    assert bitwise_g and same_g

    nop = NonlinearOperator(mf2, quasi_qop)
    n1, n2 = twice(lambda: nop.solve(b2, rtol=1e-4))
    bitwise_n = bool(torch.equal(n1.x, n2.x))
    same_n = (n1.iterations == n2.iterations
              and n1.linear_iterations == n2.linear_iterations)
    record({
        "check": "newton_cg_run_to_run_determinism",
        "n_dofs": dofs2.n_dofs, "dtype": "float32",
        "newton_iterations": [n1.iterations, n2.iterations],
        "linear_iterations": [n1.linear_iterations, n2.linear_iterations],
        "converged": bool(n1.converged),
        "bitwise_identical_solutions": bitwise_n,
        "pass": bool(bitwise_n and same_n and n1.converged),
    })
    assert bitwise_n and same_n and n1.converged

    # K4's accuracy class: the Helmholtz terms apply against the f64
    # tensor-product oracle on the same 1D factors
    n_ax = 1 << 4
    npts_r = n_ax * p + 1
    h3 = np.full(3, 1.0 / n_ax)
    terms = helmholtz_separable_terms(p, 3, p + 1, n_ax, h3, 1.0, 1.0)
    rk = ResidentTerms(npts_r, p, terms, "float32", mode="f32",
                       device=device)
    xr = rng.standard_normal(npts_r**3)
    yk = rk.unpad(rk.raw(rk.pad(torch.as_tensor(
        xr, dtype=torch.float32, device=device)))).to(
            "cpu", torch.float64).numpy()
    t3 = xr.reshape((npts_r,) * 3)
    y_or = np.zeros_like(t3)
    for t in terms:
        m = t3
        # tensor index order is (z, y, x): axis a pairs with t[2 - a]
        for a in range(3):
            tm = np.asarray(t[2 - a], np.float64)
            m = np.moveaxis(np.tensordot(tm, m, axes=(1, a)), 0, a)
        y_or += m
    rel_r = float(np.linalg.norm(yk - y_or.reshape(-1))
                  / np.linalg.norm(y_or))
    record({
        "check": "resident_terms_accuracy_vs_f64_oracle",
        "n_dofs": npts_r**3, "rel_err": rel_r, "pass": rel_r < 5e-6,
    })
    assert rel_r < 5e-6
    if out:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"platform": platform_of(device),
                                        "records": records}, indent=1))
        log(f"chip_checks: wrote {out}")
    log("chip_checks: ALL PASSED")
    return records


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="write the machine-diffable record artifact here")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent "
                         "(a CPU artifact must not be diffed against the "
                         "card's golden)")
    args = ap.parse_args(argv)
    main(args.out, device=args.device)


if __name__ == "__main__":
    cli()
