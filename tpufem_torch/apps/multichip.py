"""The distributed layer's acceptance run: every distributed solve against
the single-device solve.

Port of ``__graft_entry__.py::dryrun_multichip``: eight sections, nine
parity lines, each a distributed solve over an in-process shard mesh
(``tpufem_torch.parallel``) whose iteration count must equal the
single-device solve's on the same device and whose solution must agree to
1e-9 relative:

1. 1-axis slab Jacobi-CG (``Partitioner``, 3D Q2, ``nbase = n_shards``);
2. 2-axis (2 x n/2) slab Jacobi-CG (``Partitioner2D``; even n);
3. slab GMG-CG, every level sharded (``DistributedGMG``);
4. general-partitioner Jacobi-CG on an adaptive 2D Q2 mesh with hanging
   nodes (``GeneralDistributedOperator``);
5. box-tier Jacobi-CG on an adaptive 3D Q2 mesh (``DistributedBoxLaplace``,
   2 x n/2 for even n, else n x 1);
6. box-tier GMG-CG (``DistributedBoxMultigrid``);
7. the "2-level" (host x device) mesh: section 2's slab CG and section
   6's box GMG-CG again, with the axes named as a pod's outer and inner
   axis (even n);
8. distributed Newton-Krylov on section 4's mesh, differentiated through
   the exchanges (equal Newton counts; the Krylov totals printed).

Run:  python -m tpufem_torch.apps.multichip --shards 8 [--device cpu]
(``--device cuda``, the default, puts every shard on the card when there
is one card).
"""

from __future__ import annotations

import argparse
import re
from typing import Callable

import numpy as np
import torch

from tpufem_torch.fem.assemble import assemble_rhs
from tpufem_torch.fem.constraints import make_hanging_node_constraints
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.operators.generic import NonlinearOperator
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops.boxes import BoxLaplaceOperator
from tpufem_torch.ops.matrix_free import MatrixFree, resolve_device
from tpufem_torch.parallel.box_multigrid import DistributedBoxMultigrid
from tpufem_torch.parallel.boxes import DistributedBoxLaplace
from tpufem_torch.parallel.distributed import (
    distributed_cg_solve,
    distributed_cg_solve_2d,
)
from tpufem_torch.parallel.general import (
    GeneralDistributedOperator,
    GeneralPartitioner,
)
from tpufem_torch.parallel.mesh import to_host
from tpufem_torch.parallel.multigrid import distributed_gmg_cg_solve
from tpufem_torch.parallel.partitioner import Partitioner, Partitioner2D
from tpufem_torch.solvers.box_multigrid import BoxMultigrid
from tpufem_torch.solvers.cg import cg_solve, make_jacobi
from tpufem_torch.solvers.multigrid import GeometricMultigrid
from tpufem_torch.utils.config import FemConfig

# the JAX record's line names (MULTICHIP_r05.json) -> this module's keys
_RECORD_NAMES = {
    r"^1-axis Jacobi-CG": "1-axis Jacobi-CG",
    r"^2-axis \(\d+x\d+\) Jacobi-CG": "2-axis Jacobi-CG",
    r"^distributed GMG-CG": "slab GMG-CG",
    r"^general-partitioner adaptive Jacobi-CG": "general adaptive Jacobi-CG",
    r"^distributed box-tier adaptive CG": "box-tier CG",
    r"^distributed box-tier adaptive GMG-CG": "box-tier GMG-CG",
    r"^2-level mesh \(host x device\) Jacobi-CG": "2-level Jacobi-CG",
    r"^2-level mesh \(host x device\) box-tier GMG-CG": "2-level box GMG-CG",
    r"^distributed Newton-Krylov": "Newton-Krylov",
}
X_TOL = 1e-9


def record_counts(tail: str) -> dict:
    """{section key: distributed iterations (Newton steps)} from the
    printed lines of the JAX package's ``dryrun_multichip``."""
    out = {}
    for line in tail.splitlines():
        line = line.strip()
        m = re.match(r"^(.*?): (\d+) (?:iters|Newton steps)", line)
        if not m:
            continue
        for pat, key in _RECORD_NAMES.items():
            if re.match(pat, m.group(1)):
                out[key] = int(m.group(2))
    return out


def _rel(x, x_ref) -> float:
    x, x_ref = np.asarray(x, np.float64), np.asarray(x_ref, np.float64)
    return float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))


def _build(dim, degree, refine, dtype, device, nbase=1):
    mesh = Mesh.hyper_cube(dim, refine, nbase=nbase)
    dofs = DoFHandler(mesh, degree)
    mf = MatrixFree.build(mesh, dofs,
                          FemConfig(dim=dim, degree=degree, dtype=dtype),
                          device)
    return mesh, dofs, mf


def dryrun(n_shards: int, device: torch.device | str = "cuda",
           dtype: str = "float64", rtol: float = 1e-10,
           log: Callable[[str], None] = print) -> list[dict]:
    """Run the eight sections over ``n_shards`` shards on ``device``;
    each parity line is checked (equal iterations, x within ``X_TOL``;
    AssertionError otherwise), logged, and returned as
    {section, iterations, single, rel}."""
    device = resolve_device(device)
    lines: list[dict] = []

    def parity(section, x_dist, iters_dist, res_single, x_single=None):
        xs = to_host(res_single.x) if x_single is None else x_single
        rel = _rel(x_dist, xs)
        it_s = int(res_single.iterations)
        assert bool(res_single.converged), (
            f"{section}: single-device solve did not converge")
        assert iters_dist == it_s, (
            f"{section}: distributed {iters_dist} iters != single-device "
            f"{it_s}")
        assert rel <= X_TOL, f"{section}: solution rel diff {rel:.3e}"
        lines.append(dict(section=section, iterations=int(iters_dist),
                          single=it_s, rel=rel))
        log(f"{section}: {iters_dist} iters == single-device, rel diff "
            f"{rel:.2e} <= {X_TOL} — parity OK")

    rng = np.random.default_rng(0)
    dim, degree = 3, 2
    even = n_shards % 2 == 0

    # ---- 1. one-axis slab Jacobi-CG ---------------------------------------
    # nbase = n_shards makes cells per axis divisible for any shard count
    mesh, dofs, mf = _build(dim, degree, 1, dtype, device, nbase=n_shards)
    op = LaplaceOperator(mf)
    diag = op.diagonal()
    mask = to_host(mf.interior_mask)
    b = mask * rng.standard_normal(dofs.n_dofs)
    bt = torch.as_tensor(b, dtype=diag.dtype, device=device)
    res_s = cg_solve(op.vmult, bt, M_inv=make_jacobi(diag), rtol=rtol)
    part = Partitioner(dim=dim, n=2 * n_shards, p=degree, n_shards=n_shards)
    x_d, iters, _ = distributed_cg_solve(
        part, mf.S, mf.D_col, mf.struct_scale, mf.struct_w, mask,
        to_host(diag), b, rtol=rtol)
    parity("1-axis Jacobi-CG", x_d, iters, res_s)

    # ---- 2. two-axis (sz x sy) mesh ----------------------------------------
    if even:
        sz, sy = 2, n_shards // 2
        b2 = mask * rng.standard_normal(dofs.n_dofs)
        b2t = torch.as_tensor(b2, dtype=diag.dtype, device=device)
        res_s2 = cg_solve(op.vmult, b2t, M_inv=make_jacobi(diag), rtol=rtol)
        part2 = Partitioner2D(dim=dim, n=2 * n_shards, p=degree,
                              shards_z=sz, shards_y=sy)
        x_d2, iters2, _ = distributed_cg_solve_2d(
            part2, mf.S, mf.D_col, mf.struct_scale, mf.struct_w, mask,
            to_host(diag), b2, rtol=rtol)
        parity("2-axis Jacobi-CG", x_d2, iters2, res_s2)

    # ---- 3. slab GMG-CG (every level sharded) ------------------------------
    gmg = GeometricMultigrid(2, 2, 1, coarsest_refine=0, dtype=dtype,
                             nbase=n_shards, device=device)
    fine = gmg.fine
    b3 = to_host(fine.mask) * rng.standard_normal(fine.mf.n_dofs)
    res_s3 = cg_solve(fine.op.vmult, torch.as_tensor(
        b3, dtype=fine.mask.dtype, device=device),
        M_inv=gmg.preconditioner(), rtol=rtol)
    x_d3, iters3, _ = distributed_gmg_cg_solve(gmg, n_shards, b3, rtol=rtol)
    parity("slab GMG-CG", x_d3, iters3, res_s3)

    # ---- 4. general partitioner: adaptive mesh with hanging nodes ----------
    mesh4 = Mesh.hyper_cube(2, 3)
    centers = (mesh4.origins + mesh4.sizes[:, None] * 0.5) / mesh4.U
    mesh4 = mesh4.refine(np.linalg.norm(centers - 0.3, axis=1) < 0.4)
    dofs4 = DoFHandler(mesh4, 2)
    ac4 = make_hanging_node_constraints(dofs4)
    mf4 = MatrixFree.build(mesh4, dofs4,
                           FemConfig(2, 2, dtype=dtype, scatter="incidence"),
                           device, constraints=ac4)
    op4 = LaplaceOperator(mf4)
    diag4 = op4.diagonal()
    b4 = to_host(mf4.interior_mask) * rng.standard_normal(dofs4.n_dofs)
    res_s4 = cg_solve(op4.vmult, torch.as_tensor(
        b4, dtype=diag4.dtype, device=device), M_inv=make_jacobi(diag4),
        rtol=rtol, maxiter=500)
    part4 = GeneralPartitioner.build(mf4, n_shards)
    dop4 = GeneralDistributedOperator(part4)
    x_d4, iters4, _ = dop4.cg_solve(b4, to_host(diag4), rtol=rtol,
                                    maxiter=500)
    parity("general adaptive Jacobi-CG", x_d4, iters4, res_s4)

    # ---- 5. the box tier on an adaptive mesh -------------------------------
    mesh5 = Mesh.hyper_cube(3, 1)
    for _ in range(2):
        c5 = (mesh5.origins + mesh5.sizes[:, None] * 0.5) / mesh5.U
        mesh5 = mesh5.refine(np.linalg.norm(c5 - 0.31, axis=1) < 0.35)
    dofs5 = DoFHandler(mesh5, 2)
    ac5 = make_hanging_node_constraints(dofs5)
    gop5 = BoxLaplaceOperator(mesh5, dofs5, constraints=ac5, dtype=dtype,
                              device=device)
    # 2-axis (z x y) shard mesh when n is even, else 1-axis
    shards5 = (2, n_shards // 2) if even else (n_shards, 1)
    dop5 = DistributedBoxLaplace(gop5, shards=shards5)
    b5 = gop5.interior_mask * gop5.to_patch(
        rng.standard_normal(dofs5.n_dofs))
    diag5 = gop5.diagonal()
    res_s5 = gop5.cg_solve(b5, diag5, rtol=rtol)
    res_d5 = dop5.cg_solve(dop5.put_vector(b5), dop5.diagonal_local(diag5),
                           rtol=rtol)
    parity("box-tier CG", dop5.from_local(res_d5.x), int(res_d5.iterations),
           res_s5)

    # ---- 6. box-tier adaptive GMG-CG ---------------------------------------
    mg6 = BoxMultigrid(mesh5, dofs5, constraints=ac5, dtype=dtype,
                       fine_op=gop5, fine_diag=diag5, device=device)
    b6 = b5 * gop5._dev(mg6.fine.nh_mask)
    res_s6 = mg6.cg_solve(b6, rtol=rtol)
    dmg6 = DistributedBoxMultigrid(dop5, mg6)
    res_d6 = dmg6.cg_solve(dop5.put_vector(b6), rtol=rtol)
    own6 = to_host(gop5.w_owner) > 0
    x6s = to_host(res_s6.x)
    parity("box-tier GMG-CG", dop5.from_local(res_d6.x)[own6],
           int(res_d6.iterations), res_s6, x_single=x6s[own6])

    # ---- 7. the 2-level (host x device) mesh -------------------------------
    if even:
        part7 = Partitioner2D(dim=dim, n=2 * n_shards, p=degree, shards_z=2,
                              shards_y=n_shards // 2, axis_z="host",
                              axis_y="device")
        x_d7, iters7, _ = distributed_cg_solve_2d(
            part7, mf.S, mf.D_col, mf.struct_scale, mf.struct_w, mask,
            to_host(diag), b2, rtol=rtol)
        parity("2-level Jacobi-CG", x_d7, iters7, res_s2)
        dop7 = DistributedBoxLaplace(gop5, shards=(2, n_shards // 2),
                                     axis_name="host")
        dop7.diagonal_local(diag5)
        dmg7 = DistributedBoxMultigrid(dop7, mg6)
        res_d7 = dmg7.cg_solve(dop7.put_vector(b6), rtol=rtol)
        parity("2-level box GMG-CG", dop7.from_local(res_d7.x)[own6],
               int(res_d7.iterations), res_s6, x_single=x6s[own6])

    # ---- 8. distributed Newton-Krylov on the adaptive mesh -----------------
    # the quasilinear residual's AD linearisation differentiates through
    # the exchanges; the forcing and the line search run on psum'd scalars
    def qop8(vals, grads, ctx):
        return None, (1.0 + vals**2)[:, None, :] * grads

    b8 = assemble_rhs(
        dofs4,
        lambda pts: np.sin(np.pi * pts[:, 0]) * np.cos(np.pi * pts[:, 1]))
    op8 = NonlinearOperator(mf4, qop8)
    ref8 = op8.solve(b8, rtol=1e-11)
    assert ref8.converged and not ref8.stalled, (
        "single-device Newton did not converge")
    dop8 = GeneralDistributedOperator(part4, quad_op=qop8,
                                      needs_values=True)
    res8 = dop8.newton_solve(b8, rtol=1e-11)
    assert res8.converged, "distributed Newton did not converge"
    it8, it8s = int(res8.iterations), int(ref8.iterations)
    assert it8 == it8s, (
        f"distributed Newton {it8} steps != single-device {it8s}")
    rel8 = _rel(res8.x, to_host(ref8.x))
    assert rel8 <= X_TOL, f"distributed Newton rel diff {rel8:.2e}"
    lines.append(dict(section="Newton-Krylov", iterations=it8, single=it8s,
                      rel=rel8, krylov=int(res8.linear_iterations),
                      krylov_single=int(ref8.linear_iterations)))
    log(f"Newton-Krylov ({len(ac4.lines)} hanging nodes): {it8} Newton "
        f"steps == single-device, {int(res8.linear_iterations)} vs "
        f"{int(ref8.linear_iterations)} inner Krylov its, rel diff "
        f"{rel8:.2e} <= {X_TOL} — parity OK")
    log(f"dryrun({n_shards}): all distributed solves match single-device "
        "iteration counts and solutions — OK")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when CUDA is absent")
    args = ap.parse_args(argv)
    dryrun(args.shards, device=args.device, dtype=args.dtype)
    return None  # console-script exit code


if __name__ == "__main__":
    main()
