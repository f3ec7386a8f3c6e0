"""tpufem_torch imports neither JAX nor the JAX package, and never moves
to the CPU on its own."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpufem_torch
from tpufem_torch.apps import poisson as tpoisson

PKG = Path(tpufem_torch.__file__).resolve().parent
REPO = PKG.parent


def test_import_and_cpu_solve_leave_jax_out():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = (
        "import sys\n"
        "from tpufem_torch.apps.poisson import solve_poisson\n"
        "r = solve_poisson(dim=2, degree=2, refine=2, use_pallas=True, "
        "device='cpu')\n"
        "assert r.converged and r.l2_error < 1e-2, r\n"
        "r = solve_poisson(dim=2, degree=2, refine=2, device='cpu')\n"
        "assert r.converged and r.l2_error < 1e-2, r\n"
        "r = solve_poisson(dim=2, degree=2, refine=1, adaptive_steps=1, "
        "device='cpu')\n"
        "assert r.converged and r.l2_error < 1e-1, r\n"
        "print(sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib'))))\n"
        "print(sorted(m for m in sys.modules if m == 'tpufem' "
        "or m.startswith('tpufem.')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "[]"]


CELL_LOOP_MODULES = (
    "tpufem_torch.ops.tensor_ops", "tpufem_torch.ops.structured",
    "tpufem_torch.ops.dense_local", "tpufem_torch.ops.diagonal",
    "tpufem_torch.fem.coloring", "tpufem_torch.fem.constraints",
    "tpufem_torch.fem.estimator", "tpufem_torch.utils.native")


def test_cell_loop_modules_import_without_jax():
    """The modules of the cell-loop tiers, each imported in a fresh
    interpreter with the AMR loop run: no jax or tpufem module loads."""
    code = (
        "import importlib, sys\n"
        f"for m in {CELL_LOOP_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpufem_torch.apps.poisson import solve_poisson_amr\n"
        "rs = solve_poisson_amr(dim=2, degree=1, refine=1, cycles=2, "
        "device='cpu')\n"
        "assert rs[-1].n_cells > rs[0].n_cells\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpufem')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_multigrid_solves_leave_jax_out():
    """A fresh CPU solve_poisson_mg (the bf16 hierarchy too), a resident
    GMG-CG and a Chebyshev solve_poisson load no jax or tpufem module."""
    code = (
        "import sys, torch\n"
        "from tpufem_torch.apps.poisson import solve_poisson\n"
        "from tpufem_torch.apps.poisson_mg import solve_poisson_mg\n"
        "from tpufem_torch.fem import transfer  # noqa: F401\n"
        "from tpufem_torch.solvers.multigrid import GeometricMultigrid\n"
        "from tpufem_torch.solvers.resident import resident_gmg_cg\n"
        "r = solve_poisson_mg(dim=2, degree=2, refine=3, device='cpu')\n"
        "assert r['iterations'] <= 10 and r['l2_error'] < 1e-3, r\n"
        "r = solve_poisson_mg(dim=2, degree=2, refine=3, dtype='float32', "
        "precond_dtype='bfloat16', device='cpu')\n"
        "assert r['l2_error'] < 1e-3, r\n"
        "mg = GeometricMultigrid(3, 2, 2, use_pallas=True, device='cpu')\n"
        "b = mg.fine.mask * torch.ones(mg.fine.mf.n_dofs, "
        "dtype=torch.float64)\n"
        "assert resident_gmg_cg(mg, b, rtol=1e-8).converged\n"
        "r = solve_poisson(dim=2, degree=2, refine=2, precond='chebyshev', "
        "device='cpu')\n"
        "assert r.converged, r\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpufem')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


BOX_MODULES = (
    "tpufem_torch.ops.box_interface", "tpufem_torch.ops.box_pairs",
    "tpufem_torch.ops.boxes", "tpufem_torch.solvers.box_multigrid")


def test_box_tier_leaves_jax_out():
    """The box tier's modules, each imported in a fresh interpreter, and a
    CPU box solve with each preconditioner: no jax or tpufem module
    loads."""
    code = (
        "import importlib, sys\n"
        f"for m in {BOX_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpufem_torch.apps.poisson import solve_poisson\n"
        "for pc in ('jacobi', 'chebyshev', 'gmg', 'gmg-bf16'):\n"
        "    r = solve_poisson(dim=2, degree=2, refine=2, adaptive_steps=1, "
        "scatter='boxes', precond=pc, device='cpu')\n"
        "    assert r.converged and r.l2_error < 1e-2, (pc, r)\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpufem')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_do_not_import_jax_or_tpufem():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    banned = re.compile(r"^\s*(from|import)\s+tpufem(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        text = f.read_text()
        assert not pat.search(text), f
        assert not banned.search(text), f


def test_precision_settings_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.are_deterministic_algorithms_enabled()


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpoisson.solve_poisson(dim=2, degree=1, refine=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tpoisson.main(["--dim", "2", "--refine", "2"])


def test_kernels_default_to_the_card(monkeypatch):
    """Named no device, the resident kernels and the bridge go to the card,
    and raise without one; only device="cpu" runs the plain version."""
    from tpufem_torch.bridge import matrix_free_from_arrays
    from tpufem_torch.fem.dof_handler import DoFHandler
    from tpufem_torch.fem.mesh import Mesh
    from tpufem_torch.ops.kernel_separable import ResidentSeparable
    from tpufem_torch.ops.kernel_terms import ResidentTerms, ResidentTerms2D
    from tpufem_torch.ops.separable import global_1d_matrices
    from tpufem_torch.utils.config import FemConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, n = 2, 2
    npts = n * p + 1
    K, M = global_1d_matrices(p, n, p + 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentSeparable(npts, p, [K] * 3, [M] * 3, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentTerms(npts, p, [[K, M, M]], torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentTerms2D(npts, p, [[K, M]], torch.float32)
    mesh = Mesh.hyper_cube(2, 1)
    dofs = DoFHandler(mesh, p)
    arrays = {"Ks": [K, K], "Ms": [M, M],
              "interior_mask": np.ones(dofs.n_dofs),
              "diagonal": np.ones(dofs.n_dofs)}
    cfg = FemConfig(dim=2, degree=p, scatter="separable")
    with pytest.raises(RuntimeError, match="cuda"):
        matrix_free_from_arrays(cfg, mesh, dofs, arrays)
    assert matrix_free_from_arrays(cfg, mesh, dofs, arrays,
                                   "cpu").device.type == "cpu"
    assert ResidentSeparable(npts, p, [K] * 3, [M] * 3, torch.float32,
                             device="cpu").device.type == "cpu"


OPERATOR_MODULES = (
    "tpufem_torch.operators.generic", "tpufem_torch.operators.tensor_product",
    "tpufem_torch.operators.vector", "tpufem_torch.solvers.bicgstab",
    "tpufem_torch.solvers.gmres", "tpufem_torch.solvers.newton",
    "tpufem_torch.solvers.vector_multigrid", "tpufem_torch.apps.heat",
    "tpufem_torch.apps.nonlinear", "tpufem_torch.apps.elasticity")


def test_operator_families_leave_jax_out():
    """The operator families' modules, each imported in a fresh
    interpreter, then CPU heat runs (generic and tensor-product tier), a
    Newton solve and a fast-tier elasticity solve: no jax or tpufem module
    loads."""
    code = (
        "import importlib, sys\n"
        f"for m in {OPERATOR_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpufem_torch.apps.heat import run_heat\n"
        "from tpufem_torch.apps.nonlinear import run_nonlinear\n"
        "from tpufem_torch.apps.elasticity import run_elasticity\n"
        "for res in (False, True):\n"
        "    r = run_heat(dim=2, degree=2, refine=2, steps=2, "
        "resident=res, device='cpu')\n"
        "    assert r['l2_error'] < 1e-2, r\n"
        "o, _ = run_nonlinear(dim=2, degree=2, refine=2, precond='jacobi', "
        "device='cpu')\n"
        "assert o['converged'], o\n"
        "o, _ = run_elasticity(dim=2, degree=2, refine=2, fast=True, "
        "device='cpu')\n"
        "assert o['converged'], o\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpufem')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_operator_entry_points_default_to_the_card(monkeypatch):
    """run_heat, run_nonlinear, run_elasticity and VectorMultigrid take
    device="cuda" unless told otherwise, and raise without a card."""
    from tpufem_torch.apps.elasticity import run_elasticity
    from tpufem_torch.apps.heat import run_heat
    from tpufem_torch.apps.nonlinear import run_nonlinear
    from tpufem_torch.solvers.vector_multigrid import VectorMultigrid

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run_heat(dim=2, degree=1, refine=1, steps=1),
                 lambda: run_nonlinear(dim=2, degree=1, refine=1),
                 lambda: run_elasticity(dim=2, degree=1, refine=1),
                 lambda: VectorMultigrid(2, 1, 2)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_bench_apps_leave_jax_out():
    """CPU records of bmop (default tier with the SpMV, the resident and
    curved kernel tiers, the adaptive box tier) and bmspmv, with the
    metrics and debug utilities, in a fresh interpreter: no jax or tpufem
    module loads."""
    code = (
        "import sys\n"
        "from tpufem_torch.apps import bmop, bmspmv\n"
        "from tpufem_torch.utils import debug, metrics\n"
        "r = bmspmv.bench_spmv(2, 2, 2, 'float64', 1, device='cpu')\n"
        "assert r['csr_cross_check_rel_err'] < 1e-12, r\n"
        "recs = [bmop.bench_config(2, 2, 2, 'float32', 'auto', 1, "
        "with_spmv=True, device='cpu'),\n"
        "        bmop.bench_resident(2, 2, 'float32', 2, dim=2, "
        "device='cpu'),\n"
        "        bmop.bench_curved(3, 1, 1, 'float32', 2, device='cpu'),\n"
        "        bmop.bench_adaptive(2, 1, 2, 1, 'float32', 2, "
        "device='cpu')]\n"
        "debug.check_finite(r['gdofs_per_s'])\n"
        "for rec in recs:\n"
        "    metrics.emit(rec)\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpufem')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_bench_entry_points_default_to_the_card(monkeypatch):
    """bmop's and bmspmv's benchmarks take device="cuda" unless told
    otherwise, and raise without a card before they build anything."""
    from tpufem_torch.apps import bmop, bmspmv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bmop.bench_resident(2, 2, "float32", 2),
                 lambda: bmop.bench_resident(2, 3, "float32", 2, dim=2),
                 lambda: bmop.bench_varcoef(3, 2, 2, "float32", 2),
                 lambda: bmop.bench_curved(3, 2, 1, "float32", 2),
                 lambda: bmop.bench_config(2, 2, 2, "float32", "auto", 2),
                 lambda: bmop.build_adaptive_op(3, 2, 2, 1, "float32"),
                 lambda: bmspmv.bench_spmv(2, 2, 2, "float32", 2),
                 lambda: bmop.main(["--dim", "2", "--degrees", "1"]),
                 lambda: bmspmv.main(["--dim", "2", "--degrees", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


PARALLEL_MODULES = (
    "tpufem_torch.parallel.mesh", "tpufem_torch.parallel.partitioner",
    "tpufem_torch.parallel.distributed", "tpufem_torch.parallel.multigrid",
    "tpufem_torch.parallel.general", "tpufem_torch.parallel.vector",
    "tpufem_torch.parallel.boxes", "tpufem_torch.parallel.box_multigrid",
    "tpufem_torch.apps.multichip", "tpufem_torch.apps.distributed_probe")


def test_distributed_layer_leaves_jax_out():
    """The distributed layer's modules, apps.multichip and
    apps.distributed_probe, each imported in a fresh interpreter, and a
    CPU distributed box GMG solve and
    general-partitioner CG: no jax or tpufem module loads."""
    code = (
        "import importlib, sys, torch\n"
        "torch.set_num_threads(1)  # many small sharded ops\n"
        f"for m in {PARALLEL_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpufem_torch.apps.poisson import solve_poisson\n"
        "from tpufem_torch.apps.elasticity import run_elasticity\n"
        "r = solve_poisson(dim=3, degree=1, refine=1, adaptive_steps=1, "
        "precond='gmg', shards=(2, 2), device='cpu')\n"
        "assert r.converged, r\n"
        "m, _ = run_elasticity(dim=2, degree=1, refine=2, shards=2, "
        "device='cpu')\n"
        "assert m['converged'], m\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpufem')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_distributed_entry_points_default_to_the_card(monkeypatch):
    """The shard mesh and the distributed entry points take
    device="cuda" unless told otherwise, and raise without a card."""
    from tpufem_torch.apps import distributed_probe, multichip
    from tpufem_torch.apps.heat import run_heat
    from tpufem_torch.apps.poisson import solve_poisson
    from tpufem_torch.parallel.mesh import ShardMesh
    from tpufem_torch.parallel.partitioner import Partitioner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ShardMesh((2,), ("shard",)),
                 lambda: Partitioner(2, 4, 1, 2).device_mesh(),
                 lambda: solve_poisson(dim=2, refine=2, shards=2),
                 lambda: run_heat(dim=2, refine=2, steps=1, shards=2),
                 lambda: multichip.dryrun(2),
                 lambda: distributed_probe.main(["--refine", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


LAB_MODULES = (
    "tpufem_torch.lab.cg_blas1_lab", "tpufem_torch.lab.resident_mask_lab",
    "tpufem_torch.lab.adaptive_prec_lab",
    "tpufem_torch.lab.adaptive_solve_lab", "tpufem_torch.apps.chip_checks",
    "tpufem_torch.apps.check_chip_goldens", "tpufem_torch.apps.run_sweep",
    "tpufem_torch.apps.plot_benchmarks")


def test_solver_labs_leave_jax_out():
    """The solver labs, the chip checks and the sweep and plot tools, each
    imported in a fresh interpreter, then the BLAS-1 lab, the mask lab and
    ``multichip.entry`` on the CPU: no jax or tpufem module loads."""
    code = (
        "import importlib, sys\n"
        f"for m in {LAB_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpufem_torch.lab import cg_blas1_lab, resident_mask_lab\n"
        "from tpufem_torch.apps.multichip import entry\n"
        "cg_blas1_lab.main((5, 5, 16), 2, device='cpu', log=lambda s: 0)\n"
        "o = resident_mask_lab.run(1, 'f32', 1e-8, dtype='float64', "
        "device='cpu', log=lambda s: 0)\n"
        "assert o['verdict']['same_iterations'], o\n"
        "fn, args = entry(device='cpu')\n"
        "assert fn(*args).shape == args[0].shape\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpufem')])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
