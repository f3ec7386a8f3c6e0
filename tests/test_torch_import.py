"""tpufem_torch imports no JAX, and never moves to the CPU on its own."""

import re
import subprocess
import sys
from pathlib import Path

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
        "print(sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    banned = re.compile(r"^\s*(import|from)\s+tpufem\.(ops|operators|solvers)",
                        re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
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
