"""Port parity for the assembled SpMV baseline (``tpufem_torch.ops.sparse``,
``apps/bmspmv.py``, ``bench_config(with_spmv=True)`` of ``apps/bmop.py``)
and the utilities ``utils/metrics.py`` and ``utils/debug.py``, against
tpufem on the CPU.

The padded-ELL arrays are bit-equal to the reference's, the apply agrees
with tpufem's ``ell_matvec`` and scipy's CSR product to 1e-13 in f64, and
every record key but the timings (``s_per_apply``, ``gdofs_per_s``,
``spmv_*_per_s``, ``mf_speedup_vs_spmv``, ``ts``) equals the reference's.
The CLIs run in a subprocess; the reference's in this process."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpufem.apps import bmop as j_bmop
from tpufem.apps import bmspmv as j_bmspmv
from tpufem.fem.assemble import assemble_laplace as j_assemble_laplace
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.ops import sparse as j_sparse
from tpufem_torch.apps import bmop, bmspmv
from tpufem_torch.ops import sparse as t_sparse
from tpufem_torch.utils import debug, metrics
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TIMINGS = {"s_per_apply", "gdofs_per_s", "spmv_s_per_apply",
           "spmv_gdofs_per_s", "mf_speedup_vs_spmv", "ts"}
SHAPES = {"2d_q2_r3": (2, 2, 3), "3d_q2_r2": (3, 2, 2)}


def _edge_csr():
    """A CSR with an empty row (2) and a row at full width (0), unsorted
    column order inside a row, and one explicit zero."""
    rows = [0] * 6 + [1, 1, 3, 3, 3, 4]
    cols = [5, 0, 3, 1, 4, 2, 2, 0, 5, 1, 3, 4]
    vals = np.random.default_rng(3).standard_normal(len(rows))
    vals[7] = 0.0
    A = sp.csr_matrix((vals, (rows, cols)), shape=(5, 6))
    A.sort_indices()
    perm = np.argsort(-A.indices[A.indptr[3]:A.indptr[4]])
    seg = slice(A.indptr[3], A.indptr[4])
    A.indices[seg], A.data[seg] = A.indices[seg][perm], A.data[seg][perm]
    return A


def _laplace(dim, p, refine):
    return j_assemble_laplace(JDoFHandler(JMesh.hyper_cube(dim, refine), p))


@pytest.mark.parametrize("case", ["2d_q3_r3", "3d_q2_r2", "edge"])
def test_from_csr_bit_equal_and_matvec(case):
    A = {"2d_q3_r3": lambda: _laplace(2, 3, 3),
         "3d_q2_r2": lambda: _laplace(3, 2, 2), "edge": _edge_csr}[case]()
    ej = j_sparse.EllMatrix.from_csr(A, jnp.float64)
    et = t_sparse.EllMatrix.from_csr(A, torch.float64, "cpu")
    assert et.indices.dtype == torch.int32
    assert np.array_equal(et.indices.numpy(), np.asarray(ej.indices))
    assert np.array_equal(et.values.numpy(), np.asarray(ej.values))
    assert et.n_cols == ej.n_cols and et.nnz_padded == ej.nnz_padded
    if case == "edge":
        assert et.indices.shape == (5, 6)
        assert not et.values[2].any() and et.values[0].all()
    x = np.random.default_rng(11).standard_normal(A.shape[1])
    y = et.matvec(torch.as_tensor(x)).numpy()
    yj = np.asarray(j_sparse.ell_matvec(ej.indices, ej.values,
                                        jnp.asarray(x)))
    ref = A @ x
    assert np.linalg.norm(y - yj) <= 1e-13 * np.linalg.norm(ref)
    assert np.linalg.norm(y - ref) <= 1e-13 * np.linalg.norm(ref)


def test_from_csr_in_float32():
    """Values rounded once from f64, as the reference's; int32 indices."""
    A = _laplace(2, 2, 2)
    et = t_sparse.EllMatrix.from_csr(A, "float32", "cpu")
    ej = j_sparse.EllMatrix.from_csr(A, jnp.float32)
    assert et.values.dtype == torch.float32
    assert np.array_equal(et.values.numpy(), np.asarray(ej.values))


def _check_record(rt, rj, cross_tol=None):
    assert set(rt) == set(rj)
    for key in set(rj) - TIMINGS - {"csr_cross_check_rel_err"}:
        assert rt[key] == rj[key], key
    if cross_tol is not None:
        assert rt["csr_cross_check_rel_err"] < cross_tol
        assert rj["csr_cross_check_rel_err"] < cross_tol
    assert all(np.isfinite(rt[k]) and rt[k] > 0 for k in TIMINGS & set(rt)
               if k != "ts")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bench_spmv_matches_tpufem(shape):
    dim, p, refine = SHAPES[shape]
    rt = bmspmv.bench_spmv(dim, p, refine, "float64", 2, device="cpu")
    rj = j_bmspmv.bench_spmv(dim, p, refine, "float64", 2)
    _check_record(rt, rj, cross_tol=1e-12)


def test_bench_spmv_cross_check_raises(monkeypatch):
    """A wrong SpMV fails the CSR cross-check with AssertionError at the
    reference's f32 tolerance (2e-5)."""
    mv = t_sparse.EllMatrix.matvec
    monkeypatch.setattr(t_sparse.EllMatrix, "matvec",
                        lambda self, x: mv(self, x) * (1 + 1e-4))
    with pytest.raises(AssertionError, match="rel err .* > 2e-05"):
        bmspmv.bench_spmv(2, 1, 2, "float32", 1, device="cpu")


@pytest.mark.parametrize("scatter",
                         ["auto", "structured", "separable", "incidence"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_bench_config_with_spmv_matches_tpufem(shape, scatter):
    dim, p, refine = SHAPES[shape]
    rt = bmop.bench_config(dim, p, refine, "float64", scatter, 2,
                           with_spmv=True, device="cpu")
    rj = j_bmop.bench_config(dim, p, refine, "float64", scatter, 2,
                             with_spmv=True)
    _check_record(rt, rj)


def _cli(module, args):
    return subprocess.run([sys.executable, "-m", module, "--cpu", *args],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)


def _last_line(text):
    return json.loads(text.strip().splitlines()[-1])


def test_bmspmv_cli(capsys):
    args = ["--dim", "2", "--degrees", "2", "--refine", "3", "--dtype",
            "float64", "--reps", "2"]
    r = _cli("tpufem_torch.apps.bmspmv", args)
    assert r.returncode == 0, r.stderr[-2000:]
    rt = _last_line(r.stdout)
    j_bmspmv.main(["--cpu", *args])
    _check_record(rt, _last_line(capsys.readouterr().out), cross_tol=1e-12)


def test_bmop_spmv_cli(capsys):
    """The default tier (auto: structured) beside the ELL SpMV, one record
    a degree."""
    args = ["--dim", "2", "--degrees", "1", "2", "--refine", "3", "--dtype",
            "float64", "--reps", "2", "--spmv"]
    r = _cli("tpufem_torch.apps.bmop", args)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    j_bmop.main(["--cpu", *args])
    jlines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(jlines) == 2
    for lt, lj in zip(lines, jlines):
        _check_record(json.loads(lt), json.loads(lj))


# ---- utils/metrics.py ---------------------------------------------------
def test_emit_prints_and_appends(tmp_path, monkeypatch, capsys):
    env_file, path_file = tmp_path / "env.jsonl", tmp_path / "path.jsonl"
    monkeypatch.setenv("TPUFEM_METRICS", str(env_file))
    metrics.emit({"bench": "x", "v": 1.5})
    metrics.emit({"bench": "y", "ts": 7.0}, path=str(path_file))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2
    a, b = (json.loads(line) for line in out)
    assert a["bench"] == "x" and a["v"] == 1.5 and "ts" in a
    assert b == {"bench": "y", "ts": 7.0}
    assert [json.loads(s) for s in env_file.read_text().splitlines()] == [a]
    assert [json.loads(s) for s in path_file.read_text().splitlines()] == [b]
    monkeypatch.delenv("TPUFEM_METRICS")
    metrics.emit({"bench": "z"})
    assert len(env_file.read_text().splitlines()) == 1


def test_profile_trace_writes_a_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "tr").glob("*.trace.json"))
    assert [str(f) for f in files] == [prof.trace_path]
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::cumsum" in names


# ---- utils/debug.py -------------------------------------------------------
def test_check_finite_counts_the_bad_values():
    x = torch.tensor([1.0, float("nan"), 2.0, float("inf"), -float("inf")])
    with pytest.raises(debug.NonFiniteError, match=r"^v: 3/5 non-finite"):
        debug.check_finite(x, "v")
    ok = torch.arange(4.0)
    assert debug.check_finite(ok) is ok
    assert debug.check_finite(np.ones(3)) is not None


@dataclasses.dataclass
class _Out:
    x: torch.Tensor
    n: int


@pytest.mark.parametrize("where", ["tuple", "dict", "dataclass", "list"])
def test_nan_guard_checks_every_tensor(where):
    good, bad = torch.ones(3), torch.tensor([0.0, float("nan")])

    def make(last):
        return {"tuple": lambda: (good, 3, last),
                "dict": lambda: {"a": good, "b": {"c": last}},
                "dataclass": lambda: (good, _Out(last, 1)),
                "list": lambda: [good, [good, last]]}[where]()

    fn = lambda last: make(last)  # noqa: E731
    guarded = debug.nan_guard(fn, "op")
    assert guarded(good) is not None
    with pytest.raises(debug.NonFiniteError, match="op output: 1/2"):
        guarded(bad)
    named = debug.nan_guard(make)
    with pytest.raises(debug.NonFiniteError, match="make output"):
        named(bad)



def test_chip_smoke_bench_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 12 at small sizes on the CPU (the plain
    versions): every record and check of the phase runs and passes, and no
    kernel launches here."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke

    res = chip_smoke.bench_phase(
        torch.device("cpu"), sizes=dict(
            resident=(2, 2), resident2d=(2, 3), varcoef=(2, 2, 1),
            curved=(2, 2), adaptive=(2, 2, 1), spmv_degrees=(1, 2),
            spmv_refine=2, bmspmv_degrees=(1, 2), bmspmv_refine=2), reps=2)
    assert res["launches"] == {"K1": 0, "K3": 0, "K4": 0}
    assert set(res["true_rel_res"]) == {"jacobi", "gmg", "gmg_bf16cycle"}
    assert all(0 < r < 1e-4 for r in res["true_rel_res"].values())
    out = capsys.readouterr().out
    assert out.count('"bench": "bmop-resident"') == 3
    assert out.count('"bench": "bmspmv"') == 2
    assert "ELL SpMV against the structured f32 apply at Q2 refine 2" in out
