"""Port parity for the operator bench app (``tpufem_torch.apps.bmop``)
against tpufem's on the CPU: the resident, variable-coefficient and curved
benchmarks and the CLI.

The port runs its kernel wrappers' plain versions here, tpufem its Pallas
kernels in interpret mode.  Every record key but the timings equals the
reference's: the timings are ``s_per_apply``, ``gdofs_per_s``, the values
of ``tiers_gdofs`` and ``ts``, and ``scheme`` where it names the fastest of
several tiers.  ``tier_errors`` is the port's one added key, present only
when a tier failed.  Where the reference drops a kernel tier without a
word (``tpufem/apps/bmop.py:366-369, 455-461``), the port runs it, and
the test names the TPU limit that stopped the reference there.  The
adaptive benchmarks are in ``test_torch_bmop_adaptive.py``."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps import bmop as j_bmop
from tpufem.fem.dof_handler import DoFHandler as JDoFHandler
from tpufem.fem.mesh import Mesh as JMesh
from tpufem.ops import pallas_separable as jps
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.ops.separable import global_1d_matrices
from tpufem.utils.config import FemConfig as JFemConfig
from tpufem_torch.apps import bmop
from tpufem_torch.fem.dof_handler import DoFHandler
from tpufem_torch.fem.mesh import Mesh
from tpufem_torch.ops import kernel_separable as tks
from tpufem_torch.ops import kernel_terms as tkt
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.utils.config import FemConfig

REPO = Path(__file__).resolve().parent.parent
TIMINGS = {"s_per_apply", "gdofs_per_s", "ts", "tiers_gdofs"}
# the TPU limit behind every kernel tier the reference drops at these
# shapes: its resident layouts tile each axis in 8 (f32) or 16 (bf16
# storage) rows and need two tiles (``pallas_separable.py:1277``); the
# port's ring takes any npts
TWO_TILES = "resident kernel needs >= 2 tiles per axis"


def _same_record(rt, rj, argmin_scheme=False):
    """Equal keys and equal non-timing values; the tiers_gdofs keys equal
    and every rate finite and positive."""
    assert set(rt) - {"tier_errors"} == set(rj)
    skip = TIMINGS | ({"scheme"} if argmin_scheme else set())
    for key in set(rj) - skip:
        assert rt[key] == rj[key], key
    if "tiers_gdofs" in rj:
        assert set(rj["tiers_gdofs"]) <= set(rt["tiers_gdofs"])
        assert all(np.isfinite(v) and v > 0
                   for v in rt["tiers_gdofs"].values())
        if argmin_scheme:
            assert rt["scheme"] in rt["tiers_gdofs"]
    assert np.isfinite(rt["gdofs_per_s"]) and rt["gdofs_per_s"] > 0


@pytest.mark.parametrize("dim,refine", [(3, 2), (2, 3)],
                         ids=["3d_q2_r2", "2d_q2_r3"])
def test_bench_resident_matches_tpufem(dim, refine):
    rt = bmop.bench_resident(2, refine, "float32", 2, dim=dim, device="cpu")
    rj = j_bmop.bench_resident(2, refine, "float32", 2, dim=dim)
    _same_record(rt, rj)
    assert "tier_errors" not in rt


@pytest.mark.parametrize("dim,refine", [(3, 2), (2, 3)],
                         ids=["3d_q2_r2", "2d_q2_r3"])
def test_resident_chain_step_matches_tpufem(dim, refine):
    """One step of bench_resident's chain, (raw(v) * 1e-7) in f32, through
    the port's K1/K3 wrapper (plain version) and the JAX kernel in
    interpret mode, from the bench's ones and from a seeded vector: equal
    within the f32 class (1e-6 of the largest value)."""
    p, n = 2, 1 << refine
    npts = n * p + 1
    K1u, M1u = global_1d_matrices(p, n, p + 1)
    Kx, Mx = np.asarray(K1u * n), np.asarray(M1u / n)
    if dim == 3:
        jk = jps.ResidentSeparable(npts, p, [Kx] * 3, [Mx] * 3, "float32",
                                   interpret=True)
        tk = tks.ResidentSeparable(npts, p, [Kx] * 3, [Mx] * 3,
                                   torch.float32, device="cpu")
    else:
        terms = [[Kx, Mx], [Mx, Kx]]
        jk = jps.ResidentTerms2D(npts, p, terms, "float32", interpret=True)
        tk = tkt.ResidentTerms2D(npts, p, terms, torch.float32,
                                 device="cpu")

    def step(u):
        yj = np.asarray(jk.unpad((jk.raw(jk.pad(jnp.asarray(
            u, jnp.float32))) * 1e-7).astype(jnp.float32)), np.float64)
        v = tk.pad(torch.as_tensor(u, dtype=torch.float32))
        return tk.unpad((tk.raw(v) * 1e-7).to(v.dtype)).double().numpy(), yj

    # A 1 is zero inside, so the ones' step is held at the scale of the
    # seeded vector's (both of unit size)
    yt, yj = step(np.random.default_rng(13).standard_normal(npts**dim))
    scale = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= 1e-6 * scale
    yt, yj = step(np.ones(npts**dim))
    assert np.abs(yt - yj).max() <= 1e-6 * scale


def test_bench_varcoef_matches_tpufem():
    """(3, 2, 2): the reference keeps its f32 kernel tier on the CPU."""
    rt = bmop.bench_varcoef(3, 2, 2, "float32", 2, device="cpu")
    rj = j_bmop.bench_varcoef(3, 2, 2, "float32", 2)
    _same_record(rt, rj)
    assert set(rt["tiers_gdofs"]) == set(rj["tiers_gdofs"]) == {
        "resident-terms-f32+pallas", "structured(per-qpoint)"}
    assert "tier_errors" not in rt
    # the attribution tier at its own size, its label naming it
    ra = bmop.bench_varcoef(3, 2, 2, "float32", 2, attr_refine=1,
                            device="cpu")
    assert set(ra["tiers_gdofs"]) == {"resident-terms-f32+pallas",
                                      "structured(per-qpoint)@refine1"}
    assert ra["n_dofs"] == 729 and ra["refine"] == 2


@pytest.mark.parametrize("refine", [1, 2])
def test_bench_curved_matches_tpufem(refine):
    """The shell at refine 1 and 2: the reference keeps the separable and
    structured tiers, drops every kernel tier at refine 1 and bf16s at
    refine 2; the port runs all three kernel tiers.  Each dropped tier
    meets the TPU limit TWO_TILES in the reference's kernel, and the port's
    MatrixFree attaches a kernel wherever the reference's does, and where
    it does not."""
    rt = bmop.bench_curved(3, 2, refine, "float32", 2, device="cpu")
    rj = j_bmop.bench_curved(3, 2, refine, "float32", 2)
    _same_record(rt, rj, argmin_scheme=True)
    assert "tier_errors" not in rt
    kernel_tiers = {f"resident-terms-{m}+pallas": m
                    for m in ("f32", "bf16", "bf16s")}
    dropped = set(kernel_tiers) - set(rj["tiers_gdofs"])
    assert dropped == ({"resident-terms-bf16s+pallas"} if refine == 2
                       else set(kernel_tiers))
    assert set(rt["tiers_gdofs"]) == set(rj["tiers_gdofs"]) | dropped
    jmesh = JMesh.hyper_shell_3d(refine)
    jdofs = JDoFHandler(jmesh, 2)
    mesh = Mesh.hyper_shell_3d(refine)
    dofs = DoFHandler(mesh, 2)
    for name, mode in kernel_tiers.items():
        cfg = dict(dim=3, degree=2, dtype="float32", scatter="separable",
                   use_pallas=True, pallas_mode=mode)
        jmf = JMatrixFree.build(jmesh, jdofs, JFemConfig(**cfg))
        mf = MatrixFree.build(mesh, dofs, FemConfig(**cfg), "cpu")
        assert isinstance(mf.resident, tkt.ResidentTerms)
        assert (jmf.resident is None) == (name in dropped)
        if name in dropped:
            with pytest.raises(ValueError, match=TWO_TILES):
                jps.ResidentTerms(mf.npts, 2, [[np.asarray(X) for X in t]
                                               for t in jmf.sep_ops[1]],
                                  "float32", mode=mode, interpret=True)


@pytest.mark.parametrize("bench", ["varcoef", "curved"])
def test_failing_tier_is_recorded(bench):
    """A kernel tier that raises is recorded with its exception's type and
    text, and the benchmark goes on: bf16s computes in float32 only."""
    if bench == "varcoef":
        rec = bmop.bench_varcoef(3, 2, 2, "float64", 2,
                                 modes=("f32", "bf16s"), device="cpu")
    else:
        rec = bmop.bench_curved(3, 2, 1, "float64", 2, device="cpu")
    assert rec["tier_errors"] == {
        "resident-terms-bf16s+pallas":
            "ValueError: mode 'bf16s' computes in float32"}
    assert "resident-terms-f32+pallas" in rec["tiers_gdofs"]
    assert "resident-terms-bf16s+pallas" not in rec["tiers_gdofs"]


def test_port_catches_nothing_silently():
    """No handler of the port drops an exception without recording it."""
    pkg = REPO / "tpufem_torch"
    for f in sorted(pkg.rglob("*.py")):
        lines = f.read_text().splitlines()
        for i, line in enumerate(lines[:-1]):
            if line.strip().startswith("except"):
                assert lines[i + 1].strip() != "pass", f"{f}:{i + 1}"


def _cli(args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "tpufem_torch.apps.bmop", "--cpu", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)


@pytest.mark.parametrize("args", [
    ["--dim", "2", "--degrees", "2", "--refine", "3", "--resident", "f32"],
    ["--dim", "3", "--degrees", "2", "--refine", "1", "--curved"],
], ids=["resident", "curved"])
def test_bmop_cli(args, capsys):
    """The port's CLI in a subprocess: the same last-line JSON keys as the
    reference's CLI (run in this process)."""
    full = [*args, "--dtype", "float32", "--reps", "2"]
    r = _cli(full)
    assert r.returncode == 0, r.stderr[-2000:]
    rt = json.loads(r.stdout.strip().splitlines()[-1])
    j_bmop.main(["--cpu", *full])
    rj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _same_record(rt, rj, argmin_scheme=True)
    assert "ts" in rt


def test_bmop_cli_shards_raise_not_ported():
    r = _cli(["--dim", "3", "--degrees", "2", "--refine", "2", "--adaptive",
              "1", "--shards", "2x2"])
    assert r.returncode != 0
    assert "NotImplementedError" in r.stderr and "distributed" in r.stderr
    with pytest.raises(NotImplementedError, match="distributed"):
        bmop.main(["--cpu", "--adaptive", "1", "--shards", "2x2"])


def test_bmop_shards_argument_check_as_tpufem(capsys):
    """--shards without --adaptive (or with --spmv) fails as the
    reference's argument check does, before anything is built."""
    for extra in ([], ["--adaptive", "1", "--spmv"]):
        argv = ["--cpu", "--shards", "2", *extra]
        with pytest.raises(SystemExit) as et:
            bmop.main(argv)
        err_t = capsys.readouterr().err.strip().splitlines()[-1]
        with pytest.raises(SystemExit) as ej:
            j_bmop.main(argv)
        err_j = capsys.readouterr().err.strip().splitlines()[-1]
        assert et.value.code == ej.value.code == 2
        assert err_t == err_j and "requires --adaptive" in err_t
