"""Port parity for the adaptive benchmarks of ``tpufem_torch.apps.bmop``
(``build_adaptive_op``, ``bench_adaptive``, ``bench_adaptive_solve`` and
``--adaptive``) against tpufem's on the CPU, at 3D Q2 refine 2 with one
adaptive step (1,657 DoFs, 378 hanging).

In f64: every non-timing key equal (``n_patch``, ``n_rects``,
``n_fallback_rows``, ``n_hanging``, ``levels``), equal Jacobi and GMG
iteration counts, and true residuals within 1e-9 of the reference's
(both relative to ||b||, so the difference is absolute; the GMG-CG's
Chebyshev smoothers start their power iteration from tpufem's draw,
through the port's seam ``chebyshev.power_start``).  The reference runs
the bf16 tier and the bf16 cycle only in f32, so one f32 case at the same
shape holds the port's records to the bf16 keys, with the bf16 tier
within ``chip_smoke.BOX_BF16_TOL`` of f32 in both packages."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.apps import bmop as j_bmop
from tpufem_torch.apps import bmop
from tpufem_torch.solvers import chebyshev as t_cheb
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SHAPE = (3, 2, 2, 1)  # dim, p, refine, steps
TIMINGS = {"s_per_apply", "gdofs_per_s", "tiers_gdofs", "ts",
           "incidence_s_per_apply", "box_speedup_vs_incidence",
           "jacobi_s", "gmg_s", "gmg_bf16cycle_s"}
RES_TOL = 1e-9
BOX_BF16_TOL = 5e-3  # chip_smoke.BOX_BF16_TOL
BF16_CYCLE = {"gmg_bf16cycle_s", "gmg_bf16cycle_iterations",
              "gmg_bf16cycle_converged", "gmg_bf16cycle_true_rel_res"}


def tpufem_start(n, seed, dtype, device):
    """tpufem's power-iteration start (``jax.random.normal``)."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jdt)
    return torch.tensor(np.asarray(v.astype(jnp.float64)), dtype=dtype,
                        device=device)


@pytest.fixture(scope="module")
def f64():
    """Both packages' records in f64, the adaptive build shared between
    the apply and the solve benchmark as the reference's bench shares
    it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_cheb, "power_start", tpufem_start)
    pre_t = bmop.build_adaptive_op(*SHAPE, "float64", device="cpu")
    pre_j = j_bmop.build_adaptive_op(*SHAPE, "float64")
    out = {
        "apply": (bmop.bench_adaptive(*SHAPE, "float64", 2, compare=True,
                                      prebuilt=pre_t),
                  j_bmop.bench_adaptive(*SHAPE, "float64", 2, compare=True,
                                        prebuilt=pre_j)),
        "solve": (bmop.bench_adaptive_solve(*SHAPE, "float64",
                                            prebuilt=pre_t),
                  j_bmop.bench_adaptive_solve(*SHAPE, "float64",
                                              prebuilt=pre_j))}
    mp.undo()
    return out


def _same(rt, rj, skip=()):
    assert set(rt) == set(rj)
    for key in set(rj) - TIMINGS - set(skip):
        assert rt[key] == rj[key], key
    for key in TIMINGS & set(rt) - {"tiers_gdofs", "ts"}:
        assert np.isfinite(rt[key]) and rt[key] > 0, key


def test_bench_adaptive_f64_matches_tpufem(f64):
    rt, rj = f64["apply"]
    _same(rt, rj)
    assert (rt["n_dofs"], rt["n_hanging"]) == (1657, 378)
    assert rt["tiers_gdofs"].keys() == {"boxes-f32"}


def test_bench_adaptive_solve_f64_matches_tpufem(f64, capsys):
    rt, rj = f64["solve"]
    _same(rt, rj, skip=("jacobi_true_rel_res", "gmg_true_rel_res"))
    with capsys.disabled():
        for name in ("jacobi", "gmg"):
            a, b = rt[f"{name}_true_rel_res"], rj[f"{name}_true_rel_res"]
            print(f"\n{name}: {rt[name + '_iterations']} iterations, true "
                  f"rel residual port {a:.12e} tpufem {b:.12e}, apart "
                  f"{abs(a - b):.2e} (tol {RES_TOL})")
    for name in ("jacobi", "gmg"):
        assert rt[f"{name}_converged"]
        assert abs(rt[f"{name}_true_rel_res"]
                   - rj[f"{name}_true_rel_res"]) <= RES_TOL
    assert rt["gmg_iterations"] < rt["jacobi_iterations"]


def test_adaptive_f32_carries_the_bf16_keys():
    """f32: the bf16 tier (both packages, within BOX_BF16_TOL of f32) and
    the bf16-cycle GMG-CG, whose hierarchy is derived only after emit_cb
    has the f32 lines."""
    pre = bmop.build_adaptive_op(*SHAPE, "float32", device="cpu")
    rt = bmop.bench_adaptive(*SHAPE, "float32", 2, prebuilt=pre)
    rj = j_bmop.bench_adaptive(*SHAPE, "float32", 2)
    _same(rt, rj, skip=("scheme", "bf16_rel_err"))
    for r in (rt, rj):
        assert r["tiers_gdofs"].keys() == {"boxes-f32", "boxes-bf16"}
        assert r["scheme"] in r["tiers_gdofs"]
        assert 0 < r["bf16_rel_err"] <= BOX_BF16_TOL
    seen = []
    rs = bmop.bench_adaptive_solve(*SHAPE, "float32", prebuilt=pre,
                                   bf16_cycle=True, emit_cb=seen.append)
    assert len(seen) == 1 and not BF16_CYCLE & set(seen[0])
    assert set(rs) == set(seen[0]) | {"jacobi_s", "jacobi_iterations",
                                      "jacobi_converged",
                                      "jacobi_true_rel_res", "gmg_s",
                                      "gmg_iterations", "gmg_converged",
                                      "gmg_true_rel_res"} | BF16_CYCLE
    for name in ("jacobi", "gmg", "gmg_bf16cycle"):
        assert rs[f"{name}_converged"]
        assert rs[f"{name}_true_rel_res"] <= 10 * rs["rtol"]
    assert rs["gmg_bf16cycle_iterations"] < rs["jacobi_iterations"]
    # in f64 neither bf16 key is there, as in the reference
    r64 = bmop.bench_adaptive_solve(*SHAPE, "float64", prebuilt=(
        bmop.build_adaptive_op(*SHAPE, "float64", device="cpu")),
        bf16_cycle=True)
    assert not BF16_CYCLE & set(r64)


def test_bmop_adaptive_cli(capsys):
    """``--adaptive 1 --compare-incidence`` in a subprocess: the same
    last-line keys and non-timing values as the reference's CLI."""
    args = ["--dim", "2", "--degrees", "2", "--refine", "2", "--adaptive",
            "1", "--compare-incidence", "--dtype", "float64", "--reps", "2"]
    r = subprocess.run(
        [sys.executable, "-m", "tpufem_torch.apps.bmop", "--cpu", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    rt = json.loads(r.stdout.strip().splitlines()[-1])
    j_bmop.main(["--cpu", *args])
    rj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _same(rt, rj)
    assert rt["bench"] == "bmop-adaptive" and "incidence_s_per_apply" in rt
