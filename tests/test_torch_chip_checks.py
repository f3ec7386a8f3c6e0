"""The port's chip checks and its small tools against the reference's
scripts, on the CPU: ``apps.chip_checks`` (the records and the artifact),
``apps.check_chip_goldens`` against ``scripts/check_chip_goldens.py`` run
as a subprocess (json only, no JAX) on crafted artifacts, the committed
H100 golden, ``apps.run_sweep``, ``apps.plot_benchmarks`` against
``scripts/plot_benchmarks.py``, and ``apps.multichip.entry`` against
``__graft_entry__.entry``."""

import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpufem_torch.apps import (
    check_chip_goldens,
    chip_checks,
    multichip,
    plot_benchmarks,
    run_sweep,
)

REPO = Path(__file__).resolve().parent.parent
TPU_GOLDEN = REPO / "tests" / "goldens" / "chip_checks_golden.json"
H100_GOLDEN = REPO / "tpufem_torch" / "goldens" / "chip_checks_h100.json"
REF_CHECKER = REPO / "scripts" / "check_chip_goldens.py"
TERMS = "resident_terms_accuracy_vs_f64_oracle"


def test_chip_checks_on_the_cpu(tmp_path):
    """The CPU run as the reference's (refine 3, the structured tier) and
    the sixth record, K4's plain version against the f64 oracle: the six
    record names of the reference's golden, each passed, with the card's
    keys."""
    names = [r["check"] for r in json.loads(TPU_GOLDEN.read_text())[
        "records"]]
    art = tmp_path / "cc.json"
    recs = chip_checks.main(out=art, device="cpu", log=lambda s: None)
    got = json.loads(art.read_text())
    assert got["platform"] == "cpu"
    assert [r["check"] for r in got["records"]] == names
    assert got["records"] == recs
    for r in recs:
        assert r["pass"] is True and r["device"] == "cpu"
    golden = json.loads(TPU_GOLDEN.read_text())
    for g, r in zip(golden["records"], recs):
        assert set(g) - {"rel_err_max"} <= set(r), g["check"]
    assert recs[0]["n_dofs"] == 35937 and recs[3]["n_dofs"] == 1089
    assert recs[-1]["n_dofs"] == 65**3 and recs[-1]["rel_err"] < 5e-6
    assert chip_checks.DEFAULT_OUT.parent.name == "chiprun_out"


def _crafted(golden: dict) -> dict:
    """Artifacts for each rule, each beside its golden: good, a count off,
    not bitwise, rel_err over its bound, a check missing, pass false, and
    the platform mismatched."""
    good = {"platform": golden["platform"], "records": []}
    for g in golden["records"]:
        r = {"check": g["check"], "pass": True}
        for key, v in g.items():
            if key.endswith("iterations"):
                r[key] = list(v)
        if g.get("bitwise_identical_solutions"):
            r["bitwise_identical_solutions"] = True
        if "rel_err_max" in g:
            r["rel_err"] = g["rel_err_max"] / 3
        good["records"].append(r)
    cases = {"good": good}
    c = copy.deepcopy(good)
    c["records"][0]["iterations"][1] += 1
    cases["count_off"] = c
    c = copy.deepcopy(good)
    c["records"][1]["bitwise_identical_solutions"] = False
    cases["not_bitwise"] = c
    c = copy.deepcopy(good)
    c["records"][2]["rel_err"] = golden["records"][2]["rel_err_max"] * 2
    cases["rel_err_over"] = c
    c = copy.deepcopy(good)
    del c["records"][3]
    cases["missing"] = c
    c = copy.deepcopy(good)
    c["records"][4]["pass"] = False
    cases["pass_false"] = c
    c = copy.deepcopy(good)
    c["platform"] = "gpu" if golden["platform"] != "gpu" else "tpu"
    cases["platform"] = c
    return cases


@pytest.mark.parametrize("golden_path", [TPU_GOLDEN, H100_GOLDEN],
                         ids=["tpu_golden", "h100_golden"])
def test_checker_matches_the_reference(golden_path, tmp_path, capsys):
    golden = json.loads(golden_path.read_text())
    for name, art in _crafted(golden).items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(art))
        ref = subprocess.run(
            [sys.executable, str(REF_CHECKER), str(path), "--golden",
             str(golden_path)], capture_output=True, text=True, timeout=60)
        rc = check_chip_goldens.main([str(path), "--golden",
                                      str(golden_path)])
        out = capsys.readouterr().out
        assert rc == ref.returncode, name
        assert out == ref.stdout, name
        assert (rc == 0) == (name == "good"), name
    # the TPU golden against a gpu artifact: the platform rule
    path = tmp_path / "gpu_art.json"
    good = _crafted(json.loads(TPU_GOLDEN.read_text()))["good"]
    path.write_text(json.dumps(dict(good, platform="gpu")))
    assert check_chip_goldens.main([str(path), "--golden",
                                    str(TPU_GOLDEN)]) == 1
    assert "platform: artifact ran on 'gpu', golden is for 'tpu'" in \
        capsys.readouterr().out


def test_h100_golden():
    golden = json.loads(H100_GOLDEN.read_text())
    assert golden["platform"] == "gpu"
    assert "NVIDIA H100" in golden["note"] and " W" in golden["note"]
    names = [r["check"] for r in json.loads(TPU_GOLDEN.read_text())[
        "records"]]
    assert [r["check"] for r in golden["records"]] == names
    bounds = {r["check"]: r["rel_err_max"] for r in golden["records"]
              if "rel_err_max" in r}
    # no looser than the reference's asserts
    assert bounds["fused_kernel_accuracy_vs_structured"] <= 1e-6
    assert bounds[TERMS] <= 5e-6
    for r in golden["records"]:
        for key, v in r.items():
            if key.endswith("iterations"):
                assert len(v) == 2 and v[0] == v[1] and v[0] > 0
    assert check_chip_goldens.GOLDEN == H100_GOLDEN


def test_run_sweep_emits_its_table(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    cells = run_sweep.main(["--device", "cpu", "--dim", "2", "--degrees",
                            "1", "--refines", "1", "--reps", "2", "--out",
                            str(out)])
    text = capsys.readouterr().out
    rec = cells[(1, 1)]
    assert "error" not in rec, rec
    assert rec["bench"] == "bmop" and rec["degree"] == 1
    assert json.loads(out.read_text().strip()) == rec
    assert "## bmop sweep — 2D, float32 (GDoF/s)" in text
    assert "| refine | p=1 |" in text
    assert f"| 1 | {rec['gdofs_per_s']:.3f} |" in text


def test_run_sweep_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep.main(["--dim", "2", "--degrees", "1", "--refines", "1"])


def test_plot_benchmarks_prints_the_reference_rows(tmp_path, capsys,
                                                   monkeypatch):
    recs = [{"bench": "bmop", "dim": 3, "degree": 2, "n_dofs": 35937,
             "scheme": "structured", "gdofs_per_s": 0.25,
             "spmv_gdofs_per_s": 0.5, "mf_speedup_vs_spmv": 0.5},
            {"bench": "bmop", "dim": 2, "degree": 1, "n_dofs": 289,
             "scheme": "separable", "gdofs_per_s": 1.5},
            {"bench": "bmop-adaptive", "dim": 3, "degree": 4}]
    path = tmp_path / "results.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs)
                    + "\nnot json\n\n")
    ref = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "plot_benchmarks.py"),
         str(path)], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert ref.returncode == 0, ref.stderr
    rows = plot_benchmarks.main(str(path))
    out = capsys.readouterr().out.splitlines()
    assert len(rows) == 2
    table = ref.stdout.splitlines()[:3]
    assert out[:3] == table
    if importlib.util.find_spec("matplotlib") is not None:
        assert out[3] == f"wrote {path.with_suffix('.png')}"
        assert path.with_suffix(".png").stat().st_size > 0
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    plot_benchmarks.main(str(path))
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == table
    assert out[3:] == ["matplotlib is not installed: no plot drawn"]
    (tmp_path / "empty.jsonl").write_text("")
    plot_benchmarks.main(str(tmp_path / "empty.jsonl"))
    assert capsys.readouterr().out == "no bmop records found\n"


def test_entry_matches_tpufem():
    """``fn(*args)`` against tpufem's entry: both the raw f32 apply of 3D
    Q4 refine 3 on the default tier, on ones.  A·1 is the apply's
    rounding floor, so both are held to the apply's scale, ||A u|| for a
    seeded u with ||u|| = ||1||, which the two ``fn`` agree on to 1e-6
    relative."""
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as graft

    saved = jax.config.jax_compilation_cache_dir
    try:
        fn_j, (dp, xj) = graft.entry()
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    fn, args = multichip.entry(device="cpu")
    assert len(args) == 1 and args[0].dtype == torch.float32
    assert torch.equal(args[0], torch.ones_like(args[0]))
    y = fn(*args).numpy().astype(np.float64)
    yj = np.asarray(jax.jit(fn_j)(dp, xj), np.float64)
    n = y.size
    u = np.random.default_rng(3).standard_normal(n)
    u *= np.sqrt(n) / np.linalg.norm(u)
    au = fn(torch.as_tensor(u, dtype=torch.float32)).numpy()
    auj = np.asarray(jax.jit(fn_j)(dp, jax.numpy.asarray(
        u, jax.numpy.float32)), np.float64)
    scale = np.linalg.norm(auj)
    assert np.linalg.norm(au - auj) <= 1e-6 * scale
    assert np.linalg.norm(y - yj) <= 1e-6 * scale


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        multichip.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        chip_checks.main()
