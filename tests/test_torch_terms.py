"""Port parity for the terms tier of the separable scheme: the
sum-of-tensor-products builders, the K4/K3 wrappers (ResidentTerms,
ResidentTerms2D), MatrixFree/LaplaceOperator on curved shells and with
separable or CP-expanded coefficients, and resident_jacobi_cg through
them, against tpufem (f64 on the CPU unless a mode says otherwise; the
port runs its plain versions there, tpufem its Pallas kernels in
interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.dof_handler import DoFHandler
from tpufem.fem.mesh import Mesh
from tpufem.operators.laplace import LaplaceOperator as JLaplace
from tpufem.ops import pallas_separable as jps
from tpufem.ops import separable as jsep
from tpufem.ops.matrix_free import MatrixFree as JMatrixFree
from tpufem.solvers.resident import resident_jacobi_cg as j_resident_cg
from tpufem.utils.config import FemConfig
from tpufem_torch.operators.laplace import LaplaceOperator
from tpufem_torch.ops import kernel_terms as tkt
from tpufem_torch.ops import separable as tsep
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.solvers.resident import resident_jacobi_cg
from torch_threads import one_torch_thread  # noqa: F401

# distinct smooth 1D weights per (term, axis), as tests/test_pallas.py's
# _weighted_terms: no matrix is shared between terms or axes
WFS = [lambda x: 1.0 + 0.5 * np.sin(2.3 * x + 0.2),
       lambda x: 1.2 + x,
       lambda x: 0.7 + 0.3 * np.cos(1.7 * x)]


def _weighted_terms(p, n, dim):
    return [[jsep.global_1d_weighted(p, n, p + 1, WFS[(a + b) % 3],
                                     "K" if b == a else "M")
             for b in range(dim)] for a in range(dim)]


def _sep_coef_axes(dim):
    cs = [lambda x: 1.0 + 0.5 * np.sin(2.1 * np.pi * x),
          lambda y: 1.3 + y * y,
          lambda z: np.exp(0.5 * z)]
    return cs[:dim]


def _cp_coef(pts):
    return 1.0 / (0.5 + 2.0 * np.sum(pts**2, axis=1))


def _equal_terms(t_port, t_ref):
    assert len(t_port) == len(t_ref)
    for row_t, row_j in zip(t_port, t_ref):
        assert len(row_t) == len(row_j)
        for X_t, X_j in zip(row_t, row_j):
            X_j = np.asarray(X_j)
            assert X_t.dtype == X_j.dtype and np.array_equal(X_t, X_j)


# ---------------------------------------------------------------------
# host builders: numpy copies, equal to tpufem's bit for bit
# ---------------------------------------------------------------------
@pytest.mark.parametrize("case", [
    "gradient", "weighted", "weighted_values", "shell_2d", "shell_3d",
    "cartesian_coef", "cp_grid_2d", "cp_grid_3d", "cp_coef_2d",
    "cp_coef_3d"])
def test_builders_equal_tpufem(case):
    p, n = 3, 4
    rng = np.random.default_rng(3)
    if case == "gradient":
        assert np.array_equal(tsep.global_1d_gradient(p, n, p + 1),
                              jsep.global_1d_gradient(p, n, p + 1))
    elif case == "weighted":
        for kind in "KM":
            for wf in (None, WFS[0]):
                assert np.array_equal(
                    tsep.global_1d_weighted(p, n, p + 1, wf, kind),
                    jsep.global_1d_weighted(p, n, p + 1, wf, kind))
    elif case == "weighted_values":
        w = rng.standard_normal((n, p + 1))
        for kind in "KM":
            assert np.array_equal(
                tsep.global_1d_weighted_values(p, n, p + 1, w, kind),
                jsep.global_1d_weighted_values(p, n, p + 1, w, kind))
    elif case.startswith("shell"):
        dim = int(case[-2])
        mesh = Mesh.hyper_shell_2d(2) if dim == 2 else Mesh.hyper_shell_3d(2)
        for dt in (np.float64, np.float32):
            _equal_terms(
                tsep.build_separable_metric_terms(p, dim, p + 1, n,
                                                  mesh.separable_metric, dt),
                jsep.build_separable_metric_terms(p, dim, p + 1, n,
                                                  mesh.separable_metric, dt))
    elif case == "cartesian_coef":
        lo, hi = [0.0, -0.5, 0.2], [1.0, 1.5, 0.7]
        _equal_terms(
            tsep.cartesian_coef_terms(p, 3, p + 1, n, lo, hi,
                                      _sep_coef_axes(3), np.float64),
            jsep.cartesian_coef_terms(p, 3, p + 1, n, lo, hi,
                                      _sep_coef_axes(3), np.float64))
    elif case.startswith("cp_grid"):
        dim = int(case[-2])
        T = rng.standard_normal((7,) * dim)
        ft, et = tsep.cp_decompose_grid(T, max_rank=3, tol=1e-12)
        fj, ej = jsep.cp_decompose_grid(T, max_rank=3, tol=1e-12)
        assert et == ej and len(ft) == len(fj)
        for rt, rj in zip(ft, fj):
            for vt, vj in zip(rt, rj):
                assert np.array_equal(vt, vj)
    else:
        dim = int(case[-2])
        lo, hi = [0.0] * dim, [1.0] * dim
        tt, et = tsep.cp_coef_terms(2, dim, 3, 2, lo, hi, _cp_coef,
                                    np.float64, tol=1e-9, max_rank=6)
        tj, ej = jsep.cp_coef_terms(2, dim, 3, 2, lo, hi, _cp_coef,
                                    np.float64, tol=1e-9, max_rank=6)
        assert et == ej
        _equal_terms(tt, tj)


def test_plain_terms_apply_matches_tpufem():
    p, n = 2, 4
    npts = n * p + 1
    for dim in (2, 3):
        terms = _weighted_terms(p, n, dim)
        u = np.random.default_rng(dim).standard_normal(npts**dim)
        y_t = tsep.laplace_apply_separable_terms(
            torch.as_tensor(u), dim, npts,
            [[torch.as_tensor(X) for X in t] for t in terms]).numpy()
        y_j = np.asarray(jsep.laplace_apply_separable_terms(
            jnp.asarray(u), dim, npts,
            [[jnp.asarray(X) for X in t] for t in terms]))
        assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-14


# ---------------------------------------------------------------------
# the K4/K3 wrappers: plain versions against tpufem's kernels
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dim,p,n,tile", [(3, 2, 8, 8), (3, 4, 4, 8),
                                          (2, 2, 16, 16), (2, 4, 8, 16)])
def test_resident_terms_plain_matches_tpufem(dim, p, n, tile):
    npts = n * p + 1
    terms = _weighted_terms(p, n, dim)
    cls_j = jps.ResidentTerms if dim == 3 else jps.ResidentTerms2D
    cls_t = tkt.ResidentTerms if dim == 3 else tkt.ResidentTerms2D
    u = np.random.default_rng(0).standard_normal(npts**dim)
    jk = cls_j(npts, p, terms, "float64", tile=tile, interpret=True)
    y_j = np.asarray(jk(jnp.asarray(u)))
    before = cls_t.launches
    tk = cls_t(npts, p, terms, torch.float64, device="cpu")
    assert tk.dirichlet is False and tk.n_terms == dim
    y_t = tk(torch.as_tensor(u)).numpy()
    assert cls_t.launches == before  # plain, not a launch
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-13
    # two applies chained in the resident layout
    y2_j = np.asarray(jk.unpad(jk.raw(jk.raw(jk.pad(jnp.asarray(u))))))
    gp = tk.pad(torch.as_tensor(u))
    assert gp.shape == ((npts, npts, 24) if dim == 3 else (npts, 48))
    y2_t = tk.unpad(tk.raw(tk.raw(gp))).numpy()
    assert np.linalg.norm(y2_t - y2_j) / np.linalg.norm(y2_j) < 1e-12


@pytest.mark.parametrize("dim", [2, 3])
def test_resident_terms_bf16s_mode(dim):
    """bf16s: bf16 storage, f32 arithmetic; against tpufem's bf16s kernel
    and against the f64 apply of the same bf16 input, in the 4e-3 class
    (npts 25: tpufem's bf16 tiles are 16 rows, and it needs two)."""
    p, n = 2, 12
    npts = n * p + 1
    terms = _weighted_terms(p, n, dim)
    cls_j = jps.ResidentTerms if dim == 3 else jps.ResidentTerms2D
    cls_t = tkt.ResidentTerms if dim == 3 else tkt.ResidentTerms2D
    u = np.random.default_rng(1).standard_normal(npts**dim)
    tk = cls_t(npts, p, terms, torch.float32, mode="bf16s", device="cpu")
    assert tk.dt == torch.bfloat16 and tk.compute_dt == torch.float32
    gp = tk.pad(torch.as_tensor(u))
    y = tk.raw(gp)
    assert y.dtype == torch.bfloat16 and y.shape == (
        (npts, npts, 32) if dim == 3 else (npts, 32))
    y = tk.unpad(y).to(torch.float64).numpy()
    ref = cls_t(npts, p, terms, torch.float64, device="cpu")
    y_ref = ref.unpad(ref.raw(ref.pad(tk.unpad(gp).to(torch.float64))))
    y_ref = y_ref.numpy()
    assert np.abs(y - y_ref).max() <= 4e-3 * np.abs(y_ref).max()
    jk = cls_j(npts, p, terms, "float32", mode="bf16s", interpret=True)
    y_j = np.asarray(jk(jnp.asarray(u, jnp.float32)), np.float64)
    assert np.linalg.norm(y - y_j) / np.linalg.norm(y_j) <= 4e-3


def test_resident_terms_refuses_what_it_cannot_run():
    p, n = 2, 2
    npts = n * p + 1
    terms = _weighted_terms(p, n, 3)
    with pytest.raises(ValueError, match="3 matrices"):
        tkt.ResidentTerms(npts, p, [t[:2] for t in terms], torch.float64)
    with pytest.raises(ValueError, match="bf16s"):
        tkt.ResidentTerms(npts, p, terms, torch.float64, mode="bf16s")
    with pytest.raises(ValueError, match="p = 1..8"):
        tkt.ResidentTerms(npts, 9, terms, torch.float64)
    if not torch.cuda.is_available():
        # no silent CPU fallback: a CUDA instance needs its built kernel
        with pytest.raises(RuntimeError, match="CUDA"):
            tkt.ResidentTerms2D(npts, p, [t[:2] for t in terms[:2]],
                                torch.float32, device="cuda")


# ---------------------------------------------------------------------
# MatrixFree + LaplaceOperator on the terms tier
# ---------------------------------------------------------------------
def _build_pair(case, use_pallas=True, pallas_mode="f32"):
    """(tpufem MatrixFree, port MatrixFree) of one operator of the terms
    tier, f64, with the kernels attached under use_pallas."""
    kw = {}
    if case == "shell_3d":
        mesh, dim, p = Mesh.hyper_shell_3d(3), 3, 2
    elif case == "shell_2d":
        mesh, dim, p = Mesh.hyper_shell_2d(4), 2, 2
    elif case == "coef_axes_3d":
        mesh, dim, p = Mesh.hyper_cube(3, 2), 3, 2
        kw = dict(coefficient_axes=_sep_coef_axes(3))
    elif case == "coef_axes_3d_r3":
        mesh, dim, p = Mesh.hyper_cube(3, 3), 3, 2
        kw = dict(coefficient_axes=_sep_coef_axes(3))
    elif case == "cube_2d":
        mesh, dim, p = Mesh.hyper_cube(2, 4), 2, 3
    elif case == "cp_2d":
        mesh, dim, p = Mesh.hyper_cube(2, 3), 2, 2
        kw = dict(coefficient=_cp_coef, coefficient_cp_tol=1e-9,
                  coefficient_cp_max_rank=6)
    else:
        raise ValueError(case)
    dofs = DoFHandler(mesh, p)
    cfg = FemConfig(dim, p, scatter="separable", dtype="float64",
                    use_pallas=use_pallas, pallas_mode=pallas_mode)
    return (JMatrixFree.build(mesh, dofs, cfg, **kw),
            MatrixFree.build(mesh, dofs, cfg, "cpu", **kw))


@pytest.mark.parametrize("case", ["shell_3d", "shell_2d", "coef_axes_3d",
                                  "cp_2d"])
def test_matrix_free_terms_match_tpufem(case):
    jmf, tmf = _build_pair(case)
    assert jmf.sep_ops[0] == "terms" and tmf.terms is not None
    assert tmf.Ks is None and tmf.kernel is None
    cls_t = tkt.ResidentTerms if tmf.config.dim == 3 else tkt.ResidentTerms2D
    assert isinstance(tmf.resident, cls_t) and jmf.resident is not None
    assert tmf.coef_cp_err == jmf.coef_cp_err
    _equal_terms([[X.numpy() for X in t] for t in tmf.terms], jmf.sep_ops[1])
    jop, top = JLaplace(jmf), LaplaceOperator(tmf)
    x = np.random.default_rng(2).standard_normal(tmf.n_dofs)
    for name in ("vmult_raw", "vmult"):
        y_j = np.asarray(getattr(jop, name)(jnp.asarray(x)))
        y_t = getattr(top, name)(torch.as_tensor(x)).numpy()
        assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-12, name
    d_j, d_t = np.asarray(jop.diagonal()), top.diagonal().numpy()
    assert np.linalg.norm(d_t - d_j) / np.linalg.norm(d_j) < 1e-12
    # without use_pallas: the plain terms apply, the same operator
    _, tmf_plain = _build_pair(case, use_pallas=False)
    assert tmf_plain.resident is None
    y_p = LaplaceOperator(tmf_plain).vmult_raw(torch.as_tensor(x)).numpy()
    assert np.array_equal(y_p, top.vmult_raw(torch.as_tensor(x)).numpy())


def test_matrix_free_terms_options():
    mesh = Mesh.hyper_cube(2, 2)
    dofs = DoFHandler(mesh, 2)
    cfg = FemConfig(2, 2, scatter="separable")
    with pytest.raises(ValueError, match="not both"):
        MatrixFree.build(mesh, dofs, cfg, "cpu", coefficient=_cp_coef,
                         coefficient_axes=_sep_coef_axes(2))
    with pytest.raises(ValueError, match="coefficient_cp_tol"):
        MatrixFree.build(mesh, dofs, cfg, "cpu", coefficient=_cp_coef)
    shell = Mesh.hyper_shell_2d(2)
    with pytest.raises(ValueError, match="Cartesian"):
        MatrixFree.build(shell, DoFHandler(shell, 2), cfg, "cpu",
                         coefficient_axes=_sep_coef_axes(2))


def test_poisson_operator_coefficient_axes():
    """The entry point forwards coefficient_axes: tpufem's operator and
    diagonal; a bf16s twin made by from_terms from the f32 operator's host
    arrays equals the bf16s build."""
    import dataclasses

    from tpufem_torch.apps.poisson import poisson_operator

    jmf, _ = _build_pair("coef_axes_3d")
    op = poisson_operator(3, 2, 2, "float64", True, "cpu",
                          coefficient_axes=_sep_coef_axes(3))
    _equal_terms([[X.numpy() for X in t] for t in op.mf.terms],
                 jmf.sep_ops[1])
    d_j, d_t = np.asarray(JLaplace(jmf).diagonal()), op.diagonal().numpy()
    assert np.linalg.norm(d_t - d_j) / np.linalg.norm(d_j) < 1e-12
    ops = {mode: poisson_operator(3, 2, 2, "float32", True, "cpu",
                                  pallas_mode=mode,
                                  coefficient_axes=_sep_coef_axes(3))
           for mode in ("f32", "bf16s")}
    mf = ops["f32"].mf
    twin = MatrixFree.from_terms(
        dataclasses.replace(mf.config, pallas_mode="bf16s"), mf.mesh, mf.dofs,
        "cpu", [[X.numpy() for X in t] for t in op.mf.terms],
        interior=mf.interior_mask.numpy(), quad=mf.quad,
        host_metric=mf.host_metric, coef_q=mf.coef_q)
    rk, rk16 = twin.resident, ops["bf16s"].mf.resident
    assert rk.dt == torch.bfloat16 and torch.equal(rk.tables, rk16.tables)
    x = rk.pad(torch.as_tensor(np.random.default_rng(6).standard_normal(
        mf.n_dofs)))
    assert torch.equal(rk.raw(x), rk16.raw(x))


# ---------------------------------------------------------------------
# resident Jacobi-CG through K4 / K3
# ---------------------------------------------------------------------
@pytest.mark.parametrize("case", ["shell_3d", "coef_axes_3d_r3",
                                  "cube_2d"])
def test_resident_cg_terms_matches_tpufem(case):
    """Equal iteration counts and x to 1e-8 (the JAX tests' bound), on a
    seeded masked random RHS."""
    if case == "cube_2d":
        mesh = Mesh.hyper_cube(2, 5)
        dofs = DoFHandler(mesh, 3)
        cfg = FemConfig(2, 3, scatter="separable", use_pallas=True)
        jmf = JMatrixFree.build(mesh, dofs, cfg)
        tmf = MatrixFree.build(mesh, dofs, cfg, "cpu")
        assert isinstance(tmf.resident, tkt.ResidentTerms2D)
    else:
        jmf, tmf = _build_pair(case)
    jop, top = JLaplace(jmf), LaplaceOperator(tmf)
    mask = np.asarray(jmf.interior_mask)
    b = mask * np.random.default_rng(4).standard_normal(tmf.n_dofs)
    rj = j_resident_cg(jop, jnp.asarray(b), diag=jop.diagonal(), rtol=1e-8,
                       maxiter=400)
    rt = resident_jacobi_cg(top, torch.as_tensor(b), diag=top.diagonal(),
                            rtol=1e-8, maxiter=400)
    assert rt.converged and rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-8 * max(
        np.linalg.norm(xj), 1.0)


def test_resident_cg_shell_bf16s():
    """pallas_mode="bf16s" reaches K4 through MatrixFree.build; the solve
    reports the residual recomputed with its own operator, and x stays in
    the bf16-storage class of the f32 solution."""
    from tpufem_torch.apps.poisson import poisson_operator

    ops = {mode: poisson_operator(3, 2, 2, "float32", True, "cpu",
                                  pallas_mode=mode, mesh_kind="shell")
           for mode in ("f32", "bf16s")}
    rk = ops["bf16s"].mf.resident
    assert isinstance(rk, tkt.ResidentTerms) and rk.dt == torch.bfloat16
    mask = ops["f32"].mf.interior_mask.numpy().astype(np.float64)
    b = torch.tensor(mask * np.random.default_rng(5).standard_normal(
        mask.size), dtype=torch.float32)
    r = {m: resident_jacobi_cg(op, b, diag=op.diagonal(), rtol=1e-5)
         for m, op in ops.items()}
    assert r["f32"].converged and torch.isfinite(r["bf16s"].x).all()
    m = ops["f32"].mf.interior_mask
    x16 = r["bf16s"].x
    Ax = m * rk.unpad(rk.raw(rk.pad(m * x16))).to(torch.float32) \
        + (1.0 - m) * x16
    true_res = float((b - Ax).norm())
    assert abs(r["bf16s"].residual - true_res) <= 1e-3 * true_res
    rel = float((x16 - r["f32"].x).norm() / r["f32"].x.norm())
    assert rel <= 1e-2, rel


# ---------------------------------------------------------------------
# K4 on the ring: its resident layout, the fused mask, the masked tables
# ---------------------------------------------------------------------
def test_resident_terms_layout_round_trip_and_fused_mask():
    """K4's resident layout is the ring's (npts, npts, X), K3's (npts, X):
    unpad(pad(u)) == u, the pad zero and zero through a CPU resident CG.
    On the shells and the separable coefficient (whose boundary is the
    full box) the mask is fused, in 2D as in 3D; ``raw`` is then
    m·A(m·x) + (1-m)·x and ``__call__`` stays the unmasked A (the
    operator's vmult_raw)."""
    from tpufem_torch.ops.kernel_separable import separable_interior_mask

    for case in ("shell_3d", "coef_axes_3d_r3", "shell_2d"):
        _, tmf = _build_pair(case)
        rk, d = tmf.resident, tmf.config.dim
        assert isinstance(rk, tkt.ResidentTerms) and rk.dirichlet
        assert isinstance(rk, tkt.ResidentTerms2D) == (d == 2)
        n = rk.npts
        u = torch.as_tensor(np.random.default_rng(12).standard_normal(n**d))
        gp = rk.pad(u)
        xc = 8 if d == 3 else 16  # a chunk of f64: 64 bytes, 2D 128
        assert gp.shape == (n,) * (d - 1) + (rk.X,) and rk.X % xc == 0 \
            and rk.X - n < xc
        assert not gp[..., n:].any() and torch.equal(rk.unpad(gp), u)
        m = separable_interior_mask(n, torch.float64, "cpu", d)
        A = lambda v: tsep.laplace_apply_separable_terms(v, d, n, tmf.terms)
        assert torch.allclose(rk.unpad(rk.raw(gp)),
                              m * A(m * u) + (1.0 - m) * u, rtol=0,
                              atol=1e-12 * float(A(u).abs().max()))
        assert torch.equal(rk(u), A(u))
        seen = []

        def raw(g, _raw=rk.raw, n=n):
            y = _raw(g)
            seen.append(bool(g[..., n:].any() or y[..., n:].any()))
            return y

        rk.raw = raw
        top = LaplaceOperator(tmf)
        b = tmf.interior_mask * torch.as_tensor(
            np.random.default_rng(13).standard_normal(tmf.n_dofs))
        r = resident_jacobi_cg(top, b, diag=top.diagonal(), rtol=1e-8,
                               maxiter=400)
        assert r.converged and len(seen) > 10 and not any(seen)


@pytest.mark.parametrize("case", ["shell_3d", "coef_axes_3d_r3",
                                  "shell_2d", "cp_2d", "cube_2d"])
def test_masked_terms_tables_match_tpufem_mask_algebra(case):
    """The masked-table operator K4 (3D) and K3 (2D: the shell, a CP
    coefficient, the cube's two Laplace terms) run with the fused mask
    equals tpufem's m·A(m·x) + (1-m)·x in f64 to 1e-10, and a resident CG
    through it takes tpufem's iterations to the same x."""
    from types import SimpleNamespace

    from test_torch_resident import MaskedTables

    jmf, tmf = _build_pair(case)
    assert tmf.resident.dirichlet
    jop, top = JLaplace(jmf), LaplaceOperator(tmf)
    terms = tmf.terms or [[tmf.Ks[0], tmf.Ms[1]], [tmf.Ms[0], tmf.Ks[1]]]
    mt = MaskedTables(tmf.resident, [[X.numpy() for X in t] for t in terms])
    x = np.random.default_rng(14).standard_normal(tmf.n_dofs)
    y_j = np.asarray(jop.vmult(jnp.asarray(x)))
    y_t = mt.unpad(mt.raw(mt.pad_any(torch.as_tensor(x)))).numpy()
    assert np.linalg.norm(y_t - y_j) <= 1e-10 * np.linalg.norm(y_j)
    mask = np.asarray(jmf.interior_mask)
    b = mask * np.random.default_rng(15).standard_normal(tmf.n_dofs)
    rj = j_resident_cg(jop, jnp.asarray(b), diag=jop.diagonal(), rtol=1e-8,
                       maxiter=400)
    rt = resident_jacobi_cg(SimpleNamespace(mf=tmf, resident=mt),
                            torch.as_tensor(b), diag=top.diagonal(),
                            rtol=1e-8, maxiter=400)
    assert rt.converged and rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-10 * max(
        np.linalg.norm(xj), 1.0)
