"""ctypes bindings to the native C++ setup runtime.

Port of ``tpufem/utils/native.py``.  The compiled library accelerates the
irregular host-side setup loops (greedy coloring, coarse-neighbor hashing,
incidence transposition, hanging-node constraint triplets) — the role the
reference's C++ host code plays in ``reinit``.  Every function has a
pure-numpy fallback; ``available()`` reports whether the native path is
active (``TPUFEM_NO_NATIVE=1`` forces the fallback).

The port's copy of the source, ``tpufem_torch/csrc/tpufem_native.cpp``,
is built with g++ at first use into ``build/tpufem_torch/`` beside the
package, keyed on a hash of the source and the flags, through a
per-process temporary file renamed into place: concurrent processes (test
workers) each build or reuse a whole library, never a half-written one.
Without a compiler, or if the build fails, the numpy fallback runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "tpufem_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpufem_torch"
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lib = None
_load_failed = False


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libtpufem_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: no process sees half a library
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def _load():
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    path = _lib_path()
    if not path.exists() and not _build(path):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        _load_failed = True
        return None
    lib.tpufem_greedy_color.restype = ctypes.c_int32
    lib.tpufem_greedy_color.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.tpufem_coarse_face_neighbors.restype = None
    lib.tpufem_coarse_face_neighbors.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.tpufem_build_incidence.restype = ctypes.c_int64
    lib.tpufem_build_incidence.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None and os.environ.get("TPUFEM_NO_NATIVE") != "1"


# ----------------------------------------------------------------------
def greedy_color(cell_dofs: np.ndarray, n_dofs: int) -> np.ndarray:
    """First-fit DoF-conflict coloring; returns (nc,) int32 colors."""
    cell_dofs = np.ascontiguousarray(cell_dofs, dtype=np.int32)
    nc, nn = cell_dofs.shape
    if available():
        colors = np.empty(nc, dtype=np.int32)
        ncol = _lib.tpufem_greedy_color(
            cell_dofs.ctypes.data, nc, nn, n_dofs, colors.ctypes.data
        )
        if ncol < 0:
            raise RuntimeError("coloring exceeded 64 colors")
        return colors
    # numpy/python fallback
    dof_used = np.zeros(n_dofs, dtype=np.uint64)
    colors = np.empty(nc, dtype=np.int32)
    for c in range(nc):
        d = cell_dofs[c]
        used = int(np.bitwise_or.reduce(dof_used[d]))
        col = 0
        while (used >> col) & 1:
            col += 1
            if col >= 64:  # same cap as the C++ path
                raise RuntimeError("coloring exceeded 64 colors")
        colors[c] = col
        dof_used[d] |= np.uint64(1) << np.uint64(col)
    return colors


def coarse_face_neighbors(
    origins: np.ndarray, sizes: np.ndarray, U: int
) -> np.ndarray:
    """(nc, dim, 2) index of the double-size neighbor across each face,
    -1 where none exists (2:1 forest)."""
    origins = np.ascontiguousarray(origins, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    nc, dim = origins.shape
    out = np.full((nc, dim, 2), -1, dtype=np.int64)
    if available():
        _lib.tpufem_coarse_face_neighbors(
            origins.ctypes.data, sizes.ctypes.data, nc, dim, U,
            out.ctypes.data,
        )
        return out
    # numpy/python fallback (same algorithm)
    from tpufem_torch.fem.mesh import _pack_coords

    by_size: dict[int, dict[int, int]] = {}
    for S in np.unique(sizes).tolist():
        sel = np.nonzero(sizes == S)[0]
        keys = _pack_coords(origins[sel] // S, U // S + 1)
        by_size[S] = dict(zip(keys.tolist(), sel.tolist()))
    for c in range(nc):
        s = int(sizes[c])
        S = 2 * s
        if S not in by_size:
            continue
        for axis in range(dim):
            for side in (0, 1):
                w = int(origins[c, axis]) + s * side
                if w == 0 or w == U:
                    continue
                ax_origin = w if side == 1 else w - S
                if ax_origin % S != 0 or ax_origin < 0:
                    continue
                co = (origins[c] // S) * S
                co[axis] = ax_origin
                key = int(_pack_coords((co // S)[None], U // S + 1)[0])
                idx = by_size[S].get(key)
                if idx is not None:
                    out[c, axis, side] = idx
    return out


def build_incidence(
    cell_dofs: np.ndarray, n_dofs: int, pad_value: int
) -> np.ndarray:
    """(n_dofs, K) padded flat positions of each DoF in cell_dofs.ravel()."""
    cell_dofs = np.ascontiguousarray(cell_dofs, dtype=np.int32)
    nc, nn = cell_dofs.shape
    # entries are flat positions into cell_dofs.ravel() stored as int32 in
    # both the C++ and numpy paths; guard against silent overflow
    if nc * nn >= 2**31 or n_dofs >= 2**31 or pad_value >= 2**31:
        raise ValueError(
            f"incidence map needs int64 entries (nc*nn={nc * nn}, "
            f"n_dofs={n_dofs}); mesh too large for the int32 incidence path"
        )
    if available():
        counts = np.zeros(n_dofs, dtype=np.int64)
        K = _lib.tpufem_build_incidence(
            cell_dofs.ctypes.data, nc, nn, n_dofs, counts.ctypes.data,
            None, 0, 0,
        )
        counts[:] = 0
        out = np.full((n_dofs, int(K)), pad_value, dtype=np.int32)
        _lib.tpufem_build_incidence(
            cell_dofs.ctypes.data, nc, nn, n_dofs, counts.ctypes.data,
            out.ctypes.data, int(K), pad_value,
        )
        return out
    flat = cell_dofs.ravel()
    order = np.argsort(flat, kind="stable")
    sorted_dofs = flat[order]
    counts = np.bincount(sorted_dofs, minlength=n_dofs)
    K = int(counts.max()) if len(counts) else 1
    out = np.full((n_dofs, K), pad_value, dtype=np.int32)
    col = np.concatenate([np.arange(c) for c in counts])
    out[sorted_dofs, col] = order.astype(np.int32)
    return out


def _setup_constraint_protos(lib):
    if hasattr(lib, "_tpufem_con_ready"):
        return
    lib.tpufem_hanging_face_constraints.restype = ctypes.c_int64
    lib.tpufem_hanging_face_constraints.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.tpufem_hanging_edge_constraints.restype = ctypes.c_int64
    lib.tpufem_hanging_edge_constraints.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib._tpufem_con_ready = True


def hanging_face_constraints(origins, sizes, cell_dofs, face_nbr,
                             fine_local, coarse_local, Wt, marks):
    """Native face-constraint triplets; returns (dofs, masters, weights)
    or None when the library is unavailable (Python fallback applies)."""
    if not available():
        return None
    _setup_constraint_protos(_lib)
    origins = np.ascontiguousarray(origins, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    cell_dofs = np.ascontiguousarray(cell_dofs, dtype=np.int32)
    face_nbr = np.ascontiguousarray(face_nbr, dtype=np.int64)
    fine_local = np.ascontiguousarray(fine_local, dtype=np.int32)
    coarse_local = np.ascontiguousarray(coarse_local, dtype=np.int32)
    Wt = np.ascontiguousarray(Wt, dtype=np.float64)
    nc, nn = cell_dofs.shape
    dim = origins.shape[1]
    nf = fine_local.shape[-1]
    cap = max(1024, nc * nf * 4)
    while True:
        out_dof = np.empty(cap, dtype=np.int32)
        out_mast = np.empty(cap, dtype=np.int32)
        out_w = np.empty(cap, dtype=np.float64)
        marks_c = np.array(marks, dtype=np.uint8)  # fresh copy: a failed
        # capacity attempt must not pollute the caller's marks
        n = _lib.tpufem_hanging_face_constraints(
            origins.ctypes.data, sizes.ctypes.data, nc, dim,
            cell_dofs.ctypes.data, nn, face_nbr.ctypes.data,
            fine_local.ctypes.data, coarse_local.ctypes.data,
            Wt.ctypes.data, nf, marks_c.ctypes.data,
            out_dof.ctypes.data, out_mast.ctypes.data, out_w.ctypes.data,
            cap,
        )
        if n >= 0:
            marks[:] = marks_c
            return out_dof[:n], out_mast[:n], out_w[:n]
        cap *= 4


def hanging_edge_constraints(origins, sizes, U, cell_dofs, edge_local,
                             Wsub, marks):
    """Native 3D edge-constraint triplets (same contract as above)."""
    if not available():
        return None
    _setup_constraint_protos(_lib)
    origins = np.ascontiguousarray(origins, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    cell_dofs = np.ascontiguousarray(cell_dofs, dtype=np.int32)
    edge_local = np.ascontiguousarray(edge_local, dtype=np.int32)
    Wsub = np.ascontiguousarray(Wsub, dtype=np.float64)
    nc, nn = cell_dofs.shape
    n1 = edge_local.shape[-1]
    cap = max(1024, nc * n1 * 4)
    while True:
        out_dof = np.empty(cap, dtype=np.int32)
        out_mast = np.empty(cap, dtype=np.int32)
        out_w = np.empty(cap, dtype=np.float64)
        marks_c = np.array(marks, dtype=np.uint8)
        n = _lib.tpufem_hanging_edge_constraints(
            origins.ctypes.data, sizes.ctypes.data, nc, U,
            cell_dofs.ctypes.data, nn, edge_local.ctypes.data,
            Wsub.ctypes.data, n1, marks_c.ctypes.data,
            out_dof.ctypes.data, out_mast.ctypes.data, out_w.ctypes.data,
            cap,
        )
        if n >= 0:
            marks[:] = marks_c
            return out_dof[:n], out_mast[:n], out_w[:n]
        cap *= 4
