// tpufem_torch native setup runtime: the port's copy of the JAX package's
// csrc/tpufem_native.cpp (the same entry points and triplet order).
//
// Reference analogue: the C++ host side of MatrixFreeGpu::reinit — the
// per-cell walks deal.II performs for graph coloring, neighbor finding and
// constraint setup.  These are the setup loops that are genuinely
// scalar/irregular (hash probing, first-fit bitmasks) and thus a poor fit
// for numpy vectorization.
//
// Exposed via a plain C ABI consumed with ctypes (tpufem_torch.utils.native,
// which builds it with g++ at first use); every entry point has a numpy
// fallback there, so the package works without a compiler.

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

using std::size_t;

extern "C" {

// Greedy first-fit cell coloring with conflict = shared DoFs.
// (coloring.h / GraphColoring::make_graph_coloring analogue, SURVEY.md §2.)
// cell_dofs: nc x nn int32 row-major; colors_out: nc int32.
// Returns the number of colors, or -1 if more than 64 would be needed.
int32_t tpufem_greedy_color(const int32_t* cell_dofs, int64_t nc, int64_t nn,
                            int64_t n_dofs, int32_t* colors_out) {
  std::vector<uint64_t> dof_mask(static_cast<size_t>(n_dofs), 0);
  int32_t n_colors = 0;
  for (int64_t c = 0; c < nc; ++c) {
    const int32_t* row = cell_dofs + c * nn;
    uint64_t used = 0;
    for (int64_t j = 0; j < nn; ++j) used |= dof_mask[row[j]];
    int32_t col = 0;
    while ((used >> col) & 1ull) {
      ++col;
      if (col >= 64) return -1;
    }
    colors_out[c] = col;
    const uint64_t bit = 1ull << col;
    for (int64_t j = 0; j < nn; ++j) dof_mask[row[j]] |= bit;
    if (col + 1 > n_colors) n_colors = col + 1;
  }
  return n_colors;
}

// Coarse face-neighbor detection on a 2:1-balanced forest
// (hanging_nodes.cuh setup analogue, SURVEY.md §2).
// origins: nc x dim int64 row-major; sizes: nc int64; out: nc x dim x 2
// int64 = index of the DOUBLE-size neighbor across face (axis, side), or -1.
void tpufem_coarse_face_neighbors(const int64_t* origins,
                                  const int64_t* sizes, int64_t nc,
                                  int32_t dim, int64_t U, int64_t* out) {
  // hash leaves by (size, grid index)
  struct Key {
    int64_t s, a, b, c;
    bool operator==(const Key& o) const {
      return s == o.s && a == o.a && b == o.b && c == o.c;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      uint64_t h = 1469598103934665603ull;
      for (int64_t v : {k.s, k.a, k.b, k.c}) {
        h ^= static_cast<uint64_t>(v);
        h *= 1099511628211ull;
      }
      return static_cast<size_t>(h);
    }
  };
  std::unordered_map<Key, int64_t, KeyHash> leaves;
  leaves.reserve(static_cast<size_t>(nc) * 2);
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = sizes[c];
    Key k{s, origins[c * dim + 0] / s,
          dim > 1 ? origins[c * dim + 1] / s : 0,
          dim > 2 ? origins[c * dim + 2] / s : 0};
    leaves.emplace(k, c);
  }
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = sizes[c];
    const int64_t S = 2 * s;
    for (int32_t axis = 0; axis < dim; ++axis) {
      for (int32_t side = 0; side < 2; ++side) {
        int64_t& slot = out[(c * dim + axis) * 2 + side];
        slot = -1;
        const int64_t w = origins[c * dim + axis] + s * side;
        if (w == 0 || w == U) continue;
        const int64_t ax_origin = side == 1 ? w : w - S;
        if (ax_origin < 0 || ax_origin % S != 0) continue;
        int64_t co[3] = {0, 0, 0};
        for (int32_t a = 0; a < dim; ++a)
          co[a] = (origins[c * dim + a] / S) * S;
        co[axis] = ax_origin;
        Key k{S, co[0] / S, dim > 1 ? co[1] / S : 0,
              dim > 2 ? co[2] / S : 0};
        auto it = leaves.find(k);
        if (it != leaves.end()) slot = it->second;
      }
    }
  }
}

// Transpose incidence map: for each DoF, the padded list of flat
// (cell*nn + local) positions referencing it (scatter_incidence data,
// SURVEY.md §2 parallelism item 4).  counts_out must be zeroed (n_dofs).
// Returns max multiplicity K; call once with incidence_out == nullptr to
// size the output, then again with a (n_dofs x K) buffer prefilled with
// pad_value.
int64_t tpufem_build_incidence(const int32_t* cell_dofs, int64_t nc,
                               int64_t nn, int64_t n_dofs,
                               int64_t* counts_out, int32_t* incidence_out,
                               int64_t K, int32_t pad_value) {
  if (incidence_out == nullptr) {
    int64_t maxc = 0;
    for (int64_t i = 0; i < nc * nn; ++i) {
      const int64_t d = cell_dofs[i];
      if (++counts_out[d] > maxc) maxc = counts_out[d];
    }
    return maxc;
  }
  for (int64_t i = 0; i < nc * nn; ++i) {
    const int64_t d = cell_dofs[i];
    incidence_out[d * K + counts_out[d]++] = static_cast<int32_t>(i);
  }
  return K;
}

}  // extern "C"

extern "C" {

// Hanging-node FACE constraints on a 2:1-balanced forest — the native
// form of tpufem_torch.fem.constraints.make_hanging_node_constraints's face
// loop (hanging_nodes.cuh setup analogue, SURVEY.md §2).  Emits
// (constrained dof, master dof, weight) triplets in EXACTLY the Python
// path's visit order (cells ascending, axis, side, face row), with the
// same skip rules (coincident coarse node; first-constraint-wins), so the
// resulting AffineConstraints are bit-for-bit identical.
//
// face_nbr:     (nc, dim, 2) int64 — double-size neighbor or -1
// fine_local:   (dim, 2, nf) int32 — local face-node ids, fine side
// coarse_local: (dim, 2, nf) int32 — local face-node ids on the neighbor
// Wt:           (ncfg, nf, nf) double — subface weights per transverse
//               bits config (cfg = bits0 + 2*bits1)
// marks:        (n_dofs,) uint8 in/out — already-constrained flags
// Returns #triplets, or -1 if cap exceeded.
int64_t tpufem_hanging_face_constraints(
    const int64_t* origins, const int64_t* sizes, int64_t nc, int32_t dim,
    const int32_t* cell_dofs, int64_t nn, const int64_t* face_nbr,
    const int32_t* fine_local, const int32_t* coarse_local,
    const double* Wt, int64_t nf, uint8_t* marks, int32_t* out_dof,
    int32_t* out_master, double* out_w, int64_t cap) {
  const double tol = 1e-14;
  int64_t n_out = 0;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = sizes[c];
    for (int32_t axis = 0; axis < dim; ++axis) {
      for (int32_t side = 0; side < 2; ++side) {
        const int64_t cc = face_nbr[(c * dim + axis) * 2 + side];
        if (cc < 0) continue;
        // transverse bits -> weight config
        int64_t cfg = 0, mult = 1;
        for (int32_t t = 0; t < dim; ++t) {
          if (t == axis) continue;
          const int64_t bit =
              (origins[c * dim + t] - origins[cc * dim + t]) / s;
          cfg += bit * mult;
          mult *= 2;
        }
        const int32_t* fl = fine_local + (axis * 2 + side) * nf;
        const int32_t* cl = coarse_local + (axis * 2 + (1 - side)) * nf;
        const double* W = Wt + cfg * nf * nf;
        for (int64_t fi = 0; fi < nf; ++fi) {
          const int32_t fd = cell_dofs[c * nn + fl[fi]];
          // count nonzeros; check coincident single-entry case
          int64_t nz = 0, j_single = -1;
          for (int64_t j = 0; j < nf; ++j) {
            if (W[fi * nf + j] > tol || W[fi * nf + j] < -tol) {
              ++nz;
              j_single = j;
            }
          }
          if (nz == 1 && cell_dofs[cc * nn + cl[j_single]] == fd) continue;
          if (marks[fd]) continue;
          marks[fd] = 1;
          for (int64_t j = 0; j < nf; ++j) {
            const double w = W[fi * nf + j];
            if (w <= tol && w >= -tol) continue;
            if (n_out >= cap) return -1;
            out_dof[n_out] = fd;
            out_master[n_out] = cell_dofs[cc * nn + cl[j]];
            out_w[n_out] = w;
            ++n_out;
          }
        }
      }
    }
  }
  return n_out;
}

// Hanging-node EDGE constraints (3D): fine edges lying on coarse edges
// without a shared hanging face.  Mirrors the Python edge loop exactly
// (cells ascending, axis, corner bits, dt probes in (0,-1) order).
// edge_local: (3, 2, 2, n1) int32 — local edge-node ids per
//   (axis, b1, b2), ordered along +axis;  Wsub: (2, n1, n1) subface rows.
int64_t tpufem_hanging_edge_constraints(
    const int64_t* origins, const int64_t* sizes, int64_t nc, int64_t U,
    const int32_t* cell_dofs, int64_t nn, const int32_t* edge_local,
    const double* Wsub, int64_t n1, uint8_t* marks, int32_t* out_dof,
    int32_t* out_master, double* out_w, int64_t cap) {
  const int32_t dim = 3;
  const double tol = 1e-14;
  // leaves hashed by (size, grid index)
  struct Key {
    int64_t s, a, b, c;
    bool operator==(const Key& o) const {
      return s == o.s && a == o.a && b == o.b && c == o.c;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      uint64_t h = 1469598103934665603ull;
      for (int64_t v : {k.s, k.a, k.b, k.c}) {
        h ^= static_cast<uint64_t>(v);
        h *= 1099511628211ull;
      }
      return static_cast<size_t>(h);
    }
  };
  std::unordered_map<Key, int64_t, KeyHash> leaves;
  leaves.reserve(static_cast<size_t>(nc) * 2);
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = sizes[c];
    Key k{s, origins[c * dim] / s, origins[c * dim + 1] / s,
          origins[c * dim + 2] / s};
    leaves.emplace(k, c);
  }
  int64_t n_out = 0;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = sizes[c];
    const int64_t S = 2 * s;
    for (int32_t axis = 0; axis < 3; ++axis) {
      int32_t t1 = -1, t2 = -1;
      for (int32_t a = 0; a < 3; ++a) {
        if (a == axis) continue;
        if (t1 < 0) t1 = a; else t2 = a;
      }
      for (int32_t b1 = 0; b1 < 2; ++b1) {
        for (int32_t b2 = 0; b2 < 2; ++b2) {
          const int64_t w1 = origins[c * dim + t1] + s * b1;
          const int64_t w2 = origins[c * dim + t2] + s * b2;
          const int64_t eo = (origins[c * dim + axis] / S) * S;
          int64_t found = -1, co_t1 = 0, co_t2 = 0, co_ax = 0;
          const int64_t dts[2] = {0, -1};
          for (int32_t i1 = 0; i1 < 2 && found < 0; ++i1) {
            for (int32_t i2 = 0; i2 < 2 && found < 0; ++i2) {
              const int64_t ca = w1 + dts[i1] * S;
              const int64_t cb = w2 + dts[i2] * S;
              if (ca % S != 0 || cb % S != 0 || ca < 0 || cb < 0) continue;
              int64_t co[3];
              co[axis] = eo;
              co[t1] = ca;
              co[t2] = cb;
              if (co[0] < 0 || co[1] < 0 || co[2] < 0) continue;
              if (co[0] / S >= U / S || co[1] / S >= U / S ||
                  co[2] / S >= U / S)
                continue;
              Key k{S, co[0] / S, co[1] / S, co[2] / S};
              auto it = leaves.find(k);
              if (it != leaves.end()) {
                found = it->second;
                co_t1 = ca;
                co_t2 = cb;
                co_ax = eo;
              }
            }
          }
          if (found < 0) continue;
          const int64_t cb1 = (w1 - co_t1) / S;
          const int64_t cb2 = (w2 - co_t2) / S;
          const int32_t* F =
              edge_local + ((axis * 2 + b1) * 2 + b2) * n1;
          const int32_t* M =
              edge_local + ((axis * 2 + cb1) * 2 + cb2) * n1;
          const int64_t sub = (origins[c * dim + axis] - co_ax) / s;
          const double* W = Wsub + sub * n1 * n1;
          for (int64_t fi = 0; fi < n1; ++fi) {
            const int32_t fd = cell_dofs[c * nn + F[fi]];
            int64_t nz = 0, j_single = -1;
            for (int64_t j = 0; j < n1; ++j) {
              if (W[fi * n1 + j] > tol || W[fi * n1 + j] < -tol) {
                ++nz;
                j_single = j;
              }
            }
            if (nz == 1 && cell_dofs[found * nn + M[j_single]] == fd)
              continue;
            if (marks[fd]) continue;
            marks[fd] = 1;
            for (int64_t j = 0; j < n1; ++j) {
              const double w = W[fi * n1 + j];
              if (w <= tol && w >= -tol) continue;
              if (n_out >= cap) return -1;
              out_dof[n_out] = fd;
              out_master[n_out] = cell_dofs[found * nn + M[j]];
              out_w[n_out] = w;
              ++n_out;
            }
          }
        }
      }
    }
  }
  return n_out;
}

}  // extern "C"
