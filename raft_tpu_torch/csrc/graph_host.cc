// Host routines of the graph path (the port's own copy of the JAX
// package's native runtime routines it needs): COO rows -> CSR indptr,
// label compaction, the union-find dendrogram of weight-sorted MST edges
// and its flat cut (cluster/detail/agglomerative.cuh's host-side role).
//
// Built with the system C++ compiler into raft_tpu_torch/_build/ at first
// use (raft_tpu_torch/native), loaded with ctypes; a plain C interface.
// Every routine has a Python twin the CPU tests hold it against.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// rows: (nnz,) COO row ids in [0, n_rows). indptr_out: (n_rows+1,) int64.
// Rows need not be sorted (a counting pass). Returns 0 on ok, -1 on a row
// out of range.
int32_t gh_coo_rows_to_indptr(const int64_t* rows, int64_t nnz, int64_t n_rows,
                              int64_t* indptr_out) {
  if (n_rows < 0) return -1;
  for (int64_t i = 0; i <= n_rows; ++i) indptr_out[i] = 0;
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t r = rows[i];
    if (r < 0 || r >= n_rows) return -1;
    indptr_out[r + 1]++;
  }
  for (int64_t r = 0; r < n_rows; ++r) indptr_out[r + 1] += indptr_out[r];
  return 0;
}

}  // extern "C"

namespace {

int64_t uf_find(int64_t* parent, int64_t x) {
  int64_t root = x;
  while (parent[root] != root) root = parent[root];
  while (parent[x] != root) {
    int64_t nxt = parent[x];
    parent[x] = root;
    x = nxt;
  }
  return root;
}

// Map values onto [0, n_unique) in sorted-unique order (np.unique
// return_inverse semantics); writes the sorted unique values to
// unique_out when it is given. Returns n_unique, or -2 past capacity.
int64_t densify_sorted(const int64_t* vals, int64_t n, int64_t* out,
                       int64_t* unique_out, int64_t capacity) {
  std::vector<int64_t> uniq(vals, vals + n);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  int64_t nu = static_cast<int64_t>(uniq.size());
  if (unique_out) {
    if (nu > capacity) return -2;
    for (int64_t i = 0; i < nu; ++i) unique_out[i] = uniq[i];
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* it = std::lower_bound(uniq.data(), uniq.data() + nu, vals[i]);
    out[i] = it - uniq.data();
  }
  return nu;
}

}  // namespace

extern "C" {

// labels (n,) -> out (n,) dense ids; unique_out (capacity) the sorted
// unique values, *n_unique_out their count. 0 on ok, -2 past capacity.
int32_t gh_make_monotonic(const int64_t* labels, int64_t n, int64_t* out,
                          int64_t* unique_out, int64_t capacity,
                          int64_t* n_unique_out) {
  int64_t nu = densify_sorted(labels, n, out, unique_out, capacity);
  if (nu < 0) return static_cast<int32_t>(nu);
  *n_unique_out = nu;
  return 0;
}

// Edges sorted by weight (the caller's stable sort). children_out (n-1, 2)
// int64, deltas_out (n-1) double, sizes_out (n-1) int64 in the scipy
// convention. Returns the number of merges m <= n-1, or -1 on bad input.
int64_t gh_mst_linkage(const int32_t* src, const int32_t* dst, const float* w,
                       int64_t n_edges, int64_t n, int64_t* children_out,
                       double* deltas_out, int64_t* sizes_out) {
  if (n <= 0) return -1;
  std::vector<int64_t> parent(2 * n - 1);
  std::vector<int64_t> size(2 * n - 1, 1);
  for (int64_t i = 0; i < 2 * n - 1; ++i) parent[i] = i;
  int64_t nxt = n, m = 0;
  for (int64_t e = 0; e < n_edges && m < n - 1; ++e) {
    int64_t a = src[e], b = dst[e];
    if (a < 0 || a >= n || b < 0 || b >= n) return -1;
    int64_t ra = uf_find(parent.data(), a);
    int64_t rb = uf_find(parent.data(), b);
    if (ra == rb) continue;
    children_out[2 * m] = ra;
    children_out[2 * m + 1] = rb;
    deltas_out[m] = static_cast<double>(w[e]);
    size[nxt] = size[ra] + size[rb];
    sizes_out[m] = size[nxt];
    parent[ra] = parent[rb] = nxt;
    ++nxt;
    ++m;
  }
  return m;
}

// Flat labels from the first (m - (n_clusters - 1)) merges of a children
// table of m rows: labels_out (n,) int32 dense ids in sorted-root order.
// Returns the number of distinct labels, or -1 on bad input.
int64_t gh_cut_tree(const int64_t* children, int64_t m, int64_t n,
                    int64_t n_clusters, int32_t* labels_out) {
  if (n <= 0 || n_clusters < 1 || m < 0 || m > n - 1) return -1;
  std::vector<int64_t> parent(2 * n - 1);
  for (int64_t i = 0; i < 2 * n - 1; ++i) parent[i] = i;
  int64_t keep = m - (n_clusters - 1);
  if (keep < 0) keep = 0;
  for (int64_t e = 0; e < keep; ++e) {
    int64_t a = children[2 * e], b = children[2 * e + 1];
    if (a < 0 || a >= 2 * n - 1 || b < 0 || b >= 2 * n - 1) return -1;
    int64_t nxt = n + e;
    parent[uf_find(parent.data(), a)] = nxt;
    parent[uf_find(parent.data(), b)] = nxt;
  }
  std::vector<int64_t> roots(n);
  for (int64_t i = 0; i < n; ++i) roots[i] = uf_find(parent.data(), i);
  std::vector<int64_t> dense(n);
  int64_t nu = densify_sorted(roots.data(), n, dense.data(), nullptr, 0);
  for (int64_t i = 0; i < n; ++i) labels_out[i] = static_cast<int32_t>(dense[i]);
  return nu;
}

}  // extern "C"
