// Exact insertion-only incremental DBSCAN core: the sequential half of the
// DBSCAN_incr approach (reference main.py:87-91, which wraps the incdbscan
// library's IncrementalDBSCAN.insert/get_cluster_labels).
//
// The port's copy of mused_tpu/native/incdbscan.cpp (same code, same ABI).
// Split (see mused_tpu_torch/ops/dbscan.IncrementalDBSCAN): the O(n*N*d)
// geometry — new-batch x all-points distances and exact eps-neighbor
// extraction — runs on the device as matrix products + a top-k; THIS file
// maintains the irreducibly-sequential cluster structure over the
// discovered eps-pairs:
//
//   * count[i]  = |N_eps(i)| including self (monotone under insertion)
//   * adjacency lists (each unordered pair is delivered exactly once, when
//     its later endpoint is inserted)
//   * union-find over CORE points: an edge (p, q) joins the components the
//     moment the LATER of p, q becomes core — core status is monotone, so
//     marking all of a batch's new-core points first and then uniting each
//     with its already-core neighbors processes every core-core edge exactly
//     when it materializes.  Labels therefore equal batch DBSCAN's connected
//     components over the full inserted set, regardless of batch boundaries.
//   * border points (non-core with a core neighbor) attach to their FIRST
//     core neighbor in discovery order — deterministic given the stream;
//     sklearn's scan-order tie-break can differ (documented deviation,
//     ops/dbscan.py module docstring of the JAX package).
//
// Labels are compacted to first-occurrence ids (matching ops/dbscan.dbscan);
// noise is -1.
//
// ABI (plain C, ctypes):
//   void*  mused_incdb_create(int64_t min_pts);
//   void   mused_incdb_free(void* h);
//   int64_t mused_incdb_insert(h, n_new, n_pairs, pa[], pb[])  -> new total N
//     pa/pb: int32 global point ids, every unordered eps-pair once, both
//     endpoints < N_old + n_new.  Returns -1 on a malformed pair id.
//   void   mused_incdb_labels(h, out[N])  -> int32 labels, noise -1
//
// Built at first use by mused_tpu_torch/native/__init__.py with the host C++
// compiler into mused_tpu_torch/_build/.

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

struct IncDB {
    int64_t min_pts;
    std::vector<int32_t> count;                 // |N_eps(i)|, self included
    std::vector<uint8_t> is_core;
    std::vector<int32_t> parent;                // union-find (core points)
    std::vector<std::vector<int32_t>> adj;      // discovery-ordered

    explicit IncDB(int64_t mp) : min_pts(mp) {}

    int32_t find(int32_t a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];      // path halving
            a = parent[a];
        }
        return a;
    }
    void unite(int32_t a, int32_t b) {
        int32_t ra = find(a), rb = find(b);
        if (ra != rb) parent[rb < ra ? ra : rb] = (rb < ra ? rb : ra);
    }
};

}  // namespace

extern "C" {

void* mused_incdb_create(int64_t min_pts) {
    return new IncDB(min_pts);
}

void mused_incdb_free(void* h) { delete static_cast<IncDB*>(h); }

int64_t mused_incdb_insert(void* h, int64_t n_new, int64_t n_pairs,
                           const int32_t* pa, const int32_t* pb) try {
    // no exception (bad_alloc included) may cross the ctypes boundary —
    // same rule sed2012_parser.cpp documents; -2 = allocation failure
    IncDB& db = *static_cast<IncDB*>(h);
    size_t n_old = db.count.size();
    size_t n_tot = n_old + static_cast<size_t>(n_new);

    // validate EVERY pair before mutating anything: a mid-batch -1 return
    // after resizing/counting left the C structure grown while the Python
    // caller's n stayed stale — a later labels() call then wrote
    // count.size() ints into an n_old-sized buffer (review r5)
    for (int64_t e = 0; e < n_pairs; e++) {
        int32_t a = pa[e], b = pb[e];
        if (a < 0 || b < 0 || static_cast<size_t>(a) >= n_tot
                || static_cast<size_t>(b) >= n_tot || a == b)
            return -1;
    }

    db.count.resize(n_tot, 1);                  // self counts toward min_pts
    db.is_core.resize(n_tot, 0);
    db.adj.resize(n_tot);
    db.parent.resize(n_tot);
    for (size_t i = n_old; i < n_tot; i++)
        db.parent[i] = static_cast<int32_t>(i);

    for (int64_t e = 0; e < n_pairs; e++) {
        int32_t a = pa[e], b = pb[e];
        db.adj[a].push_back(b);
        db.adj[b].push_back(a);
        db.count[a]++;
        db.count[b]++;
    }

    // mark ALL of this batch's core transitions first, then unite — so an
    // edge between two same-batch transitions is united from either side
    std::vector<int32_t> newly_core;
    for (size_t i = 0; i < n_tot; i++) {
        if (!db.is_core[i] && db.count[i] >= db.min_pts) {
            db.is_core[i] = 1;
            newly_core.push_back(static_cast<int32_t>(i));
        }
    }
    for (int32_t p : newly_core)
        for (int32_t q : db.adj[p])
            if (db.is_core[q]) db.unite(p, q);

    return static_cast<int64_t>(n_tot);
} catch (...) {
    return -2;
}

void mused_incdb_labels(void* h, int32_t* out) {
    IncDB& db = *static_cast<IncDB*>(h);
    size_t n = db.count.size();
    // roots: core -> own component root; border -> first core neighbor's
    // root; noise -> -1
    std::vector<int32_t> root(n, -1);
    for (size_t i = 0; i < n; i++) {
        if (db.is_core[i]) {
            root[i] = db.find(static_cast<int32_t>(i));
        } else {
            for (int32_t q : db.adj[i]) {
                if (db.is_core[q]) { root[i] = db.find(q); break; }
            }
        }
    }
    // compact to first-occurrence ids
    std::vector<int32_t> compact(n, -1);
    int32_t next_id = 0;
    for (size_t i = 0; i < n; i++) {
        if (root[i] < 0) { out[i] = -1; continue; }
        if (compact[root[i]] < 0) compact[root[i]] = next_id++;
        out[i] = compact[root[i]];
    }
}

}  // extern "C"
