// Native host-side graph preprocessing.
//
// The port's own copy of the entry points of
// `deep_gcns_torch_tpu/native/graphbuild.cpp` that the port calls: the
// per-cluster edge extraction of cluster training (partition_edges,
// extract_cluster) and the band route's rcm_order, cluster_order,
// band_windows and band_counts, byte for byte in their bodies so that both
// packages build identical host arrays.  The edge sort comes with the slice
// that calls it.
//
// The reference delegates its host hot loops to third-party native code
// (scipy CSR slicing for per-epoch partitioning, `utils/data_util.py:48-61`;
// torch_cluster for kNN); this library takes that role.
//
// Exposed via a plain C ABI, loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Per-cluster subgraph extraction for random-partition training
// (reference semantics: keep intra-cluster edges only,
// `examples/ogb/ogbn_proteins/dataset.py:117-144`).
//
//   parts:        [n_nodes] cluster id per node, in [0, n_clusters)
//   local_id:     [n_nodes] output: node rank within its cluster
//   cluster_size: [n_clusters] output
//   edge_cluster: [n_edges] output: owning cluster of each intra-cluster edge,
//                 or -1 for cross-cluster edges
// Returns the number of kept (intra-cluster) edges.
int64_t partition_edges(const int32_t* senders, const int32_t* receivers,
                        int64_t n_edges, const int32_t* parts, int32_t n_nodes,
                        int32_t n_clusters, int32_t* local_id,
                        int64_t* cluster_size, int32_t* edge_cluster) {
  std::memset(cluster_size, 0, sizeof(int64_t) * n_clusters);
  for (int32_t v = 0; v < n_nodes; ++v)
    local_id[v] = static_cast<int32_t>(cluster_size[parts[v]]++);
  int64_t kept = 0;
  for (int64_t i = 0; i < n_edges; ++i) {
    int32_t cs = parts[senders[i]];
    if (cs == parts[receivers[i]]) {
      edge_cluster[i] = cs;
      kept++;
    } else {
      edge_cluster[i] = -1;
    }
  }
  return kept;
}

// Gather + localize one cluster's edges (after partition_edges).
//   Writes localized (senders, receivers) of edges belonging to `cluster`
//   into out arrays; returns count.
int64_t extract_cluster(const int32_t* senders, const int32_t* receivers,
                        int64_t n_edges, const int32_t* edge_cluster,
                        const int32_t* local_id, int32_t cluster,
                        int32_t* out_s, int32_t* out_r, int32_t* out_eidx) {
  int64_t k = 0;
  for (int64_t i = 0; i < n_edges; ++i) {
    if (edge_cluster[i] == cluster) {
      out_s[k] = local_id[senders[i]];
      out_r[k] = local_id[receivers[i]];
      out_eidx[k] = static_cast<int32_t>(i);
      k++;
    }
  }
  return k;
}

// Reverse Cuthill-McKee ordering of the symmetrized graph — the host-side
// locality pass that makes the band/block-sparse TPU aggregation kernels
// profitable (tile fill) and shrinks spatial-parallel halo boundaries.  The
// reference has no counterpart (it partitions uniformly at random,
// `utils/data_util.py:43-45`).
//
//   perm_out: [n_nodes], perm_out[new_id] = old_id (scipy RCM convention)
void rcm_order(const int32_t* senders, const int32_t* receivers,
               int64_t n_edges, int32_t n_nodes, int32_t* perm_out) {
  // symmetric CSR adjacency (self loops kept; duplicates harmless for BFS)
  std::vector<int64_t> ptr(static_cast<size_t>(n_nodes) + 1, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    ptr[senders[i] + 1]++;
    ptr[receivers[i] + 1]++;
  }
  for (int32_t v = 0; v < n_nodes; ++v) ptr[v + 1] += ptr[v];
  std::vector<int32_t> adj(ptr[n_nodes]);
  {
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t i = 0; i < n_edges; ++i) {
      adj[cur[senders[i]]++] = receivers[i];
      adj[cur[receivers[i]]++] = senders[i];
    }
  }
  std::vector<int32_t> degree(n_nodes);
  for (int32_t v = 0; v < n_nodes; ++v)
    degree[v] = static_cast<int32_t>(ptr[v + 1] - ptr[v]);

  std::vector<int32_t> by_deg(n_nodes);
  for (int32_t v = 0; v < n_nodes; ++v) by_deg[v] = v;
  std::sort(by_deg.begin(), by_deg.end(),
            [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });

  std::vector<uint8_t> visited(n_nodes, 0);
  std::vector<int32_t> order;
  order.reserve(n_nodes);
  std::vector<int32_t> nbuf;
  size_t scan = 0;
  while (order.size() < static_cast<size_t>(n_nodes)) {
    while (scan < static_cast<size_t>(n_nodes) && visited[by_deg[scan]]) scan++;
    int32_t start = by_deg[scan];
    visited[start] = 1;
    order.push_back(start);
    size_t head = order.size() - 1;
    while (head < order.size()) {
      int32_t u = order[head++];
      nbuf.clear();
      for (int64_t e = ptr[u]; e < ptr[u + 1]; ++e) {
        int32_t w = adj[e];
        if (!visited[w]) {
          visited[w] = 1;
          nbuf.push_back(w);
        }
      }
      std::sort(nbuf.begin(), nbuf.end(),
                [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });
      order.insert(order.end(), nbuf.begin(), nbuf.end());
    }
  }
  // reverse (the "R" in RCM: reversing halves the profile for typical meshes)
  for (int32_t v = 0; v < n_nodes; ++v)
    perm_out[v] = order[n_nodes - 1 - v];
}

// Greedy max-connectivity cluster ordering.  RCM (above) minimizes bandwidth
// but its BFS frontier leaks through long-range edges, so it fails to recover
// community structure in small-world graphs; this pass grows clusters of
// `cluster_size` nodes by repeatedly absorbing the frontier node with the MOST
// edges into the current cluster (bucket priority queue with lazy deletion —
// O(E + N)).  Ordering = concatenated clusters, insertion order within each.
// Minimizes exactly what the TPU consumers care about: spatial-shard edge cuts
// (parallel/spatial.py halo volume) and band-window density (ops/band.py).
//
//   perm_out: [n_nodes], perm_out[new_id] = old_id
void cluster_order(const int32_t* senders, const int32_t* receivers,
                   int64_t n_edges, int32_t n_nodes, int32_t cluster_size,
                   int32_t* perm_out) {
  std::vector<int64_t> ptr(static_cast<size_t>(n_nodes) + 1, 0);
  for (int64_t i = 0; i < n_edges; ++i) {
    ptr[senders[i] + 1]++;
    ptr[receivers[i] + 1]++;
  }
  for (int32_t v = 0; v < n_nodes; ++v) ptr[v + 1] += ptr[v];
  std::vector<int32_t> adj(ptr[n_nodes]);
  {
    std::vector<int64_t> cur(ptr.begin(), ptr.end() - 1);
    for (int64_t i = 0; i < n_edges; ++i) {
      adj[cur[senders[i]]++] = receivers[i];
      adj[cur[receivers[i]]++] = senders[i];
    }
  }
  std::vector<int32_t> degree(n_nodes);
  for (int32_t v = 0; v < n_nodes; ++v)
    degree[v] = static_cast<int32_t>(ptr[v + 1] - ptr[v]);
  std::vector<int32_t> by_deg(n_nodes);
  for (int32_t v = 0; v < n_nodes; ++v) by_deg[v] = v;
  std::sort(by_deg.begin(), by_deg.end(),
            [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });

  std::vector<uint8_t> placed(n_nodes, 0);
  std::vector<int32_t> score(n_nodes, 0);   // links into the current cluster
  std::vector<int32_t> epoch(n_nodes, -1);  // which cluster the score is for
  // bucket queue over scores; lazy deletion (entries checked against score[])
  std::vector<std::vector<int32_t>> buckets;
  int32_t max_score = -1;
  int64_t pos = 0;
  size_t scan = 0;
  int32_t cur_epoch = 0;

  auto push = [&](int32_t v, int32_t s) {
    if (static_cast<size_t>(s) >= buckets.size()) buckets.resize(s + 1);
    buckets[s].push_back(v);
    if (s > max_score) max_score = s;
  };

  while (pos < n_nodes) {
    while (scan < static_cast<size_t>(n_nodes) && placed[by_deg[scan]]) scan++;
    int32_t seed = by_deg[scan];
    // fresh cluster: old queue entries are invalidated by the epoch check
    for (auto& b : buckets) b.clear();
    max_score = -1;
    cur_epoch++;
    score[seed] = 1;
    epoch[seed] = cur_epoch;
    push(seed, 1);
    int32_t cnt = 0;
    while (cnt < cluster_size) {
      int32_t u = -1;
      while (max_score >= 0) {
        auto& b = buckets[max_score];
        if (b.empty()) {
          max_score--;
          continue;
        }
        int32_t cand = b.back();
        b.pop_back();
        if (!placed[cand] && epoch[cand] == cur_epoch &&
            score[cand] == max_score) {
          u = cand;
          break;
        }
      }
      if (u < 0) break;  // frontier exhausted (component smaller than cluster)
      placed[u] = 1;
      perm_out[pos++] = u;
      cnt++;
      for (int64_t e = ptr[u]; e < ptr[u + 1]; ++e) {
        int32_t w = adj[e];
        if (placed[w]) continue;
        if (epoch[w] != cur_epoch) {
          epoch[w] = cur_epoch;
          score[w] = 0;
        }
        score[w]++;
        push(w, score[w]);
      }
    }
  }
}


// Band window selection (ops/band._build_window hot loop): senders sorted
// ascending WITHIN each receiver block (blk_start delimits blocks).  Phase 1:
// per candidate window, the best-interval edge count per block (two-pointer);
// phase 2: pick the window (smallest reaching target coverage, else
// score = covered - W * n_rows / cost_div); phase 3: for the chosen window,
// per-block aligned start w_lo and the in-band flag per edge.
// Returns the chosen window.
int32_t band_windows(const int32_t* s_sorted, const int64_t* blk_start,
                     int32_t nb, int32_t n_pad, const int32_t* cands,
                     int32_t n_cands, double target_cov, int64_t cost_div,
                     int32_t align, int64_t n_rows, int32_t* w_lo_out,
                     uint8_t* in_band_out) {
  int64_t n_edges = blk_start[nb];
  std::vector<int64_t> covered(n_cands, 0);
  for (int32_t b = 0; b < nb; ++b) {
    int64_t a = blk_start[b], z = blk_start[b + 1];
    if (a == z) continue;
    for (int32_t j = 0; j < n_cands; ++j) {
      int32_t w = cands[j];
      int64_t best = 0, hi = a;
      for (int64_t i = a; i < z; ++i) {
        if (hi < i) hi = i;
        while (hi < z && s_sorted[hi] < s_sorted[i] + w) ++hi;
        if (hi - i > best) best = hi - i;
      }
      covered[j] += best;
    }
  }
  int32_t window = -1;
  for (int32_t j = 0; j < n_cands; ++j) {
    if (covered[j] >= static_cast<int64_t>(target_cov * n_edges)) {
      window = cands[j];
      break;
    }
  }
  if (window < 0) {
    int64_t best_score = INT64_MIN;
    for (int32_t j = 0; j < n_cands; ++j) {
      int64_t score = covered[j]
          - static_cast<int64_t>(cands[j]) * n_rows / cost_div;
      if (score > best_score) {  // strict >: first max wins (numpy argmax)
        best_score = score;
        window = cands[j];
      }
    }
  }
  for (int32_t b = 0; b < nb; ++b) {
    int64_t a = blk_start[b], z = blk_start[b + 1];
    w_lo_out[b] = 0;
    if (a == z) continue;
    int64_t best = 0, best_i = a, hi = a;
    for (int64_t i = a; i < z; ++i) {
      if (hi < i) hi = i;
      while (hi < z && s_sorted[hi] < s_sorted[i] + window) ++hi;
      if (hi - i > best) { best = hi - i; best_i = i; }
    }
    int32_t lo = (s_sorted[best_i] / align) * align;
    if (lo > n_pad - window) lo = n_pad - window;
    if (lo < 0) lo = 0;
    w_lo_out[b] = lo;
    for (int64_t i = a; i < z; ++i)
      in_band_out[i] =
          (s_sorted[i] >= lo && s_sorted[i] < lo + window) ? 1 : 0;
  }
  return window;
}


// Band count-matrix fill (ops/band._build_window): one pass over the
// (block, sender)-sorted edges, incrementing int8 counts with saturation at
// 127; saturated increments spill to (spill_s, spill_r) for the leftover CSR.
// Returns the spill count, or -1 if it would exceed spill_cap (caller falls
// back to the numpy path).  a_band must arrive zeroed, shape [n_rows, window]
// row-major; rows are receiver ids, columns sender - w_lo[receiver / bn].
int64_t band_counts(const int32_t* s_sorted, const int32_t* r_sorted,
                    const uint8_t* in_band, int64_t n_edges,
                    const int32_t* w_lo, int32_t window, int32_t bn,
                    int8_t* a_band, int32_t* spill_s, int32_t* spill_r,
                    int64_t spill_cap) {
  int64_t n_spill = 0;
  for (int64_t i = 0; i < n_edges; ++i) {
    if (!in_band[i]) continue;
    int32_t r = r_sorted[i];
    int64_t col = s_sorted[i] - w_lo[r / bn];
    int8_t* cell = a_band + static_cast<int64_t>(r) * window + col;
    if (*cell == 127) {
      if (n_spill >= spill_cap) return -1;
      spill_s[n_spill] = s_sorted[i];
      spill_r[n_spill] = r;
      ++n_spill;
    } else {
      ++*cell;
    }
  }
  return n_spill;
}

}  // extern "C"
