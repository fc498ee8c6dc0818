// Grid-graph max-flow / min-cut (Dinic) — the GrabCut backbone of
// rustcv_tpu_torch/ops/grabcut.py (a copy of rustcv_tpu/native/maxflow.cpp).
//
// The reference keeps its runtime native (Rust); our host-side combinatorial
// solver is C++ for the same reason: per-node pointer chasing is hostile to
// both Python and XLA. The graph is the standard vision grid: one node per
// pixel, terminal links to source/sink, and 8-neighborhood n-links given as
// four symmetric capacity planes (right, down, down-right, down-left).
//
// Dinic with BFS level graphs + DFS blocking flows; capacities int64.
// After the flow saturates, nodes reachable from the source in the residual
// graph are labeled 1 (foreground side of the min cut).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Graph {
    // edge arrays (pairs: e and e^1 are reverse edges)
    std::vector<int> to;
    std::vector<int64_t> cap;
    std::vector<int> next;   // next edge index in node's list
    std::vector<int> head;   // first edge index per node
    std::vector<int> level;
    std::vector<int> iter;

    explicit Graph(int n) : head(n, -1), level(n), iter(n) {}

    void add(int u, int v, int64_t c_uv, int64_t c_vu) {
        to.push_back(v); cap.push_back(c_uv); next.push_back(head[u]);
        head[u] = (int)to.size() - 1;
        to.push_back(u); cap.push_back(c_vu); next.push_back(head[v]);
        head[v] = (int)to.size() - 1;
    }

    bool bfs(int s, int t) {
        std::fill(level.begin(), level.end(), -1);
        std::vector<int> q;
        q.reserve(level.size());
        q.push_back(s);
        level[s] = 0;
        for (size_t qi = 0; qi < q.size(); ++qi) {
            int u = q[qi];
            for (int e = head[u]; e >= 0; e = next[e]) {
                if (cap[e] > 0 && level[to[e]] < 0) {
                    level[to[e]] = level[u] + 1;
                    q.push_back(to[e]);
                }
            }
        }
        return level[t] >= 0;
    }

    int64_t dfs(int u, int t, int64_t f) {
        if (u == t) return f;
        for (int &e = iter[u]; e >= 0; e = next[e]) {
            int v = to[e];
            if (cap[e] > 0 && level[v] == level[u] + 1) {
                int64_t d = dfs(v, t, f < cap[e] ? f : cap[e]);
                if (d > 0) {
                    cap[e] -= d;
                    cap[e ^ 1] += d;
                    return d;
                }
            }
        }
        return 0;
    }

    int64_t maxflow(int s, int t) {
        int64_t flow = 0;
        while (bfs(s, t)) {
            for (size_t i = 0; i < iter.size(); ++i) iter[i] = head[i];
            int64_t f;
            while ((f = dfs(s, t, INT64_MAX)) > 0) flow += f;
        }
        return flow;
    }
};

}  // namespace

extern "C" int64_t rcv_maxflow_grid(
    int32_t h, int32_t w,
    const int64_t* cap_src, const int64_t* cap_snk,
    const int64_t* cap_r, const int64_t* cap_d,
    const int64_t* cap_dr, const int64_t* cap_dl,
    uint8_t* labels /* out: 1 = source (foreground) side */) {
    if (h <= 0 || w <= 0) return -1;
    const int n = h * w;
    const int S = n, T = n + 1;
    Graph g(n + 2);
    // reserve: 2 t-link pairs + up to 4 n-link pairs per pixel, 2 ints each
    g.to.reserve((size_t)n * 12);
    g.cap.reserve((size_t)n * 12);
    g.next.reserve((size_t)n * 12);
    for (int i = 0; i < n; ++i) {
        if (cap_src[i] > 0) g.add(S, i, cap_src[i], 0);
        if (cap_snk[i] > 0) g.add(i, T, cap_snk[i], 0);
    }
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int i = y * w + x;
            if (x + 1 < w && cap_r[i] > 0) g.add(i, i + 1, cap_r[i], cap_r[i]);
            if (y + 1 < h && cap_d[i] > 0) g.add(i, i + w, cap_d[i], cap_d[i]);
            if (x + 1 < w && y + 1 < h && cap_dr[i] > 0)
                g.add(i, i + w + 1, cap_dr[i], cap_dr[i]);
            if (x > 0 && y + 1 < h && cap_dl[i] > 0)
                g.add(i, i + w - 1, cap_dl[i], cap_dl[i]);
        }
    }
    int64_t flow = g.maxflow(S, T);
    // residual reachability from S = foreground side
    std::vector<int> q;
    q.reserve(n);
    std::memset(labels, 0, (size_t)n);
    std::vector<uint8_t> seen(n + 2, 0);
    seen[S] = 1;
    q.push_back(S);
    for (size_t qi = 0; qi < q.size(); ++qi) {
        int u = q[qi];
        for (int e = g.head[u]; e >= 0; e = g.next[e]) {
            int v = g.to[e];
            if (g.cap[e] > 0 && !seen[v]) {
                seen[v] = 1;
                if (v < n) labels[v] = 1;
                q.push_back(v);
            }
        }
    }
    return flow;
}
