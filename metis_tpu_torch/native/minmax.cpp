// Native hot loop of the layer balancer: memory-feasible minmax partition.
//
// The planner evaluates this DP tens of thousands of times per search
// (balance/layers.py partition() — HOT LOOP 2 of the search, SURVEY.md §3.1);
// problem sizes are tiny (L ~ 10..128 layers, S <= 16 stages), so Python/numpy
// per-op overhead dominates the pure-Python implementation.  Semantics are
// identical to metis_tpu_torch.balance.layers.minmax_partition (differentially
// tested in tests/test_torch_native.py):
//
//   minimize over contiguous partitions of L layers into S non-empty stages
//     max_s  weight(i_s, j_s) / perf[s]
//   subject to  base + coef * (mem_prefix[s][j] - mem_prefix[s][i]) <= cap[s]
//
// First-minimal-index tie-breaking matches the Python DP's strict `<` test.
//
// Build: g++ -O3 -shared -fPIC -o _build/libminmax_<hash>.so minmax.cpp
// (done at first use by metis_tpu_torch/native/__init__.py; no external deps).

#include <cstddef>
#include <limits>
#include <vector>

extern "C" {

// Returns 0 and fills out_bounds[0..S] on success; 1 when infeasible.
// wprefix: L+1 weight prefix sums.  perf: S stage performances.
// mem_prefix: S*(L+1) row-major memory prefix sums, or nullptr to skip the
// capacity constraint.  cap: S stage capacities (ignored when mem_prefix is
// null).  base/coef: demand model constants (demand = base + coef * span).
int metis_minmax_partition(const double* wprefix, int L,
                           const double* perf, int S,
                           const double* mem_prefix, const double* cap,
                           double base, double coef,
                           int* out_bounds) {
    const double INF = std::numeric_limits<double>::infinity();
    if (S > L) return 1;

    std::vector<double> best((std::size_t)L + 1, INF), nbest((std::size_t)L + 1);
    std::vector<int> choice((std::size_t)S * (L + 1), -1);

    // stage 0: layers [0, j)
    {
        const double p = perf[0];
        const double* mp = mem_prefix;
        for (int j = 1; j <= L; ++j) {
            if (mp && base + coef * (mp[j] - mp[0]) > cap[0]) continue;
            if (p <= 0) continue;
            best[j] = (wprefix[j] - wprefix[0]) / p;
            choice[j] = 0;
        }
    }

    for (int s = 1; s < S; ++s) {
        const double p = perf[s];
        const double* mp = mem_prefix ? mem_prefix + (std::size_t)s * (L + 1)
                                      : nullptr;
        for (int j = 0; j <= L; ++j) nbest[j] = INF;
        for (int j = s + 1; j <= L; ++j) {
            double bv = INF;
            int bi = -1;
            for (int i = s; i < j; ++i) {
                const double prev = best[i];
                if (prev == INF) continue;
                if (mp && base + coef * (mp[j] - mp[i]) > cap[s]) continue;
                const double c = p > 0 ? (wprefix[j] - wprefix[i]) / p : INF;
                const double cand = prev > c ? prev : c;
                if (cand < bv) { bv = cand; bi = i; }
            }
            nbest[j] = bv;
            choice[(std::size_t)s * (L + 1) + j] = bi;
        }
        best.swap(nbest);
    }

    if (!(best[L] < INF)) return 1;
    int j = L;
    out_bounds[S] = L;
    for (int s = S - 1; s >= 0; --s) {
        j = choice[(std::size_t)s * (L + 1) + j];
        out_bounds[s] = j;
    }
    return 0;
}

}  // extern "C"
