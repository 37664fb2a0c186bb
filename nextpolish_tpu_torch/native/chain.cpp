// Anchor-chaining DP for the long-read mapper — the role of minimap2's
// mm_chain_dp (reference vendors minimap2 v2.22 at util/minimap2/chain.c;
// command contract source/nextPolish:208-216).  Scores follow the same
// shape: chaining anchor i after j adds min(dq, dr, k) matching bases and
// pays a gap cost of 0.01*avg_qspan*|dq-dr| + 0.5*log2|dq-dr| when the
// anchors are off-diagonal.  The result is per-anchor best score f[] and
// predecessor p[] (-1 for chain starts); chain extraction happens in
// Python (align/chain.py), which mirrors this loop as its numpy fallback.
#include <cstdint>

static inline int ilog2_32(uint32_t v) { return 31 - __builtin_clz(v | 1); }

extern "C" long long npt_chain_dp(
    const long long *qp, const long long *rp, long long n, int k,
    int bw, int max_dist, int max_iter, int max_skip, float avg_qspan,
    int *f, int *p)
{
    // anchors must arrive sorted by (rp, qp)
    long long st = 0;
    for (long long i = 0; i < n; ++i) {
        while (st < i && rp[i] - rp[st] > max_dist) ++st;
        int max_f = k;
        long long max_j = -1;
        int n_skip = 0;
        long long lo = (i - st > max_iter) ? i - max_iter : st;
        for (long long j = i - 1; j >= lo; --j) {
            long long dr = rp[i] - rp[j];
            long long dq = qp[i] - qp[j];
            if (dr <= 0 || dq <= 0 || dq > max_dist) continue;
            long long dd = dr > dq ? dr - dq : dq - dr;
            if (dd > bw) continue;
            long long min_d = dq < dr ? dq : dr;
            int sc = (int)(min_d < k ? min_d : k);
            if (dd)
                sc -= (int)(dd * 0.01 * avg_qspan)
                      + (ilog2_32((uint32_t)dd) >> 1);
            sc += f[j];
            if (sc > max_f) {
                max_f = sc;
                max_j = j;
                if (n_skip > 0) --n_skip;
            } else if (++n_skip > max_skip) {
                break;
            }
        }
        f[i] = max_f;
        p[i] = (int)max_j;
    }
    return 0;
}
