// Per-window alignment-tag expansion for the consensus engine: the
// bam2aln + get_align_shift + clip_aln walk (lib/ctg_cns.c:2403-2456,
// :139-201, :2809-2826) over every selected read in one native pass,
// replacing the per-read numpy loop (models/cns/tags.py read_columns +
// trim_read_columns + WindowAccum.add_row, which stays as the oracle).
//
// The caller pre-filters reads (primary, l_qseq > 0, clip-ratio /
// gap-candidate bypass) and passes them in BAM order; the coverage
// overload check (cov > 3000 / cov > 500 with a short aligned fraction,
// ctg_cns_core :3543-3546) is sequential against the accumulating
// coverage track, so it lives here too.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int CMATCH = 0, CINS = 1, CDEL = 2, CREF_SKIP = 3, CSOFT = 4,
              CHARD = 5, CEQ = 7, CDIFF = 8;
constexpr uint8_t GAP = 4, NBASE = 5;

// BAM nibble -> consensus base code (tags.py NIB_TO_CNS)
constexpr uint8_t NIB2CNS[16] = {NBASE, 0, 3,     NBASE, 2,     NBASE,
                                 NBASE, NBASE, 1, NBASE, NBASE, NBASE,
                                 NBASE, NBASE, NBASE, NBASE};

struct Col {
    int64_t tpos;
    int32_t qidx;  // -1 for deletion columns
    uint8_t qbase;
    uint8_t is_ins;
};

}  // namespace

extern "C" {

// Walk `n_sel` reads; emit kept rows' columns + tracks.  Outputs are
// malloc'd (npt_cns_free).  Returns number of kept rows, or -1 on error.
//   keep[n_sel] (uint8 out), q_s[n_sel] (int32 out) are caller-allocated.
//   rd_s/rd_e: query clip bounds per selected read (python precomputes).
//   coverage must have L+1 slots, l_ins/l_del/max_delta L slots, all
//   zeroed by the caller (they accumulate).
long long npt_cns_tags(
    const int64_t* sel, long long n_sel, const int32_t* rpos,
    const uint32_t* cigar, const int64_t* cigar_off, const int32_t* cigar_len,
    const uint8_t* seq_nib, const int64_t* seq_off, const int32_t* lqseq,
    const int32_t* rd_s, const int32_t* rd_e, const uint8_t* ref_cns,
    long long win_s, long long win_e, int anchor_k, int min_span,
    int gap_min_len, uint8_t* keep, int32_t* q_s_out, int32_t* coverage,
    int32_t* l_ins, int32_t* l_del, int32_t* max_delta, int32_t** out_t,
    int16_t** out_d, uint8_t** out_q, int64_t** out_roff,
    int32_t** out_aln_s, int32_t** out_aln_e) {
    const long long L = win_e - win_s;
    if (L <= 0) return -1;
    std::vector<Col> cols;
    std::vector<int32_t> all_t;
    std::vector<int16_t> all_d;
    std::vector<uint8_t> all_q;
    std::vector<int64_t> roff{0};
    std::vector<int32_t> aln_s, aln_e;

    for (long long s = 0; s < n_sel; s++) {
        keep[s] = 0;
        q_s_out[s] = -1;
        const long long r = sel[s];
        const int32_t ncig = cigar_len[r];
        if (ncig <= 0) continue;
        const uint32_t* cig = cigar + cigar_off[r];
        const uint8_t* nib = seq_nib + seq_off[r];

        // ---- expand_columns ----
        cols.clear();
        long long qpos = 0, tpos = rpos[r];
        for (int32_t w = 0; w < ncig; w++) {
            const int op = cig[w] & 0xF;
            const long long ln = cig[w] >> 4;
            if (op == CMATCH) {
                // only M/I/D emit; = / X advance nothing, mirroring
                // tags.py expand_columns' qcon/rcon sets exactly
                for (long long j = 0; j < ln; j++) {
                    cols.push_back(Col{tpos + j, (int32_t)(qpos + j),
                                       NIB2CNS[nib[qpos + j] & 0xF], 0});
                }
                qpos += ln;
                tpos += ln;
            } else if (op == CINS) {
                for (long long j = 0; j < ln; j++) {
                    cols.push_back(Col{tpos - 1, (int32_t)(qpos + j),
                                       NIB2CNS[nib[qpos + j] & 0xF], 1});
                }
                qpos += ln;
            } else if (op == CDEL) {
                for (long long j = 0; j < ln; j++)
                    cols.push_back(Col{tpos + j, -1, GAP, 0});
                tpos += ln;
            } else if (op == CREF_SKIP) {
                tpos += ln;
            } else if (op == CSOFT || op == CHARD) {
                qpos += ln;
            }
        }
        if (cols.empty()) continue;

        // ---- trim_read_columns: window clip ----
        long long lo = 0, hi = (long long)cols.size();
        const bool clipped =
            cols.front().tpos < win_s || cols.back().tpos >= win_e;
        if (clipped) {
            while (lo < hi && !(cols[lo].tpos >= win_s &&
                                cols[lo].tpos < win_e))
                lo++;
            while (hi > lo && !(cols[hi - 1].tpos >= win_s &&
                                cols[hi - 1].tpos < win_e))
                hi--;
            if (hi - lo <= 501) continue;
            while (lo < hi && cols[lo].is_ins) lo++;  // leading insertions
        }
        if (lo >= hi) continue;

        // ---- anchor trim: first/last runs of anchor_k exact matches ----
        long long s_i = -1, e_i = -1, run = 0;
        for (long long i = lo; i < hi; i++) {
            const Col& c = cols[i];
            const bool tm = !c.is_ins && c.qbase != GAP && c.tpos >= win_s &&
                            c.tpos < win_e &&
                            c.qbase == ref_cns[c.tpos - win_s];
            run = tm ? run + 1 : 0;
            if (run >= anchor_k) {
                if (s_i < 0) s_i = i - anchor_k + 1;
                e_i = i;
            }
        }
        if (s_i < 0) continue;
        if (cols[e_i].tpos - cols[s_i].tpos + 1 < min_span) continue;

        // ---- coverage overload check (needs accumulated coverage) ----
        const long long t0 = cols[s_i].tpos - win_s;
        const long long t1 = cols[e_i].tpos - win_s;
        const long long cov_s = coverage[t0] + (t0 < L ? 1 : 0);
        const long long cov_e = coverage[t1 + 1] + (t1 + 1 < L ? 1 : 0);
        const long long lq = lqseq[r];
        if ((cov_s > 3000 && cov_e > 3000) ||
            (cov_s > 500 && cov_e > 500 &&
             rd_e[s] - rd_s[s] < (double)lq * 0.9))
            continue;

        // ---- emit row + tracks (WindowAccum.add_row) ----
        keep[s] = 1;
        q_s_out[s] = cols[s_i].qidx;
        aln_s.push_back((int32_t)t0);
        aln_e.push_back((int32_t)t1);
        int16_t delta = 0;
        int prev_big = 0;
        for (long long i = s_i; i <= e_i; i++) {
            const Col& c = cols[i];
            const int32_t tl = (int32_t)(c.tpos - win_s);
            delta = c.is_ins ? (int16_t)(delta + 1) : 0;
            all_t.push_back(tl);
            all_d.push_back(delta);
            all_q.push_back(c.qbase);
            if (delta == 0) {
                coverage[tl]++;
                if (c.qbase == GAP) l_del[tl]++;
            }
            if (delta > max_delta[tl]) max_delta[tl] = delta;
            const int big = delta >= gap_min_len;
            if (big && !prev_big) l_ins[tl]++;
            prev_big = big;
        }
        roff.push_back((int64_t)all_t.size());
    }

    const long long n_rows = (long long)roff.size() - 1;
    const size_t T = all_t.size();
    *out_t = (int32_t*)malloc(4 * (T ? T : 1));
    *out_d = (int16_t*)malloc(2 * (T ? T : 1));
    *out_q = (uint8_t*)malloc(T ? T : 1);
    *out_roff = (int64_t*)malloc(8 * (size_t)(n_rows + 1));
    *out_aln_s = (int32_t*)malloc(4 * (size_t)(n_rows ? n_rows : 1));
    *out_aln_e = (int32_t*)malloc(4 * (size_t)(n_rows ? n_rows : 1));
    if (!*out_t || !*out_d || !*out_q || !*out_roff || !*out_aln_s ||
        !*out_aln_e)
        return -1;
    if (T) {
        memcpy(*out_t, all_t.data(), 4 * T);
        memcpy(*out_d, all_d.data(), 2 * T);
        memcpy(*out_q, all_q.data(), T);
    }
    memcpy(*out_roff, roff.data(), 8 * (size_t)(n_rows + 1));
    if (n_rows) {
        memcpy(*out_aln_s, aln_s.data(), 4 * (size_t)n_rows);
        memcpy(*out_aln_e, aln_e.data(), 4 * (size_t)n_rows);
    }
    return n_rows;
}

}  // extern "C"
