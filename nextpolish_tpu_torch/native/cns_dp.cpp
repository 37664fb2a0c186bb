// Consensus link DP — native engine for the per-window MSA + second-order
// DP + traceback (the hot loop of tasks 5/6).
//
// Semantics match lib/ctg_cns.c update_msa (:324) + get_cns_from_align_tags
// (:1876-2144) + generate_cns_from_best_score (:1828) exactly — insertion-
// order link entries, the stateful p_pp_score/p_pp_score_ bookkeeping and
// read-type tie rules — but the data layout is our own: per-position flat
// cell tables keyed (delta*6+base) with small entry vectors, fed from the
// flat column arrays produced by models/cns/tags.py.  Byte-equality vs the
// pure-numpy dp.py path is enforced by tests/test_cns_native.py.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t KEY_HEAD = -1;
constexpr int64_t I64_MIN = INT64_MIN;

inline int64_t pack_key(int64_t p, int64_t d, int64_t b) {
    return (p << 20) | (d << 3) | b;
}

struct Entry {
    int64_t pp, ppp;
    int64_t score;
    int32_t link;
};

struct Cell {
    std::vector<Entry> e;
    int32_t best = 0;
};

struct Msa {
    // per position: cells indexed d*6+b, sized on demand
    std::vector<std::vector<Cell>> pos;

    explicit Msa(int64_t length) : pos(length) {}

    Cell& at(int64_t p, int64_t d, int64_t b) {
        auto& v = pos[p];
        size_t need = (size_t)(d * 6 + b + 1);
        if (v.size() < need) v.resize((size_t)((d + 1) * 6));
        return v[(size_t)(d * 6 + b)];
    }
    Cell* find(int64_t key) {
        int64_t b = key & 7, d = (key >> 3) & ((1 << 17) - 1), p = key >> 20;
        auto& v = pos[(size_t)p];
        size_t idx = (size_t)(d * 6 + b);
        if (idx >= v.size()) return nullptr;
        return &v[idx];
    }
};

enum ReadType { RT_ONT = 0, RT_CLR = 1, RT_RS = 2, RT_HIFI = 3 };

}  // namespace

extern "C" void npt_cns_free(void* p) { free(p); }

// Returns number of consensus rows (>= 0) or -1 on error.  Output arrays
// are malloc'd here; caller frees each with npt_cns_free.
extern "C" int64_t npt_cns_dp(
    const int32_t* t_pos, const int16_t* delta_, const uint8_t* q_base,
    const int64_t* row_off, int64_t n_rows, const int32_t* coverage,
    int64_t length, int read_type, int min_cov, int lq_min_qv,
    int32_t** out_pos, uint8_t** out_base, int32_t** out_qv) {
    if (length <= 0 || n_rows <= 0) return 0;
    Msa msa(length);

    // ---- update_msa: insertion-order link lists ----
    for (int64_t r = 0; r < n_rows; r++) {
        int64_t pp = KEY_HEAD, ppp = KEY_HEAD;
        for (int64_t i = row_off[r]; i < row_off[r + 1]; i++) {
            int64_t key = pack_key(t_pos[i], delta_[i], q_base[i]);
            Cell& c = msa.at(t_pos[i], delta_[i], q_base[i]);
            bool updated = false;
            for (auto& e : c.e) {
                if (e.pp == pp && e.ppp == ppp) {
                    e.link++;
                    updated = true;
                    break;
                }
            }
            if (!updated) c.e.push_back(Entry{pp, ppp, 0, 1});
            ppp = pp;
            pp = key;
        }
    }

    // ---- the per-type scoring + winning-entry loops ----
    const int64_t cov_coef = read_type == RT_HIFI ? 4 : 3;
    int64_t global_best_score = I64_MIN;
    int64_t global_best_key = -1;
    for (int64_t p = 0; p < length; p++) {
        auto& cells = msa.pos[(size_t)p];
        const int64_t covp = coverage[p];
        const int64_t n_cells = (int64_t)cells.size();
        for (int64_t db = 0; db < n_cells; db++) {
            Cell& c = cells[(size_t)db];
            if (c.e.empty()) continue;
            const int64_t b = db % 6;
            c.best = 0;
            int64_t p_pp = I64_MIN;
            int64_t raiser = I64_MIN;  // p_pp_score_, carries across entries
            int64_t tmp = 0;
            if (read_type == RT_ONT) {
                for (auto& e : c.e)
                    if (e.link > tmp) tmp = e.link;
            }
            const int64_t m_n = (int64_t)c.e.size();
            for (int64_t mi = 0; mi < m_n; mi++) {
                Entry& m = c.e[(size_t)mi];
                if (m.pp == KEY_HEAD) {
                    m.score = 10 * (int64_t)m.link - cov_coef * covp;
                } else {
                    Cell* pc = msa.find(m.pp);
                    if (pc) {
                        for (auto& n : pc->e) {
                            if (n.pp != m.ppp) continue;
                            int64_t cand =
                                n.score + 10 * (int64_t)m.link - cov_coef * covp;
                            if (cand > m.score) {
                                m.score = cand;
                                raiser = n.score;
                            }
                            if (read_type == RT_CLR || read_type == RT_HIFI) {
                                if (n.score > p_pp ||
                                    (n.score == p_pp && (m.pp & 7) != 4)) {
                                    c.best = (int32_t)mi;
                                    p_pp = n.score;
                                }
                            } else if (read_type == RT_ONT) {
                                int64_t ppp_d =
                                    m.ppp == KEY_HEAD ? 0 : (m.ppp >> 3) & ((1 << 17) - 1);
                                int64_t pp_d =
                                    m.pp == KEY_HEAD ? 0 : (m.pp >> 3) & ((1 << 17) - 1);
                                int64_t pp_b = m.pp == KEY_HEAD ? 0 : (m.pp & 7);
                                int64_t ppp_b = m.ppp == KEY_HEAD ? 0 : (m.ppp & 7);
                                bool cond1 =
                                    (ppp_d > 1 || pp_d > 0) &&
                                    ((double)m.link > (double)covp * 0.2 ||
                                     (int64_t)m.link > tmp / 2);
                                bool cond2 =
                                    (int64_t)m.link >
                                        (int64_t)c.e[(size_t)c.best].link / 2 &&
                                    n.score > p_pp &&
                                    (pp_b == 4 || pp_b == b || ppp_b == b ||
                                     pp_b == ppp_b);
                                if (cond1 || cond2) {
                                    c.best = (int32_t)mi;
                                    p_pp = n.score;
                                }
                            }
                        }
                    }
                }
                // common final rule
                int64_t pp_b = m.pp == KEY_HEAD ? 0 : (m.pp & 7);
                if (read_type == RT_RS) {
                    if (m.score >= c.e[(size_t)c.best].score) {
                        c.best = (int32_t)mi;
                        p_pp = raiser;
                    }
                } else {
                    if (m.score > c.e[(size_t)c.best].score ||
                        (m.score == c.e[(size_t)c.best].score && pp_b != 4)) {
                        c.best = (int32_t)mi;
                        p_pp = raiser;
                    }
                }
            }
            if (p == length - 1 &&
                c.e[(size_t)c.best].score >= global_best_score) {
                global_best_key = pack_key(p, db / 6, b);
                if (c.e[(size_t)c.best].score > global_best_score)
                    global_best_score = c.e[(size_t)c.best].score;
            }
        }
    }
    if (global_best_key < 0) {
        *out_pos = nullptr;
        *out_base = nullptr;
        *out_qv = nullptr;
        return 0;
    }

    // ---- traceback (emission order reversed at the end) ----
    static const char int_to_base[] = "ATGC-NM";
    std::vector<int32_t> rpos;
    std::vector<uint8_t> rbase;
    std::vector<int32_t> rqv;
    int64_t cur = global_best_key;
    while (true) {
        Cell* c = msa.find(cur);
        if (!c || c->e.empty()) break;
        Entry& e = c->e[(size_t)c->best];
        int64_t b = cur & 7, p = cur >> 20;
        if (b != 4) {
            int64_t cov = coverage[p] > 1 ? coverage[p] : 1;
            int64_t qv = 100 * (int64_t)e.link / cov;
            char ch = int_to_base[b];
            if (!(coverage[p] > min_cov && qv > lq_min_qv)) ch += 32;
            rpos.push_back((int32_t)p);
            rbase.push_back((uint8_t)ch);
            rqv.push_back((int32_t)qv);
        }
        if (e.pp == KEY_HEAD) break;
        cur = e.pp;
    }
    int64_t n = (int64_t)rpos.size();
    *out_pos = (int32_t*)malloc(sizeof(int32_t) * (size_t)(n ? n : 1));
    *out_base = (uint8_t*)malloc((size_t)(n ? n : 1));
    *out_qv = (int32_t*)malloc(sizeof(int32_t) * (size_t)(n ? n : 1));
    if (!*out_pos || !*out_base || !*out_qv) return -1;
    for (int64_t i = 0; i < n; i++) {
        (*out_pos)[i] = rpos[(size_t)(n - 1 - i)];
        (*out_base)[i] = rbase[(size_t)(n - 1 - i)];
        (*out_qv)[i] = rqv[(size_t)(n - 1 - i)];
    }
    return n;
}
