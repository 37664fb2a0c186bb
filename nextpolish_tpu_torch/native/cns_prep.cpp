// Device-path preparation for the consensus engine: flat alignment columns
// -> EdgeTable (msa.py build_edges semantics) + packed DenseWindow arrays
// (device_dp.py densify_window semantics) in one native pass.
//
// The reference builds the same second-order link structure in update_msa
// (lib/ctg_cns.c:324-365); here it feeds the TPU level-scan instead of a
// host DP.  Both numpy implementations stay as the oracle this pass is
// tested against (tests/test_cns_native.py).
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

// NPT_PREP_PROF=1 prints per-phase wall times to stderr (perf triage on
// the host-bound device path; see docs/ROADMAP.md engine-2 item)
namespace {
struct PhaseProf {
  bool on;
  std::chrono::steady_clock::time_point t0;
  PhaseProf() : on(getenv("NPT_PREP_PROF") != nullptr) { reset(); }
  void reset() { t0 = std::chrono::steady_clock::now(); }
  void lap(const char* name) {
    if (!on) return;
    auto t1 = std::chrono::steady_clock::now();
    fprintf(stderr, "npt_cns_prepare %-12s %7.2f ms\n", name,
            std::chrono::duration<double, std::milli>(t1 - t0).count());
    t0 = t1;
  }
};
}  // namespace

namespace {

constexpr int64_t KEY_HEAD = -1;
constexpr int GAP = 4;

constexpr int F_VALID = 1;
constexpr int F_HEAD = 2;
constexpr int F_COND1A = 4;
constexpr int F_COND2B = 8;
constexpr int F_PPB_NOT_GAP = 16;

inline int64_t pack_key(int64_t p, int64_t d, int64_t b) {
    return (p << 20) | (d << 3) | b;
}

struct Entry {
    int64_t pp, ppp;
    int64_t ins;  // first-occurrence column index (SeqList insertion order)
    int32_t link;
    int32_t rank;  // EdgeTable (pp, ppp)-sort position, cached by pass 1
};

struct Cell {
    std::vector<Entry> e;
};

struct Msa {
    std::vector<std::vector<Cell>> pos;  // per position, cells d*6+b
    explicit Msa(int64_t length) : pos((size_t)length) {}
    Cell& at(int64_t p, int64_t d, int64_t b) {
        auto& v = pos[(size_t)p];
        size_t need = (size_t)(d * 6 + b + 1);
        if (v.size() < need) v.resize((size_t)((d + 1) * 6));
        return v[(size_t)(d * 6 + b)];
    }
    Cell* find(int64_t key) {
        int64_t b = key & 7, d = (key >> 3) & ((1 << 17) - 1), p = key >> 20;
        if (p < 0 || (size_t)p >= pos.size()) return nullptr;
        auto& v = pos[(size_t)p];
        size_t idx = (size_t)(d * 6 + b);
        if (idx >= v.size()) return nullptr;
        return &v[idx];
    }
};

}  // namespace

extern "C" {

// All output arrays are malloc'd; free each with npt_cns_free.  The dense
// block is emitted only when *e_cap / *vb_cap / the int32 score guard all
// hold (dense_ok=1); the EdgeTable block is always emitted.
struct NptCnsPrep {
    // EdgeTable (sorted by (cur, pp, ppp); tags sorted by cur)
    int64_t n_entries, n_tags;
    int64_t *cur, *pp, *ppp, *ins, *tag_key, *tag_off;  // tag_off[n_tags+1]
    int32_t* link;
    // DenseWindow (entry-major, tag-major insertion-slot order)
    int32_t dense_ok, E, Vb;
    int64_t n_levels;
    int64_t *ent_lvl, *eorder;
    int8_t *ent_b, *ent_slot;
    uint8_t* ent_same;
    int32_t *ent_A, *ent_M, *meta, *level_pos;
};

void npt_cns_prep_free(NptCnsPrep* p) {
    if (!p) return;
    free(p->cur); free(p->pp); free(p->ppp); free(p->ins);
    free(p->tag_key); free(p->tag_off); free(p->link);
    free(p->ent_lvl); free(p->eorder); free(p->ent_b); free(p->ent_slot);
    free(p->ent_same); free(p->ent_A); free(p->ent_M); free(p->meta);
    free(p->level_pos);
    free(p);
}

NptCnsPrep* npt_cns_prepare(
    const int32_t* t_pos, const int16_t* delta_, const uint8_t* q_base,
    const int64_t* row_off, int64_t n_rows, const int32_t* coverage,
    int64_t length, int max_e, int max_vb) {
    if (length <= 0 || n_rows <= 0) return nullptr;
    PhaseProf prof;
    Msa msa(length);

    // ---- update_msa with first-occurrence order ----
    // Threaded over position ranges: every thread walks every row (the
    // rolling pp/ppp state is cheap) but only touches cells in its own
    // range, so per-cell entry lists — and their insertion order — are
    // identical to the serial walk.
    {
        int T = (int)std::thread::hardware_concurrency();
        if (T < 1) T = 1;
        if (T > 4) T = 4;
        const int64_t total_cols = row_off[n_rows];
        if (total_cols < 200000) T = 1;
        auto build = [&](int64_t p_lo, int64_t p_hi) {
            for (int64_t r = 0; r < n_rows; r++) {
                int64_t pp = KEY_HEAD, ppp = KEY_HEAD;
                for (int64_t i = row_off[r]; i < row_off[r + 1]; i++) {
                    const int64_t tp = t_pos[i];
                    if (tp >= p_lo && tp < p_hi) {
                        Cell& c = msa.at(tp, delta_[i], q_base[i]);
                        bool updated = false;
                        for (auto& e : c.e) {
                            if (e.pp == pp && e.ppp == ppp) {
                                e.link++;
                                updated = true;
                                break;
                            }
                        }
                        if (!updated) c.e.push_back(Entry{pp, ppp, i, 1});
                    }
                    ppp = pp;
                    pp = pack_key(tp, delta_[i], q_base[i]);
                }
            }
        };
        if (T == 1) {
            build(0, length);
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < T; t++) {
                const int64_t lo = length * t / T;
                const int64_t hi = length * (t + 1) / T;
                if (t == T - 1) build(lo, hi);
                else ths.emplace_back(build, lo, hi);
            }
            for (auto& th : ths) th.join();
        }
    }

    prof.lap("update_msa");
    // ---- enumerate tags in key order; count sizes + per-position
    // prefixes (the prefixes let passes 1/2 run position-parallel with
    // every output landing at its exact serial-order offset) ----
    int64_t n_tags = 0, n_entries = 0, n_levels = 0;
    int E = 1;
    std::vector<int64_t> tag_pre((size_t)length + 1, 0);
    std::vector<int64_t> ent_pre((size_t)length + 1, 0);
    std::vector<int64_t> lvl_pre((size_t)length + 1, 0);
    for (int64_t p = 0; p < length; p++) {
        auto& cells = msa.pos[(size_t)p];
        const int64_t nc = (int64_t)cells.size();
        int64_t last_d = -1;
        tag_pre[(size_t)p] = n_tags;
        ent_pre[(size_t)p] = n_entries;
        lvl_pre[(size_t)p] = n_levels;
        for (int64_t d = 0; d * 6 < nc; d++) {
            for (int64_t b = 0; b < 6 && d * 6 + b < nc; b++) {
                Cell& c = cells[(size_t)(d * 6 + b)];
                if (c.e.empty()) continue;
                n_tags++;
                n_entries += (int64_t)c.e.size();
                if ((int64_t)c.e.size() > E) E = (int64_t)c.e.size();
                if (d != last_d) { n_levels++; last_d = d; }
            }
        }
    }
    tag_pre[(size_t)length] = n_tags;
    ent_pre[(size_t)length] = n_entries;
    lvl_pre[(size_t)length] = n_levels;
    if (!n_tags) return nullptr;
    prof.lap("count");

    NptCnsPrep* out = (NptCnsPrep*)calloc(1, sizeof(NptCnsPrep));
    if (!out) return nullptr;
    out->n_entries = n_entries;
    out->n_tags = n_tags;
    out->cur = (int64_t*)malloc(8 * (size_t)n_entries);
    out->pp = (int64_t*)malloc(8 * (size_t)n_entries);
    out->ppp = (int64_t*)malloc(8 * (size_t)n_entries);
    out->ins = (int64_t*)malloc(8 * (size_t)n_entries);
    out->link = (int32_t*)malloc(4 * (size_t)n_entries);
    out->tag_key = (int64_t*)malloc(8 * (size_t)n_tags);
    out->tag_off = (int64_t*)malloc(8 * (size_t)(n_tags + 1));
    if (!out->cur || !out->pp || !out->ppp || !out->ins || !out->link ||
        !out->tag_key || !out->tag_off) {
        npt_cns_prep_free(out);
        return nullptr;
    }

    // level bookkeeping (needed for the dense block and the score guard)
    std::vector<int32_t> lvl_pos((size_t)n_levels);
    std::vector<int32_t> lvl_d((size_t)n_levels);
    std::vector<uint8_t> lvl_ref;  // referenced by a next-position d0 pp
    std::vector<int64_t> lvl_maxlink((size_t)n_levels, 0);
    // level index by key for vslot/pp lookups: per position, map d -> level
    // (store level of (p, d) in a per-position small vector)
    std::vector<std::vector<int32_t>> lvl_of(length);

    // ---- pass 1: EdgeTable emission + level enumeration ----
    // Position-parallel: the count prefixes give every thread the exact
    // serial-order output offsets for its range, so the emitted arrays
    // are byte-identical to the serial walk.  The (pp, ppp) sort rank is
    // cached into each Entry for pass 2.
    auto pass1 = [&](int64_t p_lo, int64_t p_hi) {
        int64_t ei = ent_pre[(size_t)p_lo], ti = tag_pre[(size_t)p_lo];
        int64_t li = lvl_pre[(size_t)p_lo];
        std::vector<int> order;  // sort scratch for one cell's entries
        for (int64_t p = p_lo; p < p_hi; p++) {
            auto& cells = msa.pos[(size_t)p];
            const int64_t nc = (int64_t)cells.size();
            int64_t last_d = -1;
            for (int64_t d = 0; d * 6 < nc; d++) {
                for (int64_t b = 0; b < 6 && d * 6 + b < nc; b++) {
                    Cell& c = cells[(size_t)(d * 6 + b)];
                    if (c.e.empty()) continue;
                    if (d != last_d) {
                        last_d = d;
                        while ((int64_t)lvl_of[(size_t)p].size() <= d)
                            lvl_of[(size_t)p].push_back(-1);
                        lvl_of[(size_t)p][(size_t)d] = (int32_t)li;
                        lvl_pos[(size_t)li] = (int32_t)p;
                        lvl_d[(size_t)li] = (int32_t)d;
                        li++;
                    }
                    const int64_t key = pack_key(p, d, b);
                    out->tag_key[ti] = key;
                    out->tag_off[ti] = ei;
                    ti++;
                    // entries sorted by (pp, ppp) — EdgeTable order
                    const int k = (int)c.e.size();
                    order.resize(k);
                    for (int j = 0; j < k; j++) order[j] = j;
                    std::sort(order.begin(), order.end(),
                              [&](int x, int y) {
                        if (c.e[x].pp != c.e[y].pp)
                            return c.e[x].pp < c.e[y].pp;
                        return c.e[x].ppp < c.e[y].ppp;
                    });
                    int64_t& ml = lvl_maxlink[(size_t)(li - 1)];
                    for (int j = 0; j < k; j++) {
                        Entry& e = c.e[(size_t)order[j]];
                        e.rank = j;
                        out->cur[ei] = key;
                        out->pp[ei] = e.pp;
                        out->ppp[ei] = e.ppp;
                        out->ins[ei] = e.ins;
                        out->link[ei] = e.link;
                        if (e.link > ml) ml = e.link;
                        ei++;
                    }
                }
            }
        }
    };
    {
        int T = (int)std::thread::hardware_concurrency();
        if (T < 1) T = 1;
        if (T > 4) T = 4;
        if (n_entries < 20000) T = 1;
        if (T == 1) {
            pass1(0, length);
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < T; t++) {
                const int64_t lo = length * t / T;
                const int64_t hi = length * (t + 1) / T;
                if (t == T - 1) pass1(lo, hi);
                else ths.emplace_back(pass1, lo, hi);
            }
            for (auto& th : ths) th.join();
        }
    }
    out->tag_off[n_tags] = n_entries;
    prof.lap("pass1_edges");
    const int64_t Lt = (int64_t)lvl_pos.size();
    out->n_levels = Lt;

    // ---- dense-cap + int32-score-guard checks -------------------------
    bool dense = E <= max_e;
    if (dense) {
        int64_t inc_sum = 0, link_max = 0;
        for (int64_t l = 0; l < Lt; l++) {
            const int64_t inc = 10 * lvl_maxlink[(size_t)l]
                                - 3 * (int64_t)coverage[lvl_pos[(size_t)l]];
            if (inc > 0) inc_sum += inc;
            if (lvl_maxlink[(size_t)l] > link_max)
                link_max = lvl_maxlink[(size_t)l];
        }
        if (inc_sum >= (int64_t)1 << 30 || link_max >= 1 << 15)
            dense = false;
    }

    // ---- boundary ring slots ------------------------------------------
    std::vector<int32_t> vslot;
    int Vb = 1;
    if (dense) {
        lvl_ref.assign((size_t)Lt, 0);
        // a d0 entry's pp is the read's last column at p-1 (any level)
        for (int64_t t = 0; t < n_tags; t++) {
            const int64_t key = out->tag_key[t];
            if ((key >> 3) & ((1 << 17) - 1)) continue;  // d != 0
            for (int64_t j = out->tag_off[t]; j < out->tag_off[t + 1]; j++) {
                const int64_t ppk = out->pp[j];
                if (ppk == KEY_HEAD) continue;
                const int64_t pd = (ppk >> 3) & ((1 << 17) - 1);
                const int64_t ppos = ppk >> 20;
                if (ppos >= 0 && ppos < (int64_t)lvl_of.size() &&
                    pd < (int64_t)lvl_of[(size_t)ppos].size()) {
                    const int32_t lv = lvl_of[(size_t)ppos][(size_t)pd];
                    if (lv >= 0) lvl_ref[(size_t)lv] = 1;
                }
            }
        }
        // slots per position in ascending-level order (matches the numpy
        // np.unique + per-group arange assignment)
        vslot.assign((size_t)Lt, -1);
        int32_t cur_pos = -1, ctr = 0;
        for (int64_t l = 0; l < Lt; l++) {
            if (lvl_pos[(size_t)l] != cur_pos) {
                cur_pos = lvl_pos[(size_t)l];
                ctr = 0;
            }
            if (lvl_ref[(size_t)l]) vslot[(size_t)l] = ctr++;
            if (ctr > max_vb) { dense = false; break; }
        }
        if (dense) {
            for (int64_t l = 0; l < Lt; l++)
                if (vslot[(size_t)l] + 1 > Vb) Vb = vslot[(size_t)l] + 1;
        }
    }
    prof.lap("vslot");
    out->E = E;
    out->Vb = Vb;
    out->dense_ok = dense ? 1 : 0;
    if (!dense) return out;

    // ---- dense entry-major arrays (tag-major, insertion-slot order) ----
    out->ent_lvl = (int64_t*)malloc(8 * (size_t)n_entries);
    out->eorder = (int64_t*)malloc(8 * (size_t)n_entries);
    out->ent_b = (int8_t*)malloc((size_t)n_entries);
    out->ent_slot = (int8_t*)malloc((size_t)n_entries);
    out->ent_same = (uint8_t*)malloc((size_t)n_entries);
    out->ent_A = (int32_t*)malloc(4 * (size_t)n_entries);
    out->ent_M = (int32_t*)malloc(4 * (size_t)n_entries);
    out->meta = (int32_t*)malloc(4 * (size_t)Lt);
    out->level_pos = (int32_t*)malloc(4 * (size_t)Lt);
    if (!out->ent_lvl || !out->eorder || !out->ent_b || !out->ent_slot ||
        !out->ent_same || !out->ent_A || !out->ent_M || !out->meta ||
        !out->level_pos) {
        npt_cns_prep_free(out);
        return nullptr;
    }
    for (int64_t l = 0; l < Lt; l++) {
        out->level_pos[l] = lvl_pos[(size_t)l];
        const int32_t vs = vslot[(size_t)l];
        const int32_t d0 = lvl_d[(size_t)l] == 0 ? 1 : 0;
        out->meta[l] = ((int32_t)coverage[lvl_pos[(size_t)l]] << 8) |
                       ((vs + 1) << 2) | (d0 << 1);
    }

    // per-entry dense fields: walk tags again; insertion order within a
    // cell is the Msa entry order, and the EdgeTable rank of insertion
    // slot s is its (pp, ppp)-sort position, cached by pass 1.
    // Position-parallel via the same count prefixes (reads of lvl_of /
    // vslot / other cells' entries are all read-only here).
    auto pass2 = [&](int64_t p_lo, int64_t p_hi) {
    int64_t di = ent_pre[(size_t)p_lo];
    for (int64_t p = p_lo, t = tag_pre[(size_t)p_lo]; p < p_hi; p++) {
        auto& cells = msa.pos[(size_t)p];
        const int64_t nc = (int64_t)cells.size();
        for (int64_t d = 0; d * 6 < nc; d++) {
            const int32_t lv = (d < (int64_t)lvl_of[(size_t)p].size())
                                   ? lvl_of[(size_t)p][(size_t)d]
                                   : -1;
            for (int64_t b = 0; b < 6 && d * 6 + b < nc; b++) {
                Cell& c = cells[(size_t)(d * 6 + b)];
                if (c.e.empty()) continue;
                const int k = (int)c.e.size();
                const int64_t base = out->tag_off[t];
                const bool is_d0 = d == 0;
                for (int s = 0; s < k; s++) {  // insertion slot order
                    const Entry& m = c.e[(size_t)s];
                    const bool head = m.pp == KEY_HEAD;
                    const int64_t ppd =
                        head ? 0 : (m.pp >> 3) & ((1 << 17) - 1);
                    const int64_t ppb = head ? 0 : (m.pp & 7);
                    const bool hppp = m.ppp == KEY_HEAD;
                    const int64_t pppd =
                        hppp ? 0 : (m.ppp >> 3) & ((1 << 17) - 1);
                    const int64_t pppb = hppp ? 0 : (m.ppp & 7);
                    int flags = F_VALID;
                    if (head) flags |= F_HEAD;
                    if (pppd > 1 || ppd > 0) flags |= F_COND1A;
                    if (ppb == GAP || ppb == b || pppb == b || ppb == pppb)
                        flags |= F_COND2B;
                    if (ppb != GAP) flags |= F_PPB_NOT_GAP;
                    // pp_idx: boundary-ring slot for d0, prev level else
                    int32_t pp_idx = 0;
                    if (!head) {
                        if (is_d0) {
                            const int64_t ppos = m.pp >> 20;
                            const int64_t pd =
                                (m.pp >> 3) & ((1 << 17) - 1);
                            int32_t vs = 0;
                            if (ppos >= 0 &&
                                ppos < (int64_t)lvl_of.size() &&
                                pd < (int64_t)lvl_of[(size_t)ppos].size()) {
                                const int32_t plv =
                                    lvl_of[(size_t)ppos][(size_t)pd];
                                if (plv >= 0 && vslot[(size_t)plv] > 0)
                                    vs = vslot[(size_t)plv];
                            }
                            pp_idx = vs * 6 + (int32_t)ppb;
                        } else {
                            pp_idx = Vb * 6 + (int32_t)ppb;
                        }
                    }
                    // match bits over the pred cell's insertion slots
                    int32_t mbits = 0;
                    if (!head) {
                        Cell* pc = msa.find(m.pp);
                        if (pc) {
                            const int pk = (int)pc->e.size();
                            for (int n = 0; n < pk && n < 32; n++)
                                if (pc->e[(size_t)n].pp == m.ppp)
                                    mbits |= 1 << n;
                        }
                    }
                    out->ent_lvl[di] = lv;
                    out->ent_b[di] = (int8_t)b;
                    out->ent_slot[di] = (int8_t)s;
                    out->ent_A[di] = ((int32_t)m.link << 16) |
                                     (pp_idx << 8) | flags;
                    out->ent_M[di] = mbits;
                    out->ent_same[di] = (!is_d0 && !head) ? 1 : 0;
                    out->eorder[di] = base + m.rank;
                    di++;
                }
                t++;
            }
        }
    }
    };
    {
        int T = (int)std::thread::hardware_concurrency();
        if (T < 1) T = 1;
        if (T > 4) T = 4;
        if (n_entries < 20000) T = 1;
        if (T == 1) {
            pass2(0, length);
        } else {
            std::vector<std::thread> ths;
            for (int t = 0; t < T; t++) {
                const int64_t lo = length * t / T;
                const int64_t hi = length * (t + 1) / T;
                if (t == T - 1) pass2(lo, hi);
                else ths.emplace_back(pass2, lo, hi);
            }
            for (auto& th : ths) th.join();
        }
    }
    prof.lap("pass2_dense");
    return out;
}

}  // extern "C"
