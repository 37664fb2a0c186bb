// Partial-order alignment — native port of models/cns/poadag.py (itself an
// exact mirror of lib/dag.c).  Same insertion orders, pseudo-node toposort
// and tie rules; byte-equality vs the Python implementation is enforced by
// tests/test_cns_native.py.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr long SCORE_MATCH = 1;
constexpr long SCORE_MISMATCH = -2;
constexpr long SCORE_GAP = -2;

struct Graph {
    std::vector<uint8_t> base;
    std::vector<std::vector<int32_t>> inedge, outedge;
    std::vector<std::vector<int32_t>> alignedto;
    std::vector<int32_t> e_in, e_out;
    std::vector<std::vector<uint8_t>> e_label;  // small seq-index lists
    std::vector<int32_t> sorted_nodes;

    int32_t n() const { return (int32_t)base.size(); }

    int32_t insert_node(uint8_t b) {
        base.push_back(b);
        inedge.emplace_back();
        outedge.emplace_back();
        alignedto.emplace_back();
        return (int32_t)base.size() - 1;
    }
    void insert_edge(int32_t in, int32_t out, uint8_t label) {
        e_in.push_back(in);
        e_out.push_back(out);
        e_label.emplace_back(1, label);
        int32_t eid = (int32_t)e_in.size() - 1;
        outedge[in].push_back(eid);
        inedge[out].push_back(eid);
    }
    bool insert_label_to_edge(int32_t in, int32_t out, uint8_t label) {
        bool not_existed = true;
        for (int32_t eid : outedge[in]) {
            if (e_out[eid] == out) {
                bool has = false;
                for (uint8_t l : e_label[eid])
                    if (l == label) { has = true; break; }
                if (!has) e_label[eid].push_back(label);
                not_existed = false;
            }
        }
        return not_existed;
    }
};

void insert_unmatched_nodes(Graph& g, uint8_t seq_index, const uint8_t* seq,
                            int64_t len, int32_t& firstnode,
                            int32_t& headnode) {
    for (int64_t i = 0; i < len; i++) {
        int32_t ni = g.insert_node(seq[i]);
        if (firstnode == -1)
            firstnode = ni;
        else
            g.insert_edge(headnode, ni, seq_index);
        headnode = ni;
    }
}

int32_t check_nodes_predecessors(const Graph& g, int32_t i) {
    int32_t cnt = (int32_t)g.inedge[i].size();
    for (int32_t a : g.alignedto[i]) {
        if (cnt) break;
        cnt += (int32_t)g.inedge[a].size();
    }
    return cnt;
}

void toposort(Graph& g) {
    int32_t n = g.n();
    std::vector<int32_t> node_to_pn(n, -1);
    std::vector<int32_t> pn_to_nodes;
    for (int32_t i = 0; i < n; i++) {
        if (node_to_pn[i] == -1) {
            int32_t pnid = (int32_t)pn_to_nodes.size();
            pn_to_nodes.push_back(i);
            node_to_pn[i] = pnid;
            for (int32_t a : g.alignedto[i]) node_to_pn[a] = pnid;
        }
    }
    int32_t cur_pnid = (int32_t)pn_to_nodes.size();
    std::vector<int8_t> completed(cur_pnid, -1);
    g.sorted_nodes.assign(n, 0);
    int64_t sorted_index = n - 1;
    while (sorted_index >= 0) {
        int32_t found = -1;
        for (int32_t i = 0; i < cur_pnid; i++) {
            if (completed[i] == -1 &&
                check_nodes_predecessors(g, pn_to_nodes[i]) == 0) {
                found = i;
                break;
            }
        }
        if (found == -1) abort();
        std::vector<int8_t> started(cur_pnid, -1);
        std::vector<int32_t> stack{found};
        while (!stack.empty()) {
            int32_t pnid = stack.back();
            stack.pop_back();
            if (completed[pnid] == 1) continue;
            if (started[pnid] != -1) {
                completed[pnid] = 1;
                g.sorted_nodes[sorted_index--] = pn_to_nodes[pnid];
                for (int32_t a : g.alignedto[pn_to_nodes[pnid]])
                    g.sorted_nodes[sorted_index--] = a;
                started[pnid] = -1;
                continue;
            }
            started[pnid] = 1;
            stack.push_back(pnid);
            for (int32_t eid : g.outedge[pn_to_nodes[pnid]])
                stack.push_back(node_to_pn[g.e_out[eid]]);
            for (int32_t a : g.alignedto[pn_to_nodes[pnid]])
                for (int32_t eid : g.outedge[a])
                    stack.push_back(node_to_pn[g.e_out[eid]]);
        }
    }
}

struct SCell {
    long s;
    int32_t x, y;
};

void align_seq_to_graph(uint8_t seq_index, const uint8_t* seq, int64_t y_len,
                        Graph& g) {
    int64_t x = g.n();
    int64_t y = y_len;
    std::vector<int32_t> sorted_nodes_index((size_t)x, 0);
    // score matrix (x+1) x (y+1)
    std::vector<SCell> s((size_t)((x + 1) * (y + 1)), SCell{0, 0, 0});
    auto S = [&](int64_t i, int64_t j) -> SCell& {
        return s[(size_t)(i * (y + 1) + j)];
    };
    for (int64_t i = 0; i < y + 1; i++) S(0, i).s = i * SCORE_GAP;
    for (int64_t i = 0; i < x; i++) {
        int32_t node_index = g.sorted_nodes[(size_t)i];
        sorted_nodes_index[node_index] = (int32_t)i;
        long bs;
        if (g.inedge[node_index].empty()) {
            bs = 0;
        } else {
            bs = S(sorted_nodes_index[g.e_in[g.inedge[node_index][0]]] + 1, 0).s;
            for (size_t k = 1; k < g.inedge[node_index].size(); k++) {
                long s_ = S(sorted_nodes_index[g.e_in[g.inedge[node_index][k]]] + 1, 0).s;
                if (s_ > bs) bs = s_;
            }
        }
        S(i + 1, 0).s = bs + SCORE_GAP;
    }

    // update score
    for (int64_t si = 0; si < x; si++) {
        int32_t node_index = g.sorted_nodes[(size_t)si];
        int64_t i = sorted_nodes_index[node_index];
        uint8_t base = g.base[node_index];
        for (int64_t j = 0; j < y; j++) {
            long bests = S(i + 1, j).s + SCORE_GAP;
            int32_t bestx = (int32_t)(i + 1), besty = (int32_t)j;
            if (!g.inedge[node_index].empty()) {
                for (int32_t eid : g.inedge[node_index]) {
                    int64_t pi = sorted_nodes_index[g.e_in[eid]];
                    long b1 = S(pi + 1, j + 1).s + SCORE_GAP;
                    long b2 = S(pi + 1, j).s +
                              (seq[j] == base ? SCORE_MATCH : SCORE_MISMATCH);
                    if (b1 > bests && b1 >= b2) {
                        bests = b1;
                        bestx = (int32_t)(pi + 1);
                        besty = (int32_t)(j + 1);
                    } else if (b2 > bests && b2 >= b1) {
                        bests = b2;
                        bestx = (int32_t)(pi + 1);
                        besty = (int32_t)j;
                    }
                }
            } else {
                long b1 = S(0, j + 1).s + SCORE_GAP;
                long b2 = S(0, j).s +
                          (seq[j] == base ? SCORE_MATCH : SCORE_MISMATCH);
                if (b1 > bests && b1 >= b2) {
                    bests = b1;
                    bestx = 0;
                    besty = (int32_t)(j + 1);
                } else if (b2 > bests && b2 >= b1) {
                    bests = b2;
                    bestx = 0;
                    besty = (int32_t)j;
                }
            }
            S(i + 1, j + 1) = SCell{bests, bestx, besty};
        }
    }

    // best end node (outdegree 0)
    int32_t bestx = 0;
    long bests = 0;
    bool found = false;
    for (int64_t i = 0; i < x; i++) {
        if (g.outedge[g.sorted_nodes[(size_t)i]].empty()) {
            long b = S(i + 1, y).s;
            if (!found || b > bests) {
                bestx = (int32_t)(i + 1);
                bests = b;
                found = true;
            }
        }
    }
    int32_t besty = (int32_t)y;

    // match route
    std::vector<std::pair<int32_t, int32_t>> mroutes;
    int64_t starty = -1, endy = -1;
    while (bestx != 0 || besty != 0) {
        SCell& c = S(bestx, besty);
        int32_t mx = c.x != bestx ? g.sorted_nodes[(size_t)(bestx - 1)] : -1;
        int32_t my = -1;
        if (c.y != besty) {
            my = besty - 1;
            starty = my;
            if (endy == -1) endy = my;
        }
        mroutes.emplace_back(mx, my);
        bestx = c.x;
        besty = c.y;
    }
    std::reverse(mroutes.begin(), mroutes.end());

    // update graph
    int32_t firstnode = -1, headnode = -1, tailnode = -1, node_index = -1;
    int32_t updated_node = 1, updated_headnode = 1;
    if (starty > 0)
        insert_unmatched_nodes(g, seq_index, seq, starty, firstnode, headnode);
    if (endy < y - 1) {
        // bug-compatible: includes the NUL terminator as a trailing node
        std::vector<uint8_t> tail(seq + endy + 1, seq + y);
        tail.push_back(0);
        insert_unmatched_nodes(g, seq_index, tail.data(),
                               (int64_t)tail.size(), tailnode, node_index);
    }
    for (auto& [mx, my] : mroutes) {
        if (my == -1) continue;
        updated_node = 0;
        uint8_t base = seq[my];
        if (mx == -1) {
            node_index = g.insert_node(base);
            updated_node = node_index;
        } else if (g.base[mx] == base) {
            node_index = mx;
        } else {
            int32_t foundnode = -1;
            for (int32_t a : g.alignedto[mx])
                if (g.base[a] == base) node_index = foundnode = a;
            if (foundnode == -1) {
                node_index = g.insert_node(base);
                updated_node = node_index;
                g.alignedto[node_index].push_back(mx);
                for (int32_t a : g.alignedto[mx])
                    g.alignedto[node_index].push_back(a);
                for (int32_t a : g.alignedto[node_index])
                    g.alignedto[a].push_back(node_index);
            }
        }
        if (headnode != -1) {
            if (updated_node || updated_headnode) {
                g.insert_edge(headnode, node_index, seq_index);
            } else if (g.insert_label_to_edge(headnode, node_index,
                                              seq_index)) {
                g.insert_edge(headnode, node_index, seq_index);
            }
        }
        headnode = node_index;
        updated_headnode = updated_node;
        if (firstnode == -1) firstnode = headnode;
    }
    if (tailnode != -1) g.insert_edge(headnode, tailnode, seq_index);
    toposort(g);
}

}  // namespace

extern "C" void npt_cns_free(void* p);

// seqs: concatenated bytes; offs: n+1 offsets.  Returns consensus length,
// output malloc'd into *out (free with npt_cns_free), or -1.
extern "C" int64_t npt_poa_consensus(const uint8_t* seqs, const int64_t* offs,
                                     int64_t n_seqs, uint8_t** out) {
    Graph g;
    for (int64_t i = 0; i < n_seqs; i++) {
        const uint8_t* s = seqs + offs[i];
        int64_t len = offs[i + 1] - offs[i];
        if (i == 0) {
            int32_t fn = -1, hn = -1;
            insert_unmatched_nodes(g, 0, s, len, fn, hn);
            g.sorted_nodes.resize((size_t)g.n());
            for (int32_t k = 0; k < g.n(); k++) g.sorted_nodes[k] = k;
        } else {
            align_seq_to_graph((uint8_t)i, s, len, g);
        }
    }
    // heaviest path
    int32_t n = g.n();
    std::vector<double> best_score((size_t)n, 0.0);
    std::vector<int32_t> best_pnode((size_t)n, -1);
    int32_t global_best_node = -1;
    double global_best_score = -1.0;
    double bs_carry = -1.0;
    for (int32_t idx = 0; idx < n; idx++) {
        int32_t nodeid = g.sorted_nodes[(size_t)idx];
        int32_t bp = -1;
        if (!g.inedge[nodeid].empty()) {
            for (int32_t eid : g.inedge[nodeid]) {
                int32_t innode = g.e_in[eid];
                double score = best_score[innode] +
                               (double)g.e_label[eid].size() -
                               0.5 * (double)g.inedge[nodeid].size();
                if (score > bs_carry || bp == -1) {
                    bs_carry = score;
                    bp = innode;
                }
            }
        } else {
            bs_carry = 0.0;
            bp = -1;
        }
        best_score[nodeid] = bs_carry;
        best_pnode[nodeid] = bp;
        if (bs_carry > global_best_score) {
            global_best_score = bs_carry;
            global_best_node = nodeid;
        }
    }
    std::vector<uint8_t> rev;
    int32_t node = global_best_node;
    while (node != -1) {
        rev.push_back(g.base[node]);
        node = best_pnode[node];
    }
    int64_t m = (int64_t)rev.size();
    *out = (uint8_t*)malloc((size_t)(m ? m : 1));
    if (!*out) return -1;
    for (int64_t i = 0; i < m; i++) (*out)[i] = rev[(size_t)(m - 1 - i)];
    // C strlen semantics: a NUL tail node ends the string
    for (int64_t i = 0; i < m; i++)
        if ((*out)[i] == 0) return i;
    return m;
}
