"""Partial-order alignment — exact mirror of lib/dag.c.

poa_to_consensus aligns each sequence to the growing DAG with a
Needleman-Wunsch over topologically-sorted nodes (score M/X/G = +1/-2/-2),
merges matched nodes via alignedto sets, re-toposorts with the C's exact
pseudo-node DFS, and extracts the heaviest path
(best_score + sum(edge labels) - 0.5*indegree).  All insertion orders and
tie rules follow the C so the output is byte-identical; graphs here are
tiny (<= 7 seqs x ~2000 bp from the LQ repair path).
"""
from __future__ import annotations

SCORE_MATCH = 1
SCORE_MISMATCH = -2
SCORE_GAP = -2
NEG = float("-inf")


class _Graph:
    def __init__(self):
        self.base = []  # per node
        self.inedge = []  # per node: list of edge ids
        self.outedge = []
        self.alignedto = []  # per node: list of node ids
        self.e_in = []  # per edge: innode
        self.e_out = []  # per edge: outnode
        self.e_label = []  # per edge: set of seq indices
        self.sorted_nodes = []

    def n(self):
        return len(self.base)

    def insert_node(self, base):
        self.base.append(base)
        self.inedge.append([])
        self.outedge.append([])
        self.alignedto.append([])
        return len(self.base) - 1

    def insert_edge(self, innode, outnode, label):
        self.e_in.append(innode)
        self.e_out.append(outnode)
        self.e_label.append({label})
        eid = len(self.e_in) - 1
        self.outedge[innode].append(eid)
        self.inedge[outnode].append(eid)
        return eid

    def insert_label_to_edge(self, innode, outnode, label):
        """Returns True when the edge did not exist (C not_existed)."""
        not_existed = True
        for eid in self.outedge[innode]:
            if self.e_out[eid] == outnode:
                self.e_label[eid].add(label)
                not_existed = False
        return not_existed


def _insert_unmatched_nodes(g, seq_index, seq, firstnode, headnode):
    for ch in seq:
        node_index = g.insert_node(ch)
        if firstnode == -1:
            firstnode = node_index
        else:
            g.insert_edge(headnode, node_index, seq_index)
        headnode = node_index
    return firstnode, headnode


def _score_init(x, y, g, sorted_nodes_index):
    """score_init (dag.c:88): first column from best predecessor chain."""
    s = [[(0, 0, 0)] * (y) for _ in range(x)]  # (score, bx, by)
    row0 = [(i * SCORE_GAP, 0, 0) for i in range(y)]
    s[0] = row0
    for i, node_index in enumerate(g.sorted_nodes):
        sorted_nodes_index[node_index] = i
        if not g.inedge[node_index]:
            bs = 0
        else:
            bs = s[sorted_nodes_index[g.e_in[g.inedge[node_index][0]]] + 1][0][0]
            for eid in g.inedge[node_index][1:]:
                s_ = s[sorted_nodes_index[g.e_in[eid]] + 1][0][0]
                if s_ > bs:
                    bs = s_
        s[i + 1][0] = (bs + SCORE_GAP, 0, 0)
    return s


def _update_score(s, y, seq, g, sorted_nodes_index):
    """align_seq_to_graph_updatescore (dag.c:244)."""
    for node_index in g.sorted_nodes:
        i = sorted_nodes_index[node_index]
        base = g.base[node_index]
        row = s[i + 1]
        for j in range(y):
            bests = s[i + 1][j][0] + SCORE_GAP
            bestx, besty = i + 1, j
            preds = g.inedge[node_index]
            if preds:
                for eid in preds:
                    pi = sorted_nodes_index[g.e_in[eid]]
                    b1 = s[pi + 1][j + 1][0] + SCORE_GAP
                    b2 = s[pi + 1][j][0] + (
                        SCORE_MATCH if seq[j] == base else SCORE_MISMATCH)
                    if b1 > bests and b1 >= b2:
                        bests, bestx, besty = b1, pi + 1, j + 1
                    elif b2 > bests and b2 >= b1:
                        bests, bestx, besty = b2, pi + 1, j
            else:
                b1 = s[0][j + 1][0] + SCORE_GAP
                b2 = s[0][j][0] + (
                    SCORE_MATCH if seq[j] == base else SCORE_MISMATCH)
                if b1 > bests and b1 >= b2:
                    bests, bestx, besty = b1, 0, j + 1
                elif b2 > bests and b2 >= b1:
                    bests, bestx, besty = b2, 0, j
            row[j + 1] = (bests, bestx, besty)


def _get_bestx(y, s, g):
    bestx = 0
    bests = 0
    found = False
    for i in range(g.n()):
        if not g.outedge[g.sorted_nodes[i]]:
            b = s[i + 1][y][0]
            if not found or b > bests:
                bestx = i + 1
                bests = b
                found = True
    return bestx


def _check_nodes_predecessors(g, i):
    cnt = len(g.inedge[i])
    for a in g.alignedto[i]:
        if cnt:
            break
        cnt += len(g.inedge[a])
    return cnt


def _toposort(g):
    """toposort (dag.c:469): pseudo-node (alignedto-group) DFS with the
    exact stack discipline; fills sorted_nodes from the end."""
    n = g.n()
    node_to_pn = [-1] * n
    pn_to_nodes = []
    for i in range(n):
        if node_to_pn[i] == -1:
            pnid = len(pn_to_nodes)
            pn_to_nodes.append(i)
            node_to_pn[i] = pnid
            for a in g.alignedto[i]:
                node_to_pn[a] = pnid
    cur_pnid = len(pn_to_nodes)
    completed = [-1] * cur_pnid
    g.sorted_nodes = [0] * n
    sorted_index = n - 1

    while sorted_index >= 0:
        found = -1
        for i in range(cur_pnid):
            if completed[i] == -1 and _check_nodes_predecessors(
                    g, pn_to_nodes[i]) == 0:
                found = i
                break
        assert found != -1
        started = [-1] * cur_pnid
        stack = [found]
        while stack:
            pnid = stack.pop()
            if completed[pnid] == 1:
                continue
            if started[pnid] != -1:
                completed[pnid] = 1
                g.sorted_nodes[sorted_index] = pn_to_nodes[pnid]
                sorted_index -= 1
                for a in g.alignedto[pn_to_nodes[pnid]]:
                    g.sorted_nodes[sorted_index] = a
                    sorted_index -= 1
                started[pnid] = -1
                continue
            started[pnid] = 1
            stack.append(pnid)
            for eid in g.outedge[pn_to_nodes[pnid]]:
                stack.append(node_to_pn[g.e_out[eid]])
            for a in g.alignedto[pn_to_nodes[pnid]]:
                for eid in g.outedge[a]:
                    stack.append(node_to_pn[g.e_out[eid]])


def _update_graph(y, seq_index, seq, g, mroutes, starty, endy):
    """align_seq_to_graph_updategraphy (dag.c:332)."""
    firstnode = headnode = tailnode = node_index = -1
    updated_node = updated_headnode = 1
    if starty > 0:
        firstnode, headnode = _insert_unmatched_nodes(
            g, seq_index, seq[:starty], firstnode, headnode)
    if endy < y - 1:
        # the C passes length y - endy, which includes seq's NUL
        # terminator as a trailing node (dag.c:339) — bug-compatible
        tailnode, node_index = _insert_unmatched_nodes(
            g, seq_index, seq[endy + 1 : y] + b"\x00", tailnode, node_index)
    for mx, my in mroutes:
        if my == -1:
            continue
        updated_node = 0
        base = seq[my]
        if mx == -1:
            node_index = g.insert_node(base)
            updated_node = node_index
        elif g.base[mx] == base:
            node_index = mx
        else:
            foundnode = -1
            for a in g.alignedto[mx]:
                if g.base[a] == base:
                    node_index = foundnode = a
            if foundnode == -1:
                node_index = g.insert_node(base)
                updated_node = node_index
                # insert_node_alignedto
                g.alignedto[node_index].append(mx)
                g.alignedto[node_index].extend(g.alignedto[mx])
                for a in g.alignedto[node_index]:
                    g.alignedto[a].append(node_index)
        if headnode != -1:
            if updated_node or updated_headnode:
                g.insert_edge(headnode, node_index, seq_index)
            else:
                if g.insert_label_to_edge(headnode, node_index, seq_index):
                    g.insert_edge(headnode, node_index, seq_index)
        headnode = node_index
        updated_headnode = updated_node
        if firstnode == -1:
            firstnode = headnode
    if tailnode != -1:
        g.insert_edge(headnode, tailnode, seq_index)


def _align_seq_to_graph(seq_index, seq, g):
    x = g.n()
    y = len(seq)
    sorted_nodes_index = [0] * x
    s = _score_init(x + 1, y + 1, g, sorted_nodes_index)
    _update_score(s, y, seq, g, sorted_nodes_index)
    bestx = _get_bestx(y, s, g)
    besty = y
    mroutes = []
    starty = endy = -1
    while bestx != 0 or besty != 0:
        _, nextx, nexty = s[bestx][besty]
        mx = g.sorted_nodes[bestx - 1] if nextx != bestx else -1
        my = -1
        if nexty != besty:
            my = besty - 1
            starty = my
            if endy == -1:
                endy = my
        mroutes.append((mx, my))
        bestx, besty = nextx, nexty
    mroutes.reverse()
    _update_graph(y, seq_index, seq, g, mroutes, starty, endy)
    _toposort(g)


def poa_to_consensus(seqs: list[bytes]) -> bytes:
    """poa_to_consensus (dag.c:658)."""
    g = _Graph()
    for seq_index, seq in enumerate(seqs):
        if seq_index == 0:
            _insert_unmatched_nodes(g, 0, seq, -1, -1)
            g.sorted_nodes = list(range(g.n()))
        else:
            _align_seq_to_graph(seq_index, seq, g)

    # get_consensus_from_graph (dag.c:555)
    best_score = {}
    best_pnode = {}
    global_best_node = -1
    global_best_score = -1.0
    bs_carry = -1.0
    for nodeid in g.sorted_nodes:
        bp = -1
        if g.inedge[nodeid]:
            for eid in g.inedge[nodeid]:
                innode = g.e_in[eid]
                score = (best_score[innode] + len(g.e_label[eid])
                         - 0.5 * len(g.inedge[nodeid]))
                if score > bs_carry or bp == -1:
                    bs_carry = score
                    bp = innode
        else:
            bs_carry = 0.0
            bp = -1
        best_score[nodeid] = bs_carry
        best_pnode[nodeid] = bp
        if bs_carry > global_best_score:
            global_best_score = bs_carry
            global_best_node = nodeid

    out = bytearray()
    node = global_best_node
    while node != -1:
        out.append(g.base[node])
        node = best_pnode[node]
    out.reverse()
    # C strlen semantics: a trailing NUL node ends the string
    nul = out.find(0)
    if nul >= 0:
        del out[nul:]
    return bytes(out)
