"""Partial-order alignment consensus (lib/dag.c re-implemented).

Progressive POA: each sequence is Needleman-Wunsch-aligned against the
growing DAG (align_seq_to_graph_nw, dag.c:510-533; scores M/X/G = +1/-2/-2,
dag.c:18-20), matches merge into existing nodes or their `alignedto`
companions (:345-401), and the consensus is the heaviest path with score
best_pred + edge_label_count - 0.5*indegree (:555-595).

The per-node NW row is vectorized over the sequence axis; the in-row
insertion recurrence is a cummax with linear decay (insertion wins ties,
matching the C's candidate ordering).
"""
from __future__ import annotations

import numpy as np

MATCH, MISMATCH, GAPS = 1, -2, -2


class _Graph:
    def __init__(self):
        self.base: list[int] = []
        self.inedge: list[list[int]] = []
        self.outedge: list[list[int]] = []
        self.alignedto: list[list[int]] = []
        self.e_in: list[int] = []
        self.e_out: list[int] = []
        self.e_labels: list[set] = []
        self.sorted_nodes: list[int] = []

    def n(self) -> int:
        return len(self.base)

    def add_node(self, base: int) -> int:
        self.base.append(base)
        self.inedge.append([])
        self.outedge.append([])
        self.alignedto.append([])
        return len(self.base) - 1

    def add_edge(self, a: int, b: int, label: int) -> int:
        self.e_in.append(a)
        self.e_out.append(b)
        self.e_labels.append({label})
        ei = len(self.e_in) - 1
        self.outedge[a].append(ei)
        self.inedge[b].append(ei)
        return ei

    def label_edge(self, a: int, b: int, label: int) -> bool:
        for ei in self.outedge[a]:
            if self.e_out[ei] == b:
                self.e_labels[ei].add(label)
                return True
        return False

    def add_chain(self, seq: bytes, label: int, head: int = -1):
        first = -1
        for ch in seq:
            ni = self.add_node(ch)
            if head >= 0:
                self.add_edge(head, ni, label)
            if first < 0:
                first = ni
            head = ni
        return first, head

    def toposort(self):
        """Topological order treating alignedto groups as one pseudo-node
        (dag.c toposort :469-508)."""
        n = self.n()
        node_to_pn = [-1] * n
        pn_to_node = []
        for i in range(n):
            if node_to_pn[i] == -1:
                pid = len(pn_to_node)
                pn_to_node.append(i)
                node_to_pn[i] = pid
                for j in self.alignedto[i]:
                    node_to_pn[j] = pid
        npn = len(pn_to_node)
        indeg = [0] * npn
        out_p: list[set] = [set() for _ in range(npn)]
        for ei in range(len(self.e_in)):
            a = node_to_pn[self.e_in[ei]]
            b = node_to_pn[self.e_out[ei]]
            if a != b:
                out_p[a].add((ei, b))
        # pseudo-node in-degrees from distinct incoming pseudo edges
        in_counts = [0] * npn
        for a in range(npn):
            for _, b in out_p[a]:
                in_counts[b] += 1
        order = []
        from collections import deque

        ready = deque(p for p in range(npn) if in_counts[p] == 0)
        seen = 0
        while ready:
            p = ready.popleft()
            group = [pn_to_node[p]] + list(self.alignedto[pn_to_node[p]])
            order.extend(group)
            seen += 1
            for _, b in out_p[p]:
                in_counts[b] -= 1
                if in_counts[b] == 0:
                    ready.append(b)
        self.sorted_nodes = order


def _align_and_merge(g: _Graph, seq: bytes, label: int):
    """NW of seq vs graph + merge (align_seq_to_graph_nw)."""
    x = g.n()
    y = len(seq)
    order = g.sorted_nodes
    pos_of = {ni: i for i, ni in enumerate(order)}
    sarr = np.frombuffer(seq, dtype=np.uint8).astype(np.int64)

    s = np.zeros((x + 1, y + 1), dtype=np.int64)
    px = np.zeros((x + 1, y + 1), dtype=np.int32)
    py = np.zeros((x + 1, y + 1), dtype=np.int32)
    s[0, :] = np.arange(y + 1) * GAPS
    py[0, 1:] = np.arange(y)
    # first column: best predecessor chain + gap
    for i, ni in enumerate(order):
        preds = [pos_of[g.e_in[e]] for e in g.inedge[ni]]
        base0 = max((s[p + 1, 0] for p in preds), default=0)
        s[i + 1, 0] = base0 + GAPS

    jj = np.arange(1, y + 1)
    for i, ni in enumerate(order):
        nb = g.base[ni]
        preds = [pos_of[g.e_in[e]] for e in g.inedge[ni]]
        sub = np.where(sarr == nb, MATCH, MISMATCH)
        best = np.full(y, -(1 << 60), dtype=np.int64)
        bx = np.zeros(y, dtype=np.int32)
        by = np.zeros(y, dtype=np.int32)
        srcs = preds if preds else [-1]
        for p in srcs:
            row = s[p + 1]
            dele = row[1:] + GAPS
            matc = row[:-1] + sub
            # C order: del replaces when > cur and >= match; then match
            take_d = (dele > best) & (dele >= matc)
            best = np.where(take_d, dele, best)
            bx = np.where(take_d, p + 1, bx)
            by = np.where(take_d, jj, by)
            take_m = matc > best
            best = np.where(take_m, matc, best)
            bx = np.where(take_m, p + 1, bx)
            by = np.where(take_m, jj - 1, by)
        # insertion chain: cell[j] = max(best[j], cell[j-1] + GAPS),
        # insertion preferred on ties (the C default candidate)
        aug = np.concatenate([[s[i + 1, 0]], best]) - np.arange(y + 1) * GAPS
        run = np.maximum.accumulate(aug)
        ins = run[:-1] + np.arange(1, y + 1) * GAPS
        cell = np.where(best > ins, best, ins)
        is_ins = ins >= best
        s[i + 1, 1:] = cell
        px[i + 1, 1:] = np.where(is_ins, i + 1, bx)
        py[i + 1, 1:] = np.where(is_ins, jj - 1, by)

    # best end: sink rows (outdegree 0) at column y
    bestx = 0
    bests = None
    for i, ni in enumerate(order):
        if not g.outedge[ni]:
            if bests is None or s[i + 1, y] > bests:
                bests = s[i + 1, y]
                bestx = i + 1
    # traceback -> match route [(node or -1, seqpos or -1)]
    route = []
    cx, cy = bestx, y
    starty, endy = -1, -1
    while cx != 0 or cy != 0:
        nx, ny = int(px[cx, cy]), int(py[cx, cy])
        rn = order[cx - 1] if nx != cx else -1
        rq = cy - 1 if ny != cy else -1
        if rq != -1:
            starty = rq
            if endy == -1:
                endy = rq
        route.append((rn, rq))
        cx, cy = nx, ny
    route.reverse()

    # merge into graph (align_seq_to_graph_updategraphy)
    head = -1
    first = -1
    if starty > 0:
        first, head = g.add_chain(seq[:starty], label)
    tail_first = -1
    if endy < y - 1:
        tail_first, _tail_head = -1, -1
        tail_first, _ = g.add_chain(seq[endy + 1 :], label)
    updated_head = True
    for rn, rq in route:
        if rq == -1:
            continue
        base = seq[rq]
        updated = False
        if rn == -1:
            node = g.add_node(base)
            updated = True
        elif g.base[rn] == base:
            node = rn
        else:
            node = -1
            for cand in g.alignedto[rn]:
                if g.base[cand] == base:
                    node = cand
            if node == -1:
                node = g.add_node(base)
                updated = True
                g.alignedto[node] = [rn] + list(g.alignedto[rn])
                for other in g.alignedto[node]:
                    g.alignedto[other].append(node)
        if head != -1:
            if updated or updated_head or not g.label_edge(head, node, label):
                g.add_edge(head, node, label)
        head = node
        updated_head = updated
        if first == -1:
            first = head
    if tail_first != -1 and head != -1:
        g.add_edge(head, tail_first, label)
    g.toposort()


def poa_consensus(seqs: list[bytes]) -> bytes:
    """poa_to_consensus (dag.c:658-694): progressive POA + heaviest path."""
    if not seqs:
        return b""
    g = _Graph()
    _, _ = g.add_chain(seqs[0], 0)
    g.sorted_nodes = list(range(g.n()))
    for label, seq in enumerate(seqs[1:], start=1):
        if not seq:
            continue
        _align_and_merge(g, seq, label)

    best_score = [0.0] * g.n()
    best_pnode = [-1] * g.n()
    gbest, gscore = -1, -1.0
    for ni in g.sorted_nodes:
        if g.inedge[ni]:
            bs, bp = None, -1
            for ei in g.inedge[ni]:
                sc = (best_score[g.e_in[ei]] + len(g.e_labels[ei])
                      - 0.5 * len(g.inedge[ni]))
                if bs is None or sc > bs:
                    bs, bp = sc, g.e_in[ei]
        else:
            bs, bp = 0.0, -1
        best_score[ni] = bs
        best_pnode[ni] = bp
        if bs > gscore:
            gscore, gbest = bs, ni
    out = bytearray()
    ni = gbest
    while ni != -1:
        out.append(g.base[ni])
        ni = best_pnode[ni]
    out.reverse()
    return bytes(out)
