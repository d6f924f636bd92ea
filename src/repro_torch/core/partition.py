"""Model partition into sequential sub-graphs (paper Appendix B, Alg. 2).

A copy of ``repro/core/partition.py`` (pure Python, no framework).

The computation DAG is split into maximal single-entry/single-exit regions
("groups") that execute strictly sequentially at run time, so per-group time
gains add up (Sec. 2.3.1). The algorithm is the paper's verbatim: BFS
longest-path labels, then a frontier sweep that absorbs parallel branches
until each reconvergence point.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

__all__ = ["GraphSpec", "partition_sequential"]

START = "__start__"
END = "__end__"


@dataclasses.dataclass
class GraphSpec:
    """A DAG of named ops. Quantizable nodes correspond to qops op names."""

    nodes: dict = dataclasses.field(default_factory=dict)   # name -> quantizable
    edges: set = dataclasses.field(default_factory=set)     # (src, dst)
    residual_edges: set = dataclasses.field(default_factory=set)

    def add(self, name: str, quantizable: bool = False) -> str:
        self.nodes.setdefault(name, quantizable)
        if quantizable:
            self.nodes[name] = True
        return name

    def edge(self, src: str, dst: str, residual: bool = False) -> None:
        assert src in self.nodes and dst in self.nodes, (src, dst)
        self.edges.add((src, dst))
        if residual:
            self.residual_edges.add((src, dst))

    def chain(self, *names: str, quantizable: bool = False) -> None:
        for n in names:
            self.add(n, quantizable)
        for a, b in zip(names, names[1:]):
            self.edge(a, b)

    def successors(self, drop_residual: bool) -> dict:
        nxt: dict = {n: [] for n in self.nodes}
        for (a, b) in sorted(self.edges):
            if drop_residual and (a, b) in self.residual_edges:
                continue
            nxt[a].append(b)
        return nxt

    def quantizable_nodes(self) -> list:
        return [n for n, q in self.nodes.items() if q]


def _longest_paths(nodes: Iterable[str], nxt: dict) -> dict:
    """Longest path length from START via DP in topological order."""
    indeg = {n: 0 for n in nodes}
    for n, succs in nxt.items():
        for s in succs:
            indeg[s] += 1
    from collections import deque
    order = deque(sorted(n for n, d in indeg.items() if d == 0))
    dist = {n: 0 for n in nodes}
    topo = []
    while order:
        n = order.popleft()
        topo.append(n)
        for s in nxt[n]:
            dist[s] = max(dist[s], dist[n] + 1)
            indeg[s] -= 1
            if indeg[s] == 0:
                order.append(s)
    assert len(topo) == len(dist), "graph has a cycle"
    return dist


def partition_sequential(graph: GraphSpec, drop_residual: bool = True,
                         max_group_size: Optional[int] = None) -> list:
    """Alg. 2: returns ordered groups [[op names...], ...] of quantizable ops.

    ``drop_residual=True`` removes residual bypass edges before partitioning,
    as the paper does (Fig. 6 omits residual adds); otherwise every
    transformer block would collapse into a single group.
    ``max_group_size``: optionally split oversized groups (keeps F^L_j
    enumerable); a deviation from the paper, off by default.
    """
    g = GraphSpec(dict(graph.nodes), set(graph.edges), set(graph.residual_edges))
    nxt = g.successors(drop_residual)

    # attach virtual start/end
    has_pred = {b for (a, b) in g.edges
                if not (drop_residual and (a, b) in g.residual_edges)}
    sources = [n for n in g.nodes if n not in has_pred]
    sinks = [n for n in g.nodes if not nxt[n]]
    nodes = dict(g.nodes)
    nodes[START] = False
    nodes[END] = False
    nxt[START] = sorted(sources)
    for s in sinks:
        nxt[s] = [END]
    nxt[END] = []

    path_len = _longest_paths(nodes, nxt)

    V: list = []
    vertex = START
    visited_guard = 0
    while vertex != END:
        visited_guard += 1
        assert visited_guard <= len(nodes) + 2, "partition did not converge"
        Vp: list = []
        cur_len = path_len[vertex] + 1
        A = list(dict.fromkeys(nxt[vertex]))
        while len(A) > 1:
            progressed = False
            for v in list(A):
                if path_len[v] <= cur_len:
                    A.remove(v)
                    if v != END and v not in Vp:
                        Vp.append(v)
                    for s in nxt[v]:
                        if s not in A:
                            A.append(s)
                    progressed = True
            cur_len += 1
            if not progressed and len(A) > 1:
                # all remaining vertices deeper than cur_len: fast-forward
                cur_len = min(path_len[v] for v in A)
        vertex = A[0]
        if vertex != END and vertex not in Vp:
            Vp.append(vertex)
        # keep only quantizable ops, preserve topological order
        Vp = sorted((v for v in Vp if nodes.get(v, False)),
                    key=lambda v: (path_len[v], v))
        if Vp:
            V.append(Vp)

    if max_group_size is not None:
        out = []
        for grp in V:
            for i in range(0, len(grp), max_group_size):
                out.append(grp[i:i + max_group_size])
        V = out
    return V
