"""Tiny DAG utilities shared by the unified simulator and the placement
optimizer (one Kahn's algorithm instead of per-module copies)."""

from __future__ import annotations


def graph_views(ids, edges):
    """Predecessor/successor lists plus a deterministic topological order
    (ties broken by ``ids`` iteration order) over arbitrary hashable node
    ids. Raises on cycles."""
    ids = list(ids)
    pred = {n: [] for n in ids}
    succ = {n: [] for n in ids}
    for a, b in edges:
        succ[a].append(b)
        pred[b].append(a)
    pos = {n: i for i, n in enumerate(ids)}
    indeg = {n: len(pred[n]) for n in ids}
    ready = sorted((n for n in ids if indeg[n] == 0), key=pos.get)
    order = []
    while ready:
        u = ready.pop(0)
        order.append(u)
        for v in succ[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
        ready.sort(key=pos.get)
    if len(order) != len(ids):
        raise ValueError("workflow graph has a cycle")
    return pred, succ, tuple(order)
