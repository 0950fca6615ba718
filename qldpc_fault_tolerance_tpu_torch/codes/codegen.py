"""Random biregular classical-code generation with girth optimization.

Replaces the reference's seed-code generator
(src/QuantumExanderCodesGene.py:76-330): random (Δc,Δv)-biregular bipartite
Tanner graphs from a configuration model, repaired to simple graphs, then
improved by girth-raising edge swaps; the surviving seeds feed ``hgp(H, H)``
to build the quantum expander codes (hgp_34_* family).

Design differences from the reference (all host-side, one-time):
  * multi-edge repair is a single uniform double-swap loop (handles any
    multiplicity) instead of separate double/triple-switch passes
    (DSwitch/TSwitch, src/QuantumExanderCodesGene.py:76-178);
  * girth is computed exactly by per-edge BFS, not as the min length of a
    fundamental cycle basis (the reference's ``Girth`` via nx.cycle_basis,
    :26-28, can overestimate);
  * the swap acceptance signal counts edges on shortest cycles rather than
    basis cycles — same hill-climbing structure
    (RandSwapEdges1, :268-310), exact signal;
  * everything takes an explicit ``numpy.random.Generator`` so regenerated
    code families are reproducible (recorded seeds).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from . import gf2
from .hgp import classical_code_distance, hgp

__all__ = [
    "random_biregular_tanner",
    "tanner_girth",
    "min_cycle_edges",
    "improve_girth",
    "GeneRandGraphsLargeGirthFinal",
    "GetClassicalCodeParams",
    "QuantumExpanderFromCheckMat",
]

NO_CYCLE = int(1e7)  # the reference's "forest" sentinel (src:28)


def random_biregular_tanner(n0: int, delta_c: int, delta_v: int, rng=None):
    """Random simple (Δc,Δv)-biregular bipartite check matrix.

    Shape: (n0*delta_v) checks x (n0*delta_c) bits — every check has degree
    delta_c, every bit degree delta_v (configuration-model pairing + repair,
    reference RandomaGraphs, src/QuantumExanderCodesGene.py:181-233).
    """
    rng = np.random.default_rng(rng)
    m, n = n0 * delta_v, n0 * delta_c
    while True:
        c_ports = np.repeat(np.arange(m), delta_c)
        v_ports = np.repeat(np.arange(n), delta_v)
        rng.shuffle(c_ports)
        rng.shuffle(v_ports)
        edges = list(zip(c_ports.tolist(), v_ports.tolist()))
        if _repair_multiedges(edges, rng):
            H = np.zeros((m, n), dtype=np.uint8)
            cs, vs = zip(*edges)
            H[list(cs), list(vs)] = 1
            assert (H.sum(1) == delta_c).all() and (H.sum(0) == delta_v).all()
            return H


def _repair_multiedges(edges: list, rng, max_tries: int = 10000) -> bool:
    """Make the multigraph simple by double swaps: replace a duplicated edge
    (c,v) and a random edge (c',v') with (c,v') and (c',v) when that creates
    no new duplicate.  Returns False if it cannot converge (caller redraws)."""
    from collections import Counter

    count = Counter(edges)
    for _ in range(max_tries):
        dups = [e for e, k in count.items() if k > 1]
        if not dups:
            edges[:] = list(count.keys())
            return True
        c, v = dups[0]
        c2, v2 = edges[rng.integers(len(edges))]
        if c2 == c or v2 == v:
            continue
        if count[(c, v2)] or count[(c2, v)]:
            continue
        for old, new in (((c, v), (c, v2)), ((c2, v2), (c2, v))):
            count[old] -= 1
            if not count[old]:
                del count[old]
            count[new] = count.get(new, 0) + 1
        edges[:] = [e for e, k in count.items() for _ in range(k)]
    return False


def _adjacency(H):
    """Tanner-graph adjacency: checks are nodes [0,m), bits [m, m+n)."""
    H = np.asarray(H)
    m, n = H.shape
    adj = [[] for _ in range(m + n)]
    for c, v in zip(*np.nonzero(H)):
        adj[c].append(m + v)
        adj[m + v].append(int(c))
    return adj


def _shortest_cycle_through_edge(adj, u, v) -> int:
    """Length of the shortest cycle containing edge (u,v): 1 + shortest
    path u->v avoiding that edge (BFS)."""
    dist = {u: 0}
    dq = deque([u])
    while dq:
        x = dq.popleft()
        for y in adj[x]:
            if x == u and y == v:
                continue
            if y not in dist:
                dist[y] = dist[x] + 1
                if y == v:
                    return dist[y] + 1
                dq.append(y)
    return NO_CYCLE


def min_cycle_edges(H):
    """(girth, edges-on-a-shortest-cycle) — exact, via per-edge BFS."""
    H = np.asarray(H)
    m, _ = H.shape
    adj = _adjacency(H)
    lengths = {}
    for c, v in zip(*np.nonzero(H)):
        lengths[(int(c), int(v))] = _shortest_cycle_through_edge(adj, int(c), m + int(v))
    girth = min(lengths.values(), default=NO_CYCLE)
    if girth >= NO_CYCLE:
        return NO_CYCLE, []
    return girth, [e for e, L in lengths.items() if L == girth]


def tanner_girth(H) -> int:
    """Exact girth of the Tanner graph (reference Girth, src:26-28 —
    but exact rather than a cycle-basis upper bound)."""
    return min_cycle_edges(H)[0]


def improve_girth(H, target_girth: int, max_iter: int = 20000, rng=None):
    """Hill-climb edge swaps to raise the girth (reference RandSwapEdges1,
    src/QuantumExanderCodesGene.py:268-310): swap a random shortest-cycle
    edge with a random other edge; accept when (girth, -#shortest-cycle
    edges) does not get worse.  Degree sequence is invariant under swaps.

    Returns (H, success)."""
    rng = np.random.default_rng(rng)
    H = np.asarray(H).copy()
    girth, crit = min_cycle_edges(H)
    for _ in range(max_iter):
        if girth >= target_girth:
            return H, True
        c1, v1 = crit[rng.integers(len(crit))]
        es = np.transpose(np.nonzero(H))
        c2, v2 = es[rng.integers(len(es))]
        if (c1, v1) == (int(c2), int(v2)):
            continue
        # swap to (c1,v2), (c2,v1); skip if it would create a duplicate
        if H[c1, v2] or H[c2, v1]:
            continue
        H2 = H.copy()
        H2[c1, v1] = H2[c2, v2] = 0
        H2[c1, v2] = H2[c2, v1] = 1
        g2, crit2 = min_cycle_edges(H2)
        if g2 > girth or (g2 == girth and len(crit2) <= len(crit)):
            H, girth, crit = H2, g2, crit2
    return H, girth >= target_girth


def GeneRandGraphsLargeGirthFinal(n0: int, Delta_c: int, Delta_v: int,
                                  min_girth1: int, target_girth: int,
                                  num: int, max_iter: int, seed=None,
                                  swap_iters: int = 20000):
    """Generate ``num`` (Δc,Δv)-biregular check matrices whose Tanner girth
    reaches ``target_girth`` (reference src/QuantumExanderCodesGene.py:314-330;
    returns check matrices rather than nx graphs)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(max_iter)):
        if len(out) >= num:
            break
        H = random_biregular_tanner(n0, Delta_c, Delta_v, rng)
        if tanner_girth(H) < min_girth1:
            continue
        H2, ok = improve_girth(H, target_girth, max_iter=swap_iters, rng=rng)
        if ok:
            out.append(H2)
    if len(out) < num:
        # non-convergence is a signal, not stdout noise: warn + count it
        import warnings

        from ..utils import telemetry

        telemetry.count("codegen.max_iter_reached")
        warnings.warn(
            f"GeneRandGraphsLargeGirthFinal: max_iter={max_iter} reached "
            f"with {len(out)}/{num} codes at girth {target_girth}",
            stacklevel=2)
    return out


def GetClassicalCodeParams(H):
    """[n, k, d, lambda_2] (reference src/QuantumExanderCodesGene.py:65-73):
    block length, dimension by rank-nullity, exhaustive distance, and the
    second-largest eigenvalue of H^T H (expansion proxy)."""
    H = gf2.to_gf2(H)
    n = H.shape[1]
    k = n - gf2.rank(H)
    d = classical_code_distance(H)
    eigs = np.linalg.eigvalsh(H.T.astype(float) @ H.astype(float))
    lambda_2 = np.sort(eigs)[-2] if len(eigs) >= 2 else 0.0
    return [n, k, d, lambda_2]


def QuantumExpanderFromCheckMat(H, compute_distance: bool = True):
    """hgp(H, H) (reference src/QuantumExanderCodesGene.py:30-34)."""
    return hgp(H, H, compute_distance=compute_distance)
