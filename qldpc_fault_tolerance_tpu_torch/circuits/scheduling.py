"""CX-gate scheduling for stabilizer-extraction circuits.

Host-side, one-time-per-code.  Two generators with the same output contract as
the reference (src/CircuitScheduling.py): a list of per-timestep dicts
``{check_index: qubit_index}`` — at timestep t each listed check's ancilla
interacts with its listed data qubit.

* ``ColorationCircuit(H)`` — proper bipartite edge coloring, so every qubit
  and every ancilla is touched at most once per timestep.  The reference pads
  the Tanner graph to a Δ-regular bipartite graph and peels Hopcroft–Karp
  perfect matchings (src/CircuitScheduling.py:8-110); here we use König's
  constructive edge-coloring (color one edge at a time, repairing conflicts
  by swapping colors along an alternating path), which always achieves depth
  exactly Δ = max degree of the Tanner graph — never worse than the
  reference's padded-graph depth, and with no padding heuristics to get stuck.
* ``RandomCircuit(H)`` — each check's neighborhood in an independently
  shuffled order (seed 30000+i for check i, matching the reference's fixed
  seeds, src/CircuitScheduling.py:116-131); depth = max stabilizer weight,
  with no collision avoidance on the data-qubit side.
"""
from __future__ import annotations

import random

import numpy as np

__all__ = ["ColorationCircuit", "RandomCircuit", "validate_schedule"]


def _first_free(used: dict) -> int:
    col = 0
    while col in used:
        col += 1
    return col


def ColorationCircuit(H) -> list[dict[int, int]]:
    """Edge-coloring CX schedule (depth = max Tanner-graph degree)."""
    H = np.asarray(H)
    num_checks, num_qubits = H.shape
    check_edges: list[dict[int, int]] = [{} for _ in range(num_checks)]  # color -> qubit
    qubit_edges: list[dict[int, int]] = [{} for _ in range(num_qubits)]  # color -> check

    for c in range(num_checks):
        for q in np.flatnonzero(H[c]).tolist():
            a = _first_free(check_edges[c])
            if a not in qubit_edges[q]:
                check_edges[c][a] = q
                qubit_edges[q][a] = c
                continue
            b = _first_free(qubit_edges[q])
            # a is free at the check but used at the qubit; swap colors a<->b
            # along the a,b-alternating path starting from q — in a bipartite
            # graph that path cannot terminate at c (parity of the color
            # sequence), so after the swap a is free at both endpoints
            path = []  # (check, qubit, color) edges along the walk
            node, on_qubit, col = q, True, a
            while True:
                nxt = (qubit_edges[node] if on_qubit else check_edges[node]).get(col)
                if nxt is None:
                    break
                path.append((nxt, node, col) if on_qubit else (node, nxt, col))
                node, on_qubit, col = nxt, not on_qubit, (b if col == a else a)
            for pc, pq, pcol in path:
                del check_edges[pc][pcol]
                del qubit_edges[pq][pcol]
            for pc, pq, pcol in path:
                new = b if pcol == a else a
                check_edges[pc][new] = pq
                qubit_edges[pq][new] = pc
            check_edges[c][a] = q
            qubit_edges[q][a] = c

    depth = max((max(d, default=-1) for d in check_edges), default=-1) + 1
    return [
        {c: check_edges[c][t] for c in range(num_checks) if t in check_edges[c]}
        for t in range(depth)
    ]


def ColorationCircuitHK(H) -> list[dict[int, int]]:
    """The reference's exact coloration schedule (src/CircuitScheduling.py:
    8-110): pad the Tanner graph to a Δ-regular bipartite graph (dummy check
    nodes, then greedy dummy edges in node-insertion order), then repeatedly
    peel Hopcroft–Karp maximum matchings off the padded graph, keeping each
    matching's real-check pairs as one timestep.

    This reproduces the reference's *timestep structure*, which is
    physics-relevant at circuit level (it fixes which CX hook errors align
    across checks).  Two behavioral quirks are preserved deliberately:

      * matchings are peeled until the PADDED graph is empty, so the depth
        can exceed Δ of the real graph and timesteps can be sparse;
      * a real check with degree < Δ receives dummy edges to real qubits,
        and a matching may pair it through such a dummy edge — the resulting
        {check: qubit} entry is NOT a Tanner edge (the reference schedules
        this spurious CX too; ``validate_schedule`` therefore does not apply
        to this generator for irregular H).

    Determinism: node/edge insertion orders and the greedy padding loop
    mirror the reference exactly; ``hopcroft_karp_matching`` and small-int
    set iteration are deterministic, so the schedule is reproducible.
    """
    import networkx as nx
    from networkx.algorithms import bipartite as nx_bipartite

    H = np.asarray(H)
    num_checks, num_bits = H.shape
    g = nx.Graph()
    c_nodes = [-(i + 1) for i in range(num_checks)]
    v_nodes = [j + 1 for j in range(num_bits)]
    g.add_nodes_from(c_nodes, bipartite=0)
    g.add_nodes_from(v_nodes, bipartite=1)
    g.add_edges_from(
        (-(i + 1), j + 1)
        for i in range(num_checks)
        for j in range(num_bits)
        if H[i][j] == 1
    )

    # pad: dummy check nodes up to the qubit count, then greedy dummy edges
    # (first open check x first open qubit, re-scanned in insertion order)
    # until every node reaches Δ = max degree
    gs = g.copy()
    gs.add_nodes_from(
        (-(i + 1) for i in range(num_checks, num_bits)), bipartite=0)
    delta = max(d for _, d in gs.degree)
    open_deg = {node: deg for node, deg in dict(gs.degree()).items()
                if deg < delta}
    while open_deg:
        added = 0
        for c in [n for n in open_deg if n < 0]:
            for v in [n for n in open_deg if n > 0]:
                if not gs.has_edge(c, v):
                    gs.add_edge(c, v)
                    added += 1
                    for node in (c, v):
                        if open_deg[node] + 1 == delta:
                            open_deg.pop(node)
                        else:
                            open_deg[node] += 1
                    break
        if not added:
            # every open check already touches every open qubit; the greedy
            # padding cannot reach Δ-regularity (the reference's loop spins
            # forever here) — fail loudly instead
            raise ValueError(
                "coloration_hk: Δ-regular padding is infeasible for this H "
                "(greedy dummy-edge pass made no progress); use "
                "circuit_type='coloration'"
            )

    # peel maximum matchings; keep real-check pairs per timestep
    real_c = {n for n, d in g.nodes(data=True) if d["bipartite"] == 0}
    all_c = {n for n, d in gs.nodes(data=True) if d["bipartite"] == 0}
    schedule = []
    while gs.number_of_edges() > 0:
        bm = nx_bipartite.matching.hopcroft_karp_matching(gs, list(all_c))
        schedule.append({-c - 1: bm[c] - 1 for c in bm if c in real_c})
        gs.remove_edges_from([(c, bm[c]) for c in bm if c in all_c])
    return schedule


def RandomCircuit(H) -> list[dict[int, int]]:
    """Shuffled-neighborhood schedule (reference src/CircuitScheduling.py:116-131).

    Keeps the reference's deterministic per-check seeds (30000 + check index)
    so schedules are reproducible across runs and implementations.
    """
    H = np.asarray(H)
    num_checks, _ = H.shape
    seed0 = 30000
    orders = [list(np.flatnonzero(H[i])) for i in range(num_checks)]
    for i, order in enumerate(orders):
        random.Random(seed0 + i).shuffle(order)
    depth = max((len(o) for o in orders), default=0)
    return [
        {i: orders[i][t] for i in range(num_checks) if len(orders[i]) > t}
        for t in range(depth)
    ]


def validate_schedule(H, schedule, require_disjoint_qubits: bool = True) -> None:
    """Check a schedule covers exactly the Tanner edges, each ancilla used at
    most once per timestep, and (optionally) each qubit at most once per
    timestep.  Raises AssertionError on violation."""
    H = np.asarray(H)
    seen = set()
    for step in schedule:
        qubits = list(step.values())
        assert len(set(step.keys())) == len(step), "duplicate check in timestep"
        if require_disjoint_qubits:
            assert len(set(qubits)) == len(qubits), "qubit reused within a timestep"
        for c, q in step.items():
            assert H[c, q] == 1, f"({c},{q}) is not a Tanner edge"
            assert (c, q) not in seen, f"edge ({c},{q}) scheduled twice"
            seen.add((c, q))
    expected = {(i, j) for i, j in zip(*np.nonzero(H))}
    assert seen == expected, "schedule does not cover all Tanner edges"
