"""SAT utilities: CNF generation, CNF<->circuit conversion, solving.

Rebuild of DG_VAE/deepgate/utils/sat_utils.py — whose solver backend is
``external.PyMiniSolvers`` (a C++ minisat wrapper the reference does NOT
vendor, so the module is dead as shipped, SURVEY.md §2.1). Here the solver
is a self-contained iterative DPLL with unit propagation and
most-occurring-literal branching — no external binary — with the same
``solve_sat(n_vars, iclauses) -> (is_sat, sol)`` surface. Clauses are lists
of signed 1-based ints (DIMACS convention), as in the reference.
"""
from __future__ import annotations

import numpy as np

from ..data.graph import CircuitGraph, build_graph


# ---------------------------------------------------------------------------
# DPLL solver (replaces minisolvers.MinisatSolver)
# ---------------------------------------------------------------------------

def solve_sat(n_vars: int, iclauses) -> tuple[bool, list | None]:
    """Returns (is_sat, model) with model as 0/1 list per var (1-based order),
    matching PyMiniSolvers' get_model()."""
    clauses = [tuple(set(c)) for c in iclauses]
    for c in clauses:
        if not c:
            return False, None
    assign: dict[int, bool] = {}

    def unit_propagate(clauses, assign):
        changed = True
        while changed:
            changed = False
            new_clauses = []
            for c in clauses:
                vals = []
                satisfied = False
                for lit in c:
                    v = assign.get(abs(lit))
                    if v is None:
                        vals.append(lit)
                    elif (lit > 0) == v:
                        satisfied = True
                        break
                if satisfied:
                    continue
                if not vals:
                    return None, None  # conflict
                if len(vals) == 1:
                    lit = vals[0]
                    assign[abs(lit)] = lit > 0
                    changed = True
                else:
                    new_clauses.append(tuple(vals))
            clauses = new_clauses
        return clauses, assign

    def branch_var(clauses):
        counts: dict[int, int] = {}
        for c in clauses:
            for lit in c:
                counts[abs(lit)] = counts.get(abs(lit), 0) + 1
        return max(counts, key=counts.get) if counts else None

    stack = [(clauses, dict(assign), None)]
    while stack:
        cls, asg, _ = stack.pop()
        cls, asg = unit_propagate(cls, asg)
        if cls is None:
            continue
        if not cls:
            model = [1 if asg.get(v, False) else 0 for v in range(1, n_vars + 1)]
            return True, model
        v = branch_var(cls)
        for val in (True, False):
            a2 = dict(asg)
            a2[v] = val
            stack.append((cls, a2, None))
    return False, None


def generate_k_iclause(n: int, k: int, rng=None):
    """Random k-clause (sat_utils.py:20-22)."""
    rng = rng or np.random.default_rng()
    vs = rng.choice(n, size=min(n, k), replace=False)
    return [int(v) + 1 if rng.random() < 0.5 else -(int(v) + 1) for v in vs]


def gen_iclause_pair(n: int, p_k_2: float = 0.3, p_geo: float = 0.4, rng=None):
    """SAT/UNSAT problem pair a la NeuroSAT (sat_utils.py:25-47): grow random
    clauses until UNSAT; flipping one literal of the last clause restores SAT."""
    rng = rng or np.random.default_rng()
    iclauses = []
    while True:
        k_base = 1 if rng.random() < p_k_2 else 2
        k = k_base + rng.geometric(p_geo)
        iclause = generate_k_iclause(n, int(k), rng)
        is_sat, _ = solve_sat(n, iclauses + [iclause])
        if is_sat:
            iclauses.append(iclause)
        else:
            break
    iclause_unsat = iclause
    iclause_sat = [-iclause_unsat[0]] + iclause_unsat[1:]
    return n, iclauses, iclause_unsat, iclause_sat


# ---------------------------------------------------------------------------
# circuit <-> CNF (aiger_utils.py:6-113,191-284 equivalents)
# ---------------------------------------------------------------------------

def aig_to_cnf(gate: np.ndarray, edge_index: np.ndarray, po_idx: int):
    """Tseitin encoding of an AIG ({PI:0, AND:1, NOT:2}) with the PO asserted
    true. Variables are node_idx + 1."""
    n = len(gate)
    fanin = [[] for _ in range(n)]
    for u, v in np.asarray(edge_index).T:
        fanin[int(v)].append(int(u))
    cnf = []
    for idx in range(n):
        v = idx + 1
        g = int(gate[idx])
        if g == 1:  # AND
            ins = [f + 1 for f in fanin[idx]]
            for i in ins:
                cnf.append([-v, i])
            cnf.append([v] + [-i for i in ins])
        elif g == 2:  # NOT
            i = fanin[idx][0] + 1
            cnf.append([-v, -i])
            cnf.append([v, i])
    cnf.append([po_idx + 1])
    return cnf, n


def cnf_to_circuit(iclauses, n_vars: int) -> CircuitGraph:
    """Expand a CNF into an AIG-convention circuit: each clause becomes an
    OR realized as NOT(AND(NOT inputs)); the PO is the AND of clause outputs
    (cnf_to_aig semantics, aiger_utils.py:191-284)."""
    gate = [0] * n_vars  # PIs
    edges = []
    not_of = {}

    def mk(g):
        gate.append(g)
        return len(gate) - 1

    def lit_node(lit):
        v = abs(lit) - 1
        if lit > 0:
            return v
        if v not in not_of:
            nn = mk(2)
            edges.append((v, nn))
            not_of[v] = nn
        return not_of[v]

    clause_outs = []
    for clause in iclauses:
        # OR(l1..lk) = NOT(AND(NOT l1, ..., NOT lk))
        neg_nodes = [lit_node(-l) for l in clause]
        if len(neg_nodes) == 1:
            and_node = neg_nodes[0]
        else:
            and_node = mk(1)
            for u in neg_nodes:
                edges.append((u, and_node))
        out = mk(2)
        edges.append((and_node, out))
        clause_outs.append(out)
    if len(clause_outs) == 1:
        po = clause_outs[0]
    else:
        po = mk(1)
        for u in clause_outs:
            edges.append((u, po))
    edge_index = np.asarray(edges, dtype=np.int64).T if edges else np.zeros((2, 0), np.int64)
    g = build_graph("cnf", np.asarray(gate, dtype=np.int32), edge_index)
    return g


def solve_sat_iteratively(iclauses, n_vars: int, var_scores=None):
    """Score-guided assignment search (sat_utils.py:309-432 spirit): branch
    variables in descending |score - 0.5| (confidence) order, trying the
    predicted polarity first; falls back to plain DPLL ordering without
    scores. Returns (is_sat, model)."""
    if var_scores is None:
        return solve_sat(n_vars, iclauses)
    order = np.argsort(-np.abs(np.asarray(var_scores) - 0.5))
    clauses = [tuple(set(c)) for c in iclauses]

    def propagate(clauses, assign):
        changed = True
        while changed:
            changed = False
            out = []
            for c in clauses:
                keep = []
                sat = False
                for lit in c:
                    v = assign.get(abs(lit))
                    if v is None:
                        keep.append(lit)
                    elif (lit > 0) == v:
                        sat = True
                        break
                if sat:
                    continue
                if not keep:
                    return None
                if len(keep) == 1:
                    assign[abs(keep[0])] = keep[0] > 0
                    changed = True
                else:
                    out.append(tuple(keep))
            clauses = out
        return clauses

    def rec(clauses, assign, depth):
        clauses = propagate(clauses, assign)
        if clauses is None:
            return None
        if not clauses:
            return assign
        for vi in order:
            if (vi + 1) not in assign:
                var = int(vi) + 1
                first = bool(var_scores[vi] > 0.5)
                for val in (first, not first):
                    r = rec(clauses, {**assign, var: val}, depth + 1)
                    if r is not None:
                        return r
                return None
        return assign

    res = rec(clauses, {}, 0)
    if res is None:
        return False, None
    return True, [1 if res.get(v, False) else 0 for v in range(1, n_vars + 1)]
