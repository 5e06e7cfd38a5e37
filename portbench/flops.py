"""The yardstick's arithmetic: the card's published peaks, the model's
operations per circuit, and the least time of each hand-written kernel of
the port from the shapes it works on.

Peaks (NVIDIA's H100 SXM data sheet, dense): 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM. Both cells run in float32 with TF32 off
("highest"), so fp32's rate is the peak.

``model_flops``: the operations one circuit's forward takes, counted from
the model's equations on its real nodes, edges and pairs (a multiply and an
add are two; activations and norms a few per element); a training step
takes three times its forward (the backward twice). Nothing recomputed is
counted, and padding is not work. The sum over a step's circuits is the
step's count, whatever layout or route the program gives the step.

The kernel bounds are ``chip_smoke.py``'s (``bound``, ``struct_bound``,
``level_bound``, ``giant_bwd_bound``) rewritten over sizes instead of the
kernels' argument tensors: the larger of the bytes a call must move (each
input read once, each output written once) over the memory rate and its
operations over fp32's rate. ``rows`` is the node count a call covers,
``edge_slots`` / ``node_slots`` the entries of its level tables (L x Ep and
L x Np for the padded tables, the real edges and gates for what the data
needs), ``table_entries`` the struct kernels' neighbour-list entries a
direction.
"""
from __future__ import annotations

PEAK_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12
F32, I32 = 4, 4
# operations per row and feature of the struct backward's LayerNorm and GRU
# backward (chip_smoke.py's STRUCT_BWD_ELEMENTWISE)
STRUCT_BWD_ELEMENTWISE = 40


def model_flops(cfg: dict, nodes: int, gates: int, edges: int, pairs: int) -> float:
    """Forward operations of DG_AE on one circuit (or a sum of circuits):
    ``nodes`` all nodes, ``gates`` those the level recurrence updates,
    ``edges`` the edges, ``pairs`` the truth-table pairs."""
    D, F, M = cfg["dim_hidden"], cfg["dim_feature"], cfg["dim_mlp"]
    n, u, e = nodes, gates, edges
    half_round = (e * D                       # neighbour sum
                  + 2 * n * D * D + n * D     # AggConv linear, degree x bias
                  + 2 * n * (D + F) * 3 * D   # GRU input product
                  + 2 * n * D * 3 * D         # GRU hidden product
                  + 20 * n * D)               # gates, LayerNorm
    struct = 2 * (cfg["s_rounds"] + cfg["t_rounds"]) * half_round
    hs = 2 * n * 2 * D * D
    level = (2 * u * 2 * D * D                # query of the node ([hs | hf])
             + 2 * 2 * e * 2 * D * D          # key and value of each in-edge
             + e * (4 * D + 6)                # scores, softmax
             + 2 * e * D                      # weighted sum
             + 2 * 2 * u * D * 3 * D + 12 * u * D)   # the expert GRU
    losses = (2 * n * D * 2 * D               # hs decomposition
              + 2 * 2 * e * D                 # edge and non-edge logits
              + 2 * n * (D * M + M * M + M) + 10 * n * M   # readout MLP
              + 6 * pairs * D)                # cosine distances
    return float(struct + hs + level + losses)


def train_flops(cfg: dict, nodes: int, gates: int, edges: int, pairs: int) -> float:
    return 3.0 * model_flops(cfg, nodes, gates, edges, pairs)


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time in ms: bytes at the memory rate or operations at
    fp32's rate, whichever is larger, both kept."""
    by_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOP_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_ms": by_bytes, "operations_ms": by_ops}


def struct_bound(rows: int, edges: int, table_entries: int, D: int, rounds: int,
                 residuals: bool, backward: bool = False) -> dict:
    """Kernel 7 (forward of both towers, ``struct_towers.cu``) or kernel 8
    (its backward, ``struct_towers_bwd.cu``) over ``2 * rounds``
    half-rounds."""
    hr = 2 * rounds
    xi = 2 * 2 * rows * 3 * D * F32
    wfold = w_hh = 2 * 2 * D * 3 * D * F32
    b_hh, ln = 2 * 2 * 3 * D * F32, 2 * D * F32
    tables = (2 * table_entries + 2 * 2 * rows) * I32
    sargs = xi + wfold + w_hh + b_hh + 2 * ln
    state, res = 2 * rows * D * F32, hr * 2 * rows * 7 * D * F32
    if backward:
        moved = state + res + wfold + w_hh + ln + tables + sargs
        return bound(moved, (2 * hr - 1) * 2 * 12 * rows * D * D
                     + hr * 2 * STRUCT_BWD_ELEMENTWISE * rows * D
                     + (hr - 1) * 2 * edges * D)
    moved = sargs + tables + state + (res if residuals else 0)
    return bound(moved, hr * 2 * 12 * rows * D * D + hr * 2 * edges * D)


def _level_work(e: int, u: int, D: int, backward: bool) -> float:
    if backward:
        return u * 12 * D * D + e * 8 * D * D
    return e * 4 * D * D + u * 6 * D * D + e * 6 * D + u * 12 * D


def _level_bytes(edge_slots: int, node_slots: int, D: int, T: int) -> dict:
    pack = edge_slots * (D + 2) * F32
    tabs_rest = 3 * edge_slots * I32 + 3 * node_slots * I32
    w = {"wkv_hf": D * 2 * T * D * F32, "w_ih": D * T * 3 * D * F32,
         "b_ih": T * 3 * D * F32, "b_hh": T * 3 * D * F32, "wa_k": T * D * F32}
    return {"pack": pack, "tabs": pack + tabs_rest, "weights": sum(w.values()),
            "bwd_weights": w["wkv_hf"] + w["w_ih"] + w["b_hh"] + w["wa_k"],
            "res": edge_slots * (3 * D + 1) * F32 + node_slots * 4 * D * F32}


def level_bound(edge_slots: int, node_slots: int, e: int, u: int, rows: int, D: int, T: int,
                residuals: bool, backward: bool = False) -> dict:
    """Kernel 1 (the fused level scan, ``level_scan.cu``; without residuals
    also kernel 3, the giant route's forward) or kernel 2 (its backward,
    ``level_scan_bwd.cu``): ``e`` valid edges and ``u`` updated gates do
    the work."""
    b = _level_bytes(edge_slots, node_slots, D, T)
    if backward:
        moved = (rows * D * F32 + b["res"] + (b["tabs"] - b["pack"]) + b["bwd_weights"]
                 + b["pack"] + b["weights"])
        return bound(moved, _level_work(e, u, D, True))
    moved = b["tabs"] + b["weights"] + rows * D * F32 + (b["res"] if residuals else 0)
    return bound(moved, _level_work(e, u, D, False))


def giant_bwd_bound(edge_slots: int, node_slots: int, e: int, u: int, rows: int, D: int,
                    T: int) -> dict:
    """Kernel 4 (``level_scan_giant_bwd.cu``): the backward and the forward
    it recomputes from hf."""
    b = _level_bytes(edge_slots, node_slots, D, T)
    moved = 2 * rows * D * F32 + b["tabs"] + b["weights"] + b["pack"] + b["weights"]
    return bound(moved, _level_work(e, u, D, True) + _level_work(e, u, D, False))


def step_bounds_ms(cfg: dict, phase: str, giant: bool, n: int, e: int, u: int) -> dict:
    """Least ms of the level and struct kernels of one step of ``n`` real
    nodes, ``e`` edges and ``u`` gates, from what the data needs: a train
    step runs the forwards with residuals (the giant route's level forward
    without) and both backwards; an eval step the forwards alone."""
    D, T, R = cfg["dim_hidden"], cfg["num_experts"], cfg["s_rounds"]
    train = phase == "train"
    level = level_bound(e, u, e, u, n, D, T, residuals=train and not giant)["bound_ms"]
    struct = struct_bound(n, e, e, D, R, residuals=train)["bound_ms"]
    if train:
        level += (giant_bwd_bound(e, u, e, u, n, D, T) if giant
                  else level_bound(e, u, e, u, n, D, T, True, backward=True))["bound_ms"]
        struct += struct_bound(n, e, e, D, R, True, backward=True)["bound_ms"]
    return {"level": level, "struct": struct}
