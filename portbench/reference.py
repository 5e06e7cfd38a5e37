"""The plain reference of the benchmark's training cells: DG_AE written out in
plain PyTorch, float32 with TF32 off, from the model's description (the
reference repository's ``dg_ae_model_*.py`` and ``trainer.py:131-174``),
with no kernel, cache, padding or batching of the program under test.

It imports nothing of the program. It reads the weights in their published
tree (the checkpoints' layout: matrices stored [in, out], the per-gate-type
experts stacked along a T axis; ``weight_tree``) and works out again what
the program derives from the circuits: the levels, each step's circuits
(the trainer's documented shuffle), and the padded sizes and node order
that decide which random draw lands on which node or edge (``StepLayout``).

The model, per step of ``bs`` circuits joined into one graph:

  * struct towers (source and target, one LayerNorm each): per round
    msg = (sum of the in-neighbours' states) W + deg_in b, GRU(msg | x,
    state), LayerNorm; then the same over reversed edges; x = one_hot(gate
    == 1) (the reference's input quirk), state starts at 1;
  * hs = [s | t] W_hs + b;
  * level recurrence over the DAG's levels, a node's expert by its gate
    type: per in-edge q = [hs | hf](dst) W_q + b_q, k and v likewise of the
    source, score = q . a_q + k . a_k + b_a, softmax over the node's
    in-edges, msg = sum score * v, hf(node) = GRU_e(msg, hf(node));
  * losses: recon = mean softplus(-s(u) . t(v)) over the edges plus mean
    softplus(s(a) . t(b)) over as many sampled non-edges (both clipped at
    -log 1e-15), (s | t) = hs W_dec + b; prob = L1(clamp(MLP(hf), 0, 1),
    prob) with the readout's BatchNorm over the step's nodes and dropout
    0.2; func = L1(z(1 - cos(hf(a), hf(b))), z(tt_dis)) with unbiased
    z-scores; loss = w . (recon, prob, func);
  * backward by autograd, Adam (betas 0.9, 0.999, eps 1e-8).

Under data parallelism each rank's shard takes its own draws, and the
gradients, the readout's running statistics and the metrics are the mean
over the ranks before one Adam step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .circuits import GATES

LOG_EPS = -math.log(1e-15)
BN_EPS, BN_MOMENTUM, P_DROP = 1e-5, 0.1, 0.2
LN_EPS = 1e-5
COS_EPS = 1e-8
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
BLOCK_ROWS = 128          # the program pads a batch's node count to a multiple of this
FOLD_MUL = 0x9E3779B97F4A7C15


@contextlib.contextmanager
def fp32():
    """TF32 off for the products, the flags restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------- weights
def weight_shapes(cfg: dict) -> list:
    """(path, shape, init) of every trainable leaf in the published tree, in
    order; init is a uniform bound, or "ones" / "zeros"."""
    D, F_, T, M = cfg["dim_hidden"], cfg["dim_feature"], len(GATES[cfg["modality"]]), cfg["dim_mlp"]
    out = []

    def lin(path, i, o):
        b = 1.0 / math.sqrt(i)
        out.extend([(path + ("w",), (i, o), b), (path + ("b",), (o,), b)])

    def gru(path, i, h):
        b = 1.0 / math.sqrt(h)
        out.extend([(path + ("w_ih",), (i, 3 * h), b), (path + ("w_hh",), (h, 3 * h), b),
                    (path + ("b_ih",), (3 * h,), b), (path + ("b_hh",), (3 * h,), b)])

    for tower in ("source", "target"):
        p = ("struct", tower)
        lin(p + ("aggr",), D, D)
        gru(p + ("update",), D + F_, D)
        lin(p + ("aggr_r",), D, D)
        gru(p + ("update_r",), D + F_, D)
        if cfg["layernorm"]:
            out.extend([(p + ("ln", "w"), (D,), "ones"), (p + ("ln", "b"), (D,), "zeros")])
    lin(("hs_linear",), 2 * D, D)
    lin(("hs_decompose",), D, 2 * D)
    ba, bg = 1.0 / math.sqrt(2 * D), 1.0 / math.sqrt(D)
    for name, shape, b in (("wq", (2 * D, T * D), ba), ("bq", (T, D), ba),
                           ("wk", (2 * D, T * D), ba), ("bk", (T, D), ba),
                           ("wv", (2 * D, T * D), ba), ("bv", (T, D), ba),
                           ("wa_q", (T, D), ba), ("wa_k", (T, D), ba), ("ba", (T,), ba),
                           ("w_ih", (D, T * 3 * D), bg), ("w_hh", (D, T * 3 * D), bg),
                           ("b_ih", (T, 3 * D), bg), ("b_hh", (T, 3 * D), bg)):
        out.append((("experts", name), shape, b))
    dims = [D, M, M, 1]
    for i in range(3):
        lin(("readout_prob", "layers", i), dims[i], dims[i + 1])
    for i in range(2):
        out.extend([(("readout_prob", "bn", i, "w"), (M,), "ones"),
                    (("readout_prob", "bn", i, "b"), (M,), "zeros")])
    return out


def _put(tree, path, value):
    """Set tree[path] = value, making dicts for str keys and lists for int
    keys (filled in order) on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        child = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            if key == len(node):
                node.append(child)
        elif key not in node:
            node[key] = child
        node = node[key]
    if isinstance(node, list):
        node.append(value)
    else:
        node[path[-1]] = value


def weight_tree(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, state): every weight drawn uniform in its layer's default
    init bound from ONE draw of a generator on ``device`` seeded ``seed``;
    LayerNorm and BatchNorm scales 1, shifts 0; the readout's running mean
    0 and variance 1. Each leaf is a tensor of its own."""
    spec = weight_shapes(cfg)
    total = sum(math.prod(s) for _, s, b in spec if not isinstance(b, str))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    params: dict = {}
    at = 0
    for path, shape, b in spec:
        if b == "ones":
            leaf = torch.ones(shape, device=device)
        elif b == "zeros":
            leaf = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            leaf = (flat[at:at + n] * b).reshape(shape).clone()
            at += n
        _put(params, path, leaf)
    return params, initial_state(cfg, device)


def initial_state(cfg: dict, device) -> dict:
    """The readout's running statistics before the first step."""
    M = cfg["dim_mlp"]
    return {"readout_prob": {"bn": [{"mean": torch.zeros(M, device=device),
                                     "var": torch.ones(M, device=device)} for _ in range(2)]}}


def leaves(tree, prefix="") -> list:
    """(name, tensor) of a tree, dict keys sorted (the optimizer's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------- layout
def levelize(edge_index: np.ndarray, n: int) -> np.ndarray:
    """Longest-path level of every node (sources 0), by frontier propagation."""
    level = np.zeros(n, np.int64)
    src, dst = edge_index
    indeg = np.bincount(dst, minlength=n)
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(s_sorted, minlength=n))])
    frontier = np.flatnonzero(indeg == 0)
    left = indeg.copy()
    while frontier.size:
        counts = ptr[frontier + 1] - ptr[frontier]
        idx = np.repeat(ptr[frontier], counts) + (np.arange(counts.sum())
                                                 - np.repeat(np.cumsum(counts) - counts, counts))
        child = d_sorted[idx]
        np.maximum.at(level, child, np.repeat(level[frontier], counts) + 1)
        np.subtract.at(left, child, 1)
        frontier = np.unique(child[left[child] == 0])
    if (left > 0).any():
        raise ValueError("levelize: the graph has a cycle")
    return level


def bucket(x: int, minimum: int = 8) -> int:
    """The program's padded size of an extent: the smallest m * 2^e >= x
    with m in {4, 5, 6, 7, 8} (its batch dims, documented in
    ``data/batching.bucket``)."""
    if x <= minimum:
        return minimum
    e = max(0, (x - 1).bit_length() - 3)
    return next(m << e for m in (4, 5, 6, 7, 8) if (m << e) >= x)


def padded_nodes(n: int) -> int:
    return -(-bucket(n + 1) // BLOCK_ROWS) * BLOCK_ROWS


@dataclasses.dataclass
class StepLayout:
    """One shard's circuits joined into one graph, in circuit order, with
    what the reference needs of the program's layout: ``perm`` maps the
    program's level-major node numbering (a stable sort by level) to these
    rows, and the padded node and edge counts size the draws."""
    gate: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    level: np.ndarray
    prob: torch.Tensor
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    tt_dis: torch.Tensor
    perm: torch.Tensor
    n_pad: int = 0
    e_pad: int = 0

    @property
    def n(self) -> int:
        return int(self.gate.shape[0])

    @property
    def e(self) -> int:
        return int(self.src.shape[0])


def join(circuits: list, device) -> StepLayout:
    off = np.concatenate([[0], np.cumsum([c.num_nodes for c in circuits])])
    edge = np.concatenate([c.edge_index + o for c, o in zip(circuits, off)], axis=1)
    pairs = np.concatenate([c.tt_pair_index + o for c, o in zip(circuits, off)], axis=1)
    level = np.concatenate([levelize(c.edge_index, c.num_nodes) for c in circuits])
    t = lambda a, dt=torch.int64: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    return StepLayout(
        gate=t(np.concatenate([c.gate for c in circuits])), src=t(edge[0]), dst=t(edge[1]),
        level=level, prob=t(np.concatenate([c.prob for c in circuits]), torch.float32),
        pair_a=t(pairs[0]), pair_b=t(pairs[1]),
        tt_dis=t(np.concatenate([c.tt_dis for c in circuits]), torch.float32),
        perm=t(np.argsort(level, kind="stable")))


def epoch_shards(n_entries: int, seed: int, bs: int, world: int) -> np.ndarray:
    """The first epoch's train shards [steps, world, bs] of entry ids: the
    trainer's documented shuffle (``default_rng(seed + 2)``, one
    permutation per phase, drop_last), step s's rank r shard the (s * world
    + r)-th ``bs`` of it."""
    idx = np.arange(n_entries)
    np.random.default_rng(seed + 2).shuffle(idx)
    steps = n_entries // (bs * world)
    return idx[:steps * world * bs].reshape(steps, world, bs)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The draws of rank ``rank``: the trainer's generator is seeded seed + 1
    on its device; a rank past 0 folds the rank in (the program's
    documented stream per rank)."""
    base = seed + 1
    s = base if rank == 0 else (base + rank * FOLD_MUL) % (1 << 63)
    return torch.Generator(device=device).manual_seed(s)


def draws(gen: torch.Generator, lay: StepLayout, train: bool, dim_mlp: int) -> dict:
    """One step's random draws in the program's order and sizes: two uniform
    vectors of the padded edge count (the negatives), then in train mode one
    uniform [padded nodes, dim_mlp] block per hidden layer (the dropout),
    mapped onto this layout's rows."""
    dev = lay.gate.device
    u1 = torch.rand(lay.e_pad, generator=gen, device=gen.device)
    u2 = torch.rand(lay.e_pad, generator=gen, device=gen.device)
    n = torch.tensor(float(max(lay.n, 2)), dtype=torch.float32, device=gen.device)
    src = (u1 * n).to(torch.int32)
    dst = (src + 1 + (u2 * (n - 1)).to(torch.int32)) % n.to(torch.int32)
    out = {"neg_src": lay.perm[src[:lay.e].long().to(dev)],
           "neg_dst": lay.perm[dst[:lay.e].long().to(dev)]}
    if train:
        keep = []
        for _ in range(2):
            k = torch.rand((lay.n_pad, dim_mlp), generator=gen, device=gen.device) < 1.0 - P_DROP
            rows = torch.empty((lay.n, dim_mlp), dtype=torch.bool, device=dev)
            rows[lay.perm] = k[:lay.n].to(dev)
            keep.append(rows)
        out["keep"] = keep
    return out


# ---------------------------------------------------------------- model
def gru(p: dict, x, h):
    gi = x @ p["w_ih"] + p["b_ih"]
    gh = h @ p["w_hh"] + p["b_hh"]
    ir, iz, i_n = gi.chunk(3, -1)
    hr, hz, h_n = gh.chunk(3, -1)
    r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
    return (1 - z) * torch.tanh(i_n + r * h_n) + z * h


def layernorm(p, x):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p["w"] + p["b"]


def tower(p: dict, x, src, dst, rounds: int, use_ln: bool):
    n, D = x.shape[0], p["aggr"]["w"].shape[0]
    ones = torch.ones(src.shape[0], device=x.device)
    deg_in = torch.zeros(n, device=x.device).index_add_(0, dst, ones)[:, None]
    deg_out = torch.zeros(n, device=x.device).index_add_(0, src, ones)[:, None]
    state = torch.ones((n, D), device=x.device)
    for _ in range(rounds):
        for a, g, s, d, deg in (("aggr", "update", src, dst, deg_in),
                                ("aggr_r", "update_r", dst, src, deg_out)):
            nbr = torch.zeros_like(state).index_add(0, d, state[s])
            msg = nbr @ p[a]["w"] + deg * p[a]["b"]
            state = gru(p[g], torch.cat([msg, x], -1), state)
            if use_ln:
                state = layernorm(p["ln"], state)
    return state


def encode(w: dict, lay: StepLayout, cfg: dict):
    """(hs, hf) [n, D] in the layout's row order."""
    D, T = cfg["dim_hidden"], len(GATES[cfg["modality"]])
    x = F.one_hot((lay.gate == 1).long(), cfg["dim_feature"]).float()
    s = tower(w["struct"]["source"], x, lay.src, lay.dst, cfg["s_rounds"], cfg["layernorm"])
    t = tower(w["struct"]["target"], x, lay.src, lay.dst, cfg["t_rounds"], cfg["layernorm"])
    hs = torch.cat([s, t], -1) @ w["hs_linear"]["w"] + w["hs_linear"]["b"]
    ex = w["experts"]
    table = torch.full((8,), -1, dtype=torch.int64, device=hs.device)
    table[list(GATES[cfg["modality"]])] = torch.arange(T, device=hs.device)
    expert = table[lay.gate]
    hf = torch.zeros_like(hs)
    lv = torch.as_tensor(lay.level, device=hs.device)
    e_lv = lv[lay.dst]
    order = torch.argsort(e_lv, stable=True)
    e_counts = torch.bincount(e_lv, minlength=int(lay.level.max()) + 1).tolist()
    n_counts = np.bincount(lay.level)
    n_order = torch.as_tensor(np.argsort(lay.level, kind="stable"), device=hs.device)
    slot = torch.zeros(lay.n, dtype=torch.int64, device=hs.device)
    e_at = np.concatenate([[0], np.cumsum(e_counts)])
    n_at = np.concatenate([[0], np.cumsum(n_counts)])
    for level in range(1, len(n_counts)):
        nodes = n_order[n_at[level]:n_at[level + 1]]
        nodes = nodes[expert[nodes] >= 0]
        if nodes.numel() == 0:
            continue
        edges = order[e_at[level]:e_at[level + 1]]
        src, dst = lay.src[edges], lay.dst[edges]
        slot[nodes] = torch.arange(nodes.numel(), device=hs.device)
        keep = expert[dst] >= 0
        src, dst = src[keep], dst[keep]
        ed, en = expert[dst], expert[nodes]
        x_src = torch.cat([hs[src], hf[src]], -1)
        x_dst = torch.cat([hs[dst], hf[dst]], -1)
        pick = lambda m, e: m.view(m.shape[0], T, -1)[torch.arange(m.shape[0]), e]
        q = pick(x_dst @ ex["wq"], ed) + ex["bq"][ed]
        k = pick(x_src @ ex["wk"], ed) + ex["bk"][ed]
        v = pick(x_src @ ex["wv"], ed) + ex["bv"][ed]
        score = (q * ex["wa_q"][ed]).sum(-1) + (k * ex["wa_k"][ed]).sum(-1) + ex["ba"][ed]
        d_slot = slot[dst]
        m = torch.full((nodes.numel(),), -torch.inf, device=hs.device).scatter_reduce(
            0, d_slot, score.detach(), "amax", include_self=True)
        ex_s = torch.exp(score - m[d_slot])
        den = torch.zeros(nodes.numel(), device=hs.device).index_add(0, d_slot, ex_s)
        alpha = ex_s / (den[d_slot] + 1e-16)
        msg = torch.zeros((nodes.numel(), D), device=hs.device).index_add(0, d_slot,
                                                                        alpha[:, None] * v)
        hf = hf.index_put((nodes,), _expert_gru(ex, msg, hf[nodes], en, T))
    return hs, hf


def _expert_gru(ex: dict, msg, h, e, T: int):
    rows = torch.arange(msg.shape[0], device=msg.device)
    gi = (msg @ ex["w_ih"]).view(-1, T, ex["b_ih"].shape[1])[rows, e] + ex["b_ih"][e]
    gh = (h @ ex["w_hh"]).view(-1, T, ex["b_hh"].shape[1])[rows, e] + ex["b_hh"][e]
    ir, iz, i_n = gi.chunk(3, -1)
    hr, hz, h_n = gh.chunk(3, -1)
    r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
    return (1 - z) * torch.tanh(i_n + r * h_n) + z * h


def readout(w: dict, state: dict, hf, keep, train: bool):
    """The probability MLP; returns (out [n, 1], new running state)."""
    x, new = hf, []
    for i in range(2):
        lyr, bn, st = w["readout_prob"]["layers"][i], w["readout_prob"]["bn"][i], \
            state["readout_prob"]["bn"][i]
        x = x @ lyr["w"] + lyr["b"]
        if train:
            n = x.shape[0]
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
            new.append({"mean": ((1 - BN_MOMENTUM) * st["mean"] + BN_MOMENTUM * mean).detach(),
                        "var": ((1 - BN_MOMENTUM) * st["var"]
                                + BN_MOMENTUM * var * n / (n - 1)).detach()})
        else:
            mean, var = st["mean"], st["var"]
            new.append(st)
        x = torch.relu((x - mean) / torch.sqrt(var + BN_EPS) * bn["w"] + bn["b"])
        if train:
            x = torch.where(keep[i], x / (1 - P_DROP), 0.0)
    last = w["readout_prob"]["layers"][2]
    return x @ last["w"] + last["b"], {"readout_prob": {"bn": new}}


def zscore(x):
    return (x - x.mean()) / x.std()


def losses(w: dict, state: dict, lay: StepLayout, hs, hf, d: dict, train: bool):
    """(recon, prob, func) and the new running state."""
    st = hs @ w["hs_decompose"]["w"] + w["hs_decompose"]["b"]
    s, t = st.chunk(2, -1)
    pos = (s[lay.src] * t[lay.dst]).sum(-1)
    neg = (s[d["neg_src"]] * t[d["neg_dst"]]).sum(-1)
    recon = F.softplus(-pos).clamp(max=LOG_EPS).mean() + F.softplus(neg).clamp(max=LOG_EPS).mean()
    out, new_state = readout(w, state, hf, d.get("keep"), train)
    prob = (out[:, 0].clamp(0.0, 1.0) - lay.prob).abs().mean()
    a, b = hf[lay.pair_a], hf[lay.pair_b]
    na = a.square().sum(-1).sqrt().clamp(min=COS_EPS)
    nb = b.square().sum(-1).sqrt().clamp(min=COS_EPS)
    emb = 1.0 - (a * b).sum(-1) / (na * nb)
    func = (zscore(emb) - zscore(lay.tt_dis)).abs().mean()
    return torch.stack([recon, prob, func]), new_state


# ---------------------------------------------------------------- training
class Adam:
    """Adam with bias correction, one tensor at a time."""

    def __init__(self, params: list, lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.t += 1
        b1, b2 = ADAM_BETAS
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** self.t)).sqrt() + ADAM_EPS
            p.sub_(self.lr * (m / (1 - b1 ** self.t)) / denom)


def train_steps(cfg: dict, params: dict, state: dict, steps: list, gens: list, weights,
                lr: float) -> dict:
    """Follow ``len(steps)`` training steps from ``params`` / ``state`` (left
    unchanged). ``steps[s]`` holds one StepLayout per rank, ``gens[r]`` rank
    r's generator. Returns the losses [steps, 3] (the mean over ranks), the
    first and second steps' gradients (``grad``, ``grad2``) and the
    parameters after the last step, as {name: tensor}."""
    with fp32():
        w = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
        st = tree_map(lambda x: x.detach().clone(), state)
        names, flat = zip(*leaves(w))
        opt = Adam(list(flat), lr)
        out, grads_of = {"loss": []}, []
        wt = torch.tensor([float(x) for x in weights[:3]], device=flat[0].device)
        for ranks in steps:
            grads, loss, new_states = None, 0.0, []
            for r, lay in enumerate(ranks):
                d = draws(gens[r], lay, True, cfg["dim_mlp"])
                hs, hf = encode(w, lay, cfg)
                parts, new = losses(w, st, lay, hs, hf, d, True)
                g = torch.autograd.grad((wt * parts).sum(), flat, allow_unused=True)
                g = [torch.zeros_like(p) if x is None else x for p, x in zip(flat, g)]
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                loss = loss + parts.detach()
                new_states.append(new)
            world = len(ranks)
            grads = [x / world for x in grads]
            st = tree_map(lambda *xs: sum(xs) / world, *new_states)
            if len(grads_of) < 2:
                grads_of.append(dict(zip(names, [x.detach().clone() for x in grads])))
            opt.step(grads)
            out["loss"].append(loss / world)
        out["loss"] = torch.stack(out["loss"])
        out["grad"], out["grad2"] = grads_of[0], grads_of[-1]
        out["params"] = {n: p.detach().clone() for n, p in zip(names, flat)}
        return out
