"""Data and model parallelism across cards: the port's counterpart of
``__graft_entry__.dryrun_multichip``.

    python3 -m mgvae_tpu_torch.examples.dryrun_multichip [--nproc N] [--device cuda|cpu]
        [--phases kabcdefg] [--timeout SECONDS]

The launcher builds the CUDA kernels and the native host library once, runs
the single-card trainer epochs that phase (c) compares with, and then starts
N ranks of this module (``--worker``) with ``torchrun --standalone``: NCCL,
one card each (``cuda:{LOCAL_RANK}``). N defaults to
``torch.cuda.device_count()``; more ranks than cards raise, and nothing
falls back to gloo or to the CPU. ``--device cpu`` runs the same phases over
gloo at small sizes (D = 16, one round, circuits of a few dozen gates), for
the CPU tests. Each phase runs when N allows it (as the JAX function gates
on ``n_devices``), prints one line per result from rank 0, and checks that
every rank agrees; any failure or disagreement exits non-zero.

Phases, on the card at ``chip_smoke.py``'s model (MIG, DG_AE, D = 64,
s/t_rounds 4, layernorm, "highest"), random weights from seed 0:

  (k) kernels 7, 8, 1, 2, 5 and 6 on the last rank's card (``cuda:{N-1}``)
      against their plain versions: forward and backward called on the main
      thread, the backwards through autograd (its device thread), and both
      replayed from a captured CUDA graph (``kernel_checks``);
  (a) ``make_train_step(group=)`` at dp = N, one bs16 shard a rank with
      host-made draws, against the N shards' mean gradient through one Adam
      step on rank 0's card alone;
  (b) ``make_multi_step(group=)`` / ``make_multi_eval(group=)`` at K = 8:
      the replayed graph against the same steps run eagerly under the group
      (bit for bit), captures, launches per replayed step, the NCCL kernel a
      replay enqueues (``torch.profiler`` on rank 0); then the bs64 C = 2
      layout on the step route at K = 4;
  (c) the ``[trainer]`` configuration through ``cli.main`` under the launch
      (``--distributed``, 176 circuits a rank), its files and epoch lines
      and ``--resume``; trainer epochs grouped, per step and split against
      the same epochs on one card; rank 0's busy share;
  (d) one ``BalancerTrainer`` epoch at dp = N;
  (e) ``make_sharded_train_step`` on the (dp, mp) meshes (N / 2, 2) and
      (1, N), both routes, bs16, against the single-card step on rank 0;
  (f) the giant graph (``layered_circuit(default_rng(0), "mig", width=512,
      depth=200, num_tt_pairs=512)``) at mp = N on the dst-complete route
      against the single-card giant route: forward, gradients, ms a step,
      peak memory per card, the profile of rank 0;
  (g) the same circuit at depth 1000: one sharded step and one single-card
      step, ms and peak per card.

Work files go to ``exp/dryrun_multichip/`` under the checkout (``--out``),
removed at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 0
LR = 1e-4                 # Adam: (a), (b), the trainers
SGD_LR = 0.1              # (e)'s one SGD step, as tests/test_torch_sharded.py
WEIGHTS = [1.0, 4.0, 4.0, 0.0]
# (e)-(g) leave the prob term out: the sharded struct towers sum their
# neighbours in another order (index_add_), which moves the prob readout's
# ReLU units near 0 across their kink (chip_smoke.py's SMOOTH_WEIGHTS)
SMOOTH_WEIGHTS = [1.0, 0.0, 4.0, 0.0]
# leaves whose gradient the attention's softmax cancels: rounding noise that
# Adam scales to up to lr a step on either side (tests/test_torch_dp.py)
SOFTMAX_INVARIANT = ("wq", "bq", "wa_q", "ba", "bk")
# the row gathers' backward launches of a train step on the card (ops/gather:
# two a call; level_statics' four calls, the pack's, the positive edges' two)
GATHER_BWD_LAUNCHES = 2 * 7
KERNEL_TOL = 1e-4         # kernel vs plain: fp32, TF32 off, sums in another order
GRAD_TOL, GRAD_FLOOR = 1e-4, 2e-2   # a gradient leaf against its own scale
TRAINER_EPOCH_LINE = (r"^(train|val)\| Epoch: 0/1 \|Recon: \d+\.\d{4} \|ACC: \d+\.\d{2} "
                      r"\|Prob: \d+\.\d{4} \|Func: \d+\.\d{4}\|Net: \d+\.\d{2}s$")
CHECKPOINTS = ("stage_1.pth", "stage_2.pth", "stage_3.pth", "model_0.pth", "model_last.pth")
# the device kernels of rows 5 and 6 (csrc/level_step.cu, level_step_bwd.cu)
STEP_KERNELS = ("level_fwd_kernel", "level_bwd_slot_kernel", "level_bwd_source_kernel",
                "expert_gemm_kernel", "weight_reduce_kernel")


@dataclasses.dataclass(frozen=True)
class Sizes:
    dim: int
    rounds: int
    bs: int                  # graphs per shard
    inputs: int
    gates: int
    tt_pairs: int
    K: int                   # (b)'s steps per call
    route_K: int             # (b)'s step-route call
    route_bs: int
    circuits: int            # (c)'s synthetic circuits per rank
    trainer_K: int
    giant: tuple             # (width, depth, tt pairs)
    past_depth: int          # (g)
    timed: int               # (f)'s timed steps per turn


SIZES = {
    "cuda": Sizes(dim=64, rounds=4, bs=16, inputs=16, gates=264, tt_pairs=64, K=8, route_K=4,
                  route_bs=64, circuits=176, trainer_K=8, giant=(512, 200, 512),
                  past_depth=1000, timed=5),
    "cpu": Sizes(dim=16, rounds=1, bs=4, inputs=4, gates=24, tt_pairs=16, K=3, route_K=2,
                 route_bs=8, circuits=24, trainer_K=2, giant=(16, 12, 16), past_depth=40,
                 timed=2),
}


def log(*a):
    print(*a, flush=True)


def model_cfg(s: Sizes):
    from ..models.dg_ae import DGConfig

    return DGConfig(modality="mig", dim_hidden=s.dim, s_rounds=s.rounds, t_rounds=s.rounds,
                    layernorm=True, matmul_precision="highest")


def circuits(s: Sizes, seed: int, n: int) -> list:
    from ..data.synthetic import random_circuit

    rng = np.random.default_rng(seed)
    return [random_circuit(rng, "mig", num_inputs=s.inputs, num_gates=s.gates,
                           num_tt_pairs=s.tt_pairs) for _ in range(n)]


def common_dims(shards: list, mp: int = 1) -> dict:
    from ..data.batching import natural_dims

    dl = [natural_dims(s, mp=mp) for s in shards]
    return {k: max(d[k] for d in dl) for k in dl[0]}


def host_draws(batch: dict, cfg, seed: int):
    """Negatives over the batch's valid rows and dropout keep masks, made on
    the CPU from ``seed`` (``chip_smoke.par_draws``' recipe)."""
    from ..train.losses import to_valid_runs

    g = torch.Generator().manual_seed(seed)
    n_real, e_pad, n_pad = (int(batch["n_nodes"]), batch["edge_src"].shape[0],
                            batch["gate"].shape[0])
    neg = tuple(to_valid_runs(t.to(torch.int32), batch)
                for t in torch.randint(0, n_real, (2, e_pad), generator=g))
    return neg, [torch.rand(n_pad, cfg.dim_mlp, generator=g) < 0.8 for _ in range(2)]


def on(draws, dev):
    neg, keep = draws
    return tuple(t.to(dev) for t in neg), [k.to(dev) for k in keep]


def named_leaves(tree, prefix=""):
    """The leaves' paths, in ``train.step.param_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}/{i}")]
    return [prefix]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def counts() -> dict:
    """Every kernel's launch count and the collectives', by name."""
    from ..train import step as step_mod

    return {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": v
            for (m, n), v in step_mod.launch_counts().items()}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def leaf_ratio(got, want) -> float:
    """The worst leaf's max |d| over GRAD_TOL times its own scale, floored at
    GRAD_FLOOR of the largest entry over all leaves (phase 7 of
    ``chip_smoke.py``)."""
    pairs = [(a, c) for a, c in zip(got, want, strict=True) if c is not None]
    if any((a is None) != (c is None) for a, c in zip(got, want)):
        return math.inf
    top = max(float(c.abs().max()) for _, c in pairs)
    worst = 0.0
    for a, c in pairs:
        a, c = a.float(), c.float()
        if not bool(a.isfinite().all()):
            return math.inf
        own = float(c.abs().max())
        worst = max(worst, float((a - c).abs().max()) / (GRAD_TOL * max(own, GRAD_FLOOR * top)))
    return worst


def busy_union(events) -> float:
    """Milliseconds in which at least one of the device events ran."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, -math.inf
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


# ---------------------------------------------------------------------------
# (k): the kernels against their plain versions on one card


def kernel_checks(dev, s: Sizes) -> list:
    """Kernels 7, 8, 1, 2, 5 and 6 on the card ``dev`` against their plain
    versions, on a bs16 MIG batch (a mid level of it for kernels 5 and 6):
    each kernel's forward with residuals and its backward called on this
    thread ("main"); the backwards through autograd, whose device thread
    runs them ("autograd"); and forward and backward captured in one CUDA
    graph and replayed ("graph"). Returns (kernel, mode, worst ratio to the
    bound, detail) rows: outputs within KERNEL_TOL, a backward's outputs
    within KERNEL_TOL * max(scale, 1); the autograd rows bit for bit the
    main rows' kernels (ratio inf where they differ or ran on this
    thread). Runs with ``dev`` current, as a caller on that card would."""
    from ..data.batching import collate
    from ..models import dg_ae
    from ..ops import level_kernel as lk
    from ..ops import struct_kernel as sk

    cfg = model_cfg(s)
    R, ln = s.rounds, True
    rows = []

    def within(got, want, backward: bool) -> float:
        worst = 0.0
        for a, c in zip(got, want, strict=True):
            bound = KERNEL_TOL * (max(float(c.abs().max()), 1.0) if backward else 1.0)
            worst = max(worst, float((a.float() - c.float()).abs().max()) / bound)
        return worst

    main_thread = threading.get_ident()
    with torch.cuda.device(dev):
        params, _ = dg_ae.init_params(cfg, seed=SEED + 1, device=dev)
        batch = collate(circuits(s, SEED + 50, s.bs))
        b = dg_ae.batch_to_device(batch, dev)
        n_lv = dg_ae.num_levels(batch)
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        with torch.no_grad():
            x = dg_ae.struct_input(b["gate"], cfg)
            sargs = sk.struct_inputs(params["struct"], x, b, ln)
            tables = sk.struct_tables(b)
            hs = dg_ae.struct_hs(params, b, cfg)
            largs = dg_ae.level_scan_inputs(params, b, cfg, hs)
        N = hs.shape[0]
        hf_full = lk.level_scan_reference(*largs, num_nodes=N, num_levels=n_lv)
        lv = n_lv // 2
        step_args = (hf_full, *(largs[i][lv] for i in (0, 1, 2, 3, 5, 6)), *largs[7:])
        np_ = largs[4].shape[1]
        s_ref = sk.struct_towers_reference(*sargs, tables, R, ln, with_residuals=True)
        dstate = torch.randn(s_ref[0].shape, device=dev, generator=gen)
        ghf = torch.randn((N, s.dim), device=dev, generator=gen)
        gstep = torch.randn((np_, s.dim), device=dev, generator=gen)

        # each kernel pair by its C entries: the forward with residuals (those
        # of the level kernels on the rows they write), the backward on them
        def struct_pair():
            st, res = sk._forward_cuda(sargs, tables, R, ln, residuals=True)
            return (st, res), sk._backward_cuda(dstate, res, sargs[1], sargs[2], sargs[4],
                                                tables, R, ln)

        def level_pair():
            hf, re, rn = lk._forward_cuda(largs, N, n_lv, residuals=True)
            re, rn = written_rows(largs[2], largs[3], largs[5], n_lv, re, rn)
            return (hf, re, rn), lk._backward_cuda(ghf, re, rn, largs, n_lv)

        def step_pair():
            h, re, rn = lk._step_forward_cuda(step_args, residuals=True)
            re, rn = written_rows(step_args[3], step_args[4], step_args[5], 1, re, rn)
            return (h, re, rn), lk._step_backward_cuda(gstep, re, rn, step_args[1:], N)

        # their plain versions: (forward outputs, backward outputs on the
        # kernels' residuals)
        def struct_plain(fwd):
            return (s_ref,
                    sk.struct_towers_bwd_reference(dstate, fwd[1], sargs[1], sargs[2],
                                                   sargs[4], tables, R, ln))

        def level_plain(fwd):
            bargs = (*largs[:9], largs[10], largs[11])
            return (lk.level_scan_reference(*largs, num_nodes=N, num_levels=n_lv,
                                            with_residuals=True),
                    lk.level_scan_bwd_reference(ghf, fwd[1], fwd[2], *bargs, num_levels=n_lv))

        def step_plain(fwd):
            bargs = (*step_args[1:9], step_args[10], step_args[11])
            return (lk.level_step_reference(*step_args, with_residuals=True),
                    lk.level_step_bwd_reference(gstep, fwd[1], fwd[2], *bargs, num_nodes=N))

        cases = (("struct_towers (7) / struct_towers_bwd (8)", struct_pair, struct_plain),
                 ("level_scan (1) / level_scan_bwd (2)", level_pair, level_plain),
                 ("level_step (5) / level_step_bwd (6)", step_pair, step_plain))

        def held(plain, fwd, bwd) -> float:
            want_f, want_b = plain(fwd)
            return max(within(fwd, want_f, False), within(bwd, want_b, True))

        direct = []
        for name, pair, plain in cases:
            fwd, bwd = pair()
            torch.cuda.synchronize(dev)
            rows.append((name, "main", held(plain, fwd, bwd), ""))
            direct.append(bwd)
        # the same launches captured in one CUDA graph and replayed: the
        # graph's outputs against the plain versions. The capture stream is
        # dev's own: torch.cuda.graph's default one is made once, on the
        # device current at its first use, and a capture there would leave
        # dev's launches outside the graph
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
            captured = [pair() for _, pair, _ in cases]
        graph.replay()
        torch.cuda.synchronize(dev)
        for (name, _, plain), (fwd, bwd) in zip(cases, captured):
            rows.append((name, "graph", held(plain, fwd, bwd), ""))
        del graph, captured
        # the backwards through autograd, on inputs cloned from leaves so that
        # a hook on each clone sees the thread that computed its gradient
        threads = []

        def where(_):
            threads.append(threading.get_ident())

        def through_autograd(fn, args, floats, cot):
            base = [a.detach().clone() for a in args]
            for i in floats:
                base[i].requires_grad_(True)
            t = list(base)
            for i in floats:
                t[i] = base[i].clone()
                t[i].register_hook(where)
            return torch.autograd.grad(fn(t), [base[i] for i in floats], cot)

        auto = (
            through_autograd(lambda t: sk.struct_core(*t, tables, R, ln), sargs,
                             range(len(sargs)), dstate),
            through_autograd(lambda t: lk.level_scan(*t, num_nodes=N, num_levels=n_lv), largs,
                             lk.FLOAT_ARGS, ghf),
            through_autograd(lambda t: lk.level_step(*t), step_args, lk.STEP_FLOAT_ARGS,
                             gstep))
        torch.cuda.synchronize(dev)
        off_main = bool(threads) and main_thread not in threads
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, d_hf = direct[2]
        direct[2] = (d_hf, d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak)   # the inputs' order
        for (name, _, _), a, d in zip(cases, auto, direct):
            same = len(a) == len(d) and all(torch.equal(x, y) for x, y in zip(a, d))
            rows.append((name, "autograd", 0.0 if same and off_main else math.inf,
                         f"(bit for bit the main launches' backward {same}, on autograd's "
                         f"device thread {off_main})"))
    return rows


def written_rows(dslot, evalid, upd, n_lv, res_e, res_n):
    """The residuals with every row the kernels leave unwritten set to 0, as
    the plain versions have them."""
    from ..ops.level_kernel import live_rows

    e_live, s_live = live_rows(dslot, evalid, upd)
    if e_live.dim() == 2:
        e_live, s_live = e_live.clone(), s_live.clone()
        e_live[n_lv:], s_live[n_lv:] = False, False
    return (torch.where(e_live[..., None], res_e, 0.0),
            torch.where(s_live[..., None], res_n, 0.0))


# ---------------------------------------------------------------------------
# the ranks


class Rank:
    """One rank's view: its place, device, sizes and the group-wide helpers."""

    def __init__(self, device: str, out: str, ref: dict | None):
        import torch.distributed as dist

        from ..parallel import mesh as mesh_mod

        self.dist = dist
        self.card = device == "cuda"
        if self.card:
            if not torch.cuda.is_available():
                raise RuntimeError("dryrun_multichip --worker: no CUDA device")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
            os.environ["MGVAE_PLATFORM"] = "cpu"   # the CLI's device
        self.rank, self.world = mesh_mod.maybe_initialize_distributed(device, timeout=900)
        backend = dist.get_backend()
        if backend != ("nccl" if self.card else "gloo"):
            raise RuntimeError(f"dryrun_multichip: a {backend} group on {device}")
        self.dev = mesh_mod.local_device(device)
        self.s = SIZES[device]
        self.cfg = model_cfg(self.s)
        self.out = out
        self.ref = ref      # the launcher's single-card trainer epochs, for (c)
        self.group = dist.group.WORLD
        self.name = (f"{torch.cuda.get_device_name(self.dev)} (cuda:{self.dev.index})"
                     if self.card else "cpu")

    def sync(self):
        if self.card:
            torch.cuda.synchronize(self.dev)

    def gather(self, obj) -> list:
        out = [None] * self.world
        self.dist.all_gather_object(out, obj)
        return out

    def say(self, tag: str, line: str):
        if self.rank == 0:
            log(f"[multichip] ({tag}) {line}")

    def held(self, tag: str, ok: bool, what: str):
        """Every rank's verdict; raises on every rank when any failed."""
        oks = self.gather(bool(ok))
        self.say(tag, f"{what}: held on ranks {oks}")
        if not all(oks):
            raise RuntimeError(f"[multichip] ({tag}) {what}: failed on rank(s) "
                               f"{[r for r, x in enumerate(oks) if not x]}")

    def agree(self, tag: str, what: str, value) -> list:
        """Every rank's ``value`` must be equal."""
        got = self.gather(value)
        self.held(tag, all(v == got[0] for v in got), f"{what} equal on every rank")
        return got


def phase_k(r: Rank):
    """Kernels 7, 8, 1, 2, 5 and 6 on the last rank's card."""
    last = r.world - 1
    if not r.card:
        r.say("k", "no kernel on the CPU (the wrappers take their plain versions): skipped")
        return
    rows = kernel_checks(r.dev, r.s) if r.rank == last else None
    rows = r.gather(rows)[last]
    ok = all(x <= 1.0 for _, _, x, _ in rows)
    for name, mode, worst, detail in rows:
        r.say("k", f"{name} on cuda:{last} ({mode}): worst {worst:.3f} of the bound "
                   f"{detail}".rstrip())
    r.held("k", ok, f"kernels 7, 8, 1, 2, 5, 6 against their plain versions on cuda:{last}, "
                    "on the main thread, in autograd's device thread and replayed from a "
                    "CUDA graph")


def phase_a(r: Rank):
    """The data-parallel train step against the shards' mean on one card."""
    from ..data.batching import collate
    from ..models import dg_ae
    from ..ops.precision import matmul_precision
    from ..train import step as step_mod

    s, cfg, W = r.s, r.cfg, r.world
    every = circuits(s, SEED + 1, W * s.bs)
    shards = [every[j * s.bs:(j + 1) * s.bs] for j in range(W)]
    dims = common_dims(shards)
    batches = [collate(x, dims=dims) for x in shards]
    draws = [host_draws(b, cfg, SEED + 10 + j) for j, b in enumerate(batches)]

    params, state = dg_ae.init_params(cfg, seed=SEED + 3, device=r.dev)
    names = named_leaves(params)
    opt = step_mod.make_optimizer(params, LR)
    train_step, _ = step_mod.make_train_step(cfg, opt, group=r.group)
    neg, keep = on(draws[r.rank], r.dev)
    r.sync()
    before = counts()
    new_state, metrics = train_step(params, state, batches[r.rank], None, WEIGHTS,
                                    neg_edges=neg, drop_keep=keep)
    r.sync()
    got = delta(counts(), before)
    leaves = step_mod.param_leaves(params)
    flat = [t.detach() for t in leaves + step_mod.param_leaves(new_state)]
    r.agree("a", "params and BN state after the data-parallel step (digest)", digest(flat))
    r.agree("a", "metrics", {k: float(v) for k, v in metrics.items()})
    r.say("a", f"dp = {W}: launches of one step {got}")

    ok, line = True, ""
    if r.rank == 0:
        p1, s1 = dg_ae.init_params(cfg, seed=SEED + 3, device=r.dev)
        opt1 = step_mod.make_optimizer(p1, LR)
        l1 = step_mod.param_leaves(p1)
        sums, states, mets = None, [], []
        for j, b in enumerate(batches):
            opt1.zero_grad(set_to_none=True)
            n_j, k_j = on(draws[j], r.dev)
            with matmul_precision(cfg.matmul_precision):
                total, (ns, m) = step_mod.loss_and_metrics(p1, s1, b, None, WEIGHTS, cfg, True,
                                                           neg_edges=n_j, drop_keep=k_j)
                total.backward()
            g = [None if t.grad is None else t.grad.detach().clone() for t in l1]
            sums = g if sums is None else [None if a is None else a + c
                                           for a, c in zip(sums, g)]
            states.append(step_mod.param_leaves(s1 | ns))
            mets.append(m)
        for t, g in zip(l1, sums):
            t.grad = None if g is None else g / W
        opt1.step()
        want_state = [sum(x) / W for x in zip(*states)]
        worst_p, worst_s, worst_m = 0.0, 0.0, 0.0
        for name, a, c in zip(names, leaves, l1, strict=True):
            atol = 2 * 2 * LR if name.rsplit("/", 1)[-1] in SOFTMAX_INVARIANT else 1e-5
            worst_p = max(worst_p, float((a.detach() - c.detach()).abs().max()) / atol)
        for a, c in zip(step_mod.param_leaves(new_state), want_state, strict=True):
            worst_s = max(worst_s, float((a - c).abs().max()) / 1e-6)
        for k in metrics:
            want = float(sum(m[k] for m in mets)) / W
            worst_m = max(worst_m, abs(float(metrics[k]) - want) / (1e-6 + 1e-5 * abs(want)))
        ok = max(worst_p, worst_s, worst_m) <= 1.0
        line = (f"against the {W} shards' mean gradient through one Adam step on rank 0's "
                f"card alone (lr {LR}, weights {WEIGHTS}): params worst {worst_p:.3f} of atol "
                f"1e-5 (the softmax-invariant leaves {2 * 2 * LR:g}), BN state {worst_s:.3f} "
                f"of atol 1e-6, metrics {worst_m:.3f} of rtol 1e-5 / atol 1e-6")
    r.say("a", line)
    r.held("a", ok, f"the dp = {W} step against one card")


def ms_run(r: Rank, sb: dict, mode: str, calls: int) -> dict:
    """``calls`` K-step train calls under the group, each followed by a
    K-step eval call, from fixed params: ``mode`` "graph" (the first step
    eager, then the capture and replays) or "eager" (every step eager:
    ``CAPTURE_WARMUP`` raised). The call's rows, params, Adam's state, BN
    state and generator, the launches of each call, the captures."""
    from ..models import dg_ae
    from ..train import step as step_mod

    params, state = dg_ae.init_params(r.cfg, seed=SEED + 9, device=r.dev)
    opt = step_mod.make_optimizer(params, LR)
    gen = torch.Generator(device=r.dev).manual_seed(SEED + 9)
    multi = step_mod.make_multi_step(r.cfg, opt, group=r.group)
    multi_eval = step_mod.make_multi_eval(r.cfg, group=r.group)
    warm = step_mod.CAPTURE_WARMUP
    step_mod.CAPTURE_WARMUP = 10 ** 9 if mode == "eager" else warm
    rows, per_call = [], []
    try:
        for _ in range(calls):
            r.sync()
            c0 = counts()
            state, tr = multi(params, state, sb, gen, WEIGHTS)
            r.sync()
            c1 = counts()
            ev = multi_eval(params, state, sb, gen, WEIGHTS)
            r.sync()
            per_call.append((delta(c1, c0), delta(counts(), c1)))
            rows += [tr, ev]
    finally:
        step_mod.CAPTURE_WARMUP = warm
    adam = [t for p in step_mod.param_leaves(params) for t in opt.state[p].values()]
    return {"rows": torch.cat(rows), "gen": gen.get_state(),
            "tensors": [t.detach() for t in step_mod.param_leaves(params) + adam
                        + step_mod.param_leaves(state)],
            "per_call": per_call, "captures": (multi.captures, multi_eval.captures),
            "call": (multi, params, state, gen)}


def same_run(a: dict, b: dict) -> tuple:
    pairs = [(a["rows"], b["rows"])] + list(zip(a["tensors"], b["tensors"], strict=True))
    same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)
    worst = max(float((x.float() - y.float()).abs().max()) for x, y in pairs if x.numel())
    return same and torch.equal(a["gen"], b["gen"]), worst


def phase_b(r: Rank):
    """The K-step calls under the group: graph against eager, launches, the
    NCCL kernel of a replay; then the step route."""
    from ..data.batching import collate_shards
    from ..ops import level_kernel

    s, W = r.s, r.world
    mine = circuits(s, SEED + 20 + r.rank, s.K * s.bs)
    sb = collate_shards([mine[k * s.bs:(k + 1) * s.bs] for k in range(s.K)])
    g = ms_run(r, sb, "graph", 2)
    e = ms_run(r, sb, "eager", 2)
    same, worst = same_run(g, e)
    per_train = {k: v / s.K for k, v in g["per_call"][1][0].items()}
    per_eval = {k: v / s.K for k, v in g["per_call"][1][1].items()}
    R = s.rounds
    if r.card:
        want_t = {"struct_kernel.launches": 2 * R, "struct_kernel.bwd_launches": 4 * R + 1,
                  "level_kernel.launches": 1, "level_kernel.bwd_launches": 3,
                  "level_kernel.lists_launches": 1, "collectives.launches": 1,
                  "gather.bwd_launches": GATHER_BWD_LAUNCHES}
        want_e = {"struct_kernel.launches": 2 * R, "level_kernel.launches": 1,
                  "level_kernel.lists_launches": 1, "collectives.launches": 1}
        want_cap = (1, 1)
    else:
        want_t = want_e = {"collectives.launches": 1}
        want_cap = (0, 0)
    per_train.pop("level_kernel.levels_walked", None)
    per_train.pop("level_kernel.bwd_levels_walked", None)
    per_eval.pop("level_kernel.levels_walked", None)
    ok = same and g["captures"] == want_cap and per_train == want_t and per_eval == want_e
    r.say("b", f"make_multi_step / make_multi_eval(group=) at K = {s.K} over dp = {W} "
               f"(bs{s.bs} MIG shards of {s.gates} gates, two calls each): replayed graph "
               f"against the same steps run eagerly under the group bit for bit {same} (max "
               f"|d| {worst:.3e}); captures (train, eval) {g['captures']}; launches per "
               f"replayed train step {per_train}, eval step {per_eval}")
    r.held("b", ok, "graph = eager bit for bit, one capture per call, the launches per step")
    r.agree("b", "metric rows and params after the K-step calls (digest)",
            digest([g["rows"]] + g["tensors"]))
    # one more train call of replays under torch.profiler on rank 0
    multi, params, state, gen = g["call"]
    prof = None
    r.sync()
    if r.card and r.rank == 0:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            multi(params, state, sb, gen, WEIGHTS)
            r.sync()
    else:
        multi(params, state, sb, gen, WEIGHTS)
        r.sync()
    if prof is not None:
        on_card = device_events(prof)
        nccl = {}
        for ev in on_card:
            if "nccl" in ev.name.lower():
                n, t = nccl.get(ev.name, (0, 0.0))
                nccl[ev.name] = (n + 1, t + ev.time_range.elapsed_us() / 1e3)
        r.say("b", "under torch.profiler, one train call of replays on rank 0: the NCCL "
                   "kernels a replay enqueues, per step: "
                   + ("; ".join(f"{k} x{n / s.K:g}, {t / s.K:.4f} ms" for k, (n, t)
                                in nccl.items()) or "none")
                   + f"; device busy {busy_union(on_card) / s.K:.3f} ms a step; card {r.name}")
    del g, e

    # the bs64 C = 2 layout on the step route at K = 4
    mine = circuits(s, SEED + 24 + r.rank, s.route_K * s.route_bs)
    sb = collate_shards([mine[k * s.route_bs:(k + 1) * s.route_bs] for k in range(s.route_K)],
                        num_chunks=2)
    gate = level_kernel.KERNEL_MAX_NODES
    if not r.card:    # tiny chunks fit the fused kernel: the size gate lowered
        level_kernel.KERNEL_MAX_NODES = 64
    try:
        g = ms_run(r, sb, "graph", 1)
        e = ms_run(r, sb, "eager", 1)
    finally:
        level_kernel.KERNEL_MAX_NODES = gate
    same, worst = same_run(g, e)
    per = {k: v / s.route_K for k, v in g["per_call"][0][0].items()}
    route = per.get("level_kernel.step_bwd_launches", 0) > 0 if r.card else True
    ok = same and route and per.get("collectives.launches") == 1
    r.say("b", f"bs{s.route_bs} C=2 on the step route, one K = {s.route_K} train and eval call "
               f"under the group against its steps run eagerly: bit for bit {same} (max |d| "
               f"{worst:.3e}); captures {g['captures']}; launches per train step {per}")
    r.held("b", ok, "the step-route call: graph = eager, kernels 5 and 6 and one all-reduce a "
                    "step")


def trainer_argv(s: Sizes, n_circuits: int, save_dir: str, exp_id: str,
                 stage_epochs: str = "1,1,1", extra=()) -> list:
    """The [trainer] configuration of chip_smoke.py (the CLI's defaults on
    the card: D = 64, rounds 4)."""
    argv = ["--exp_id", exp_id, "--model", "DG_AE", "--type", "mig", "--batch_size",
            str(s.bs), "--layernorm", "--stage_epochs", stage_epochs, "--synthetic_circuits",
            str(n_circuits), "--matmul_precision", "highest", "--steps_per_call",
            str(s.trainer_K), "--save_dir", save_dir]
    if s.dim != 64 or s.rounds != 4:
        argv += ["--dim_hidden", str(s.dim), "--s_rounds", str(s.rounds), "--t_rounds",
                 str(s.rounds)]
    return argv + list(extra)


def trainer_epochs(s: Sizes, dev, root: str, n_circuits: int, distributed: bool,
                   kinds: tuple) -> dict:
    """New trainers of each kind in ``kinds`` (grouped at ``trainer_K``, per
    step, split into 2 groups), two epochs each (the first captures), on the
    CLI's synthetic data; ms per train step of each epoch; on the card one
    more epoch of the last trainer (grouped), under torch.profiler on the
    chief. Returns the ms, each trainer's meters and params (for the ranks'
    agreement) and the chief's profiled wall and busy ms."""
    from ..cli import load_dataset
    from ..config import get_parse_args
    from ..models import dg_ae
    from ..train import step as step_mod
    from ..train.trainer import Trainer

    args = get_parse_args(trainer_argv(s, n_circuits, root, "t"))
    train_ds, val_ds = load_dataset(args)
    cfg = model_cfg(s)
    out = {"ms": [], "meters": [], "digests": [], "steps": None}
    t = None
    for i, kind in enumerate(kinds):
        spc, split = {"grouped": (s.trainer_K, "auto"), "per_step": (1, "auto"),
                      "split": (s.trainer_K, 2)}[kind]
        p0, s0 = dg_ae.init_params(cfg, seed=SEED + 5, device=dev)
        t = Trainer(args, cfg, params=p0, state=s0, training_id=f"{kind}{i}", save_dir=root,
                    batch_size=s.bs, distributed=distributed, seed=SEED, steps_per_call=spc,
                    split=split, device=dev)
        t.set_training_args(rc_prob_func_weight=WEIGHTS[:3], lr=LR)
        if t.grouped != (spc > 1) or (t.group is not None) != distributed:
            raise RuntimeError(f"[multichip] (c) {kind}: {t.step_mode}, group {t.group}")
        ms, meters = [], []
        for _ in range(2):
            m = t.train(1, train_ds, val_ds)
            ms.append(m["train"]["time"] * 1e3)
            meters.append({ph: {k: v for k, v in m[ph].items() if k != "time"}
                           for ph in ("train", "val")})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["ms"].append((kind, ms))
        out["meters"].append((kind, meters))
        out["digests"].append((kind, digest(step_mod.param_leaves(t.params)
                                            + step_mod.param_leaves(t.state))))
        out["steps"] = len(train_ds) // (s.bs * t.num_devices)
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(dev)
        if t.is_chief:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                t.train(1, train_ds, [])
                torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
            out["profile"] = {"wall": wall, "busy": busy_union(device_events(prof))}
        else:
            t.train(1, train_ds, [])
            torch.cuda.synchronize(dev)
    return out


def phase_c(r: Rank):
    """The trainer under the launch: the CLI's files, epoch lines and
    --resume; grouped, per-step and split epochs; ms against one card."""
    from .. import cli
    from ..train import step as step_mod
    from ..train import trainer as trainer_mod

    s, W = r.s, r.world
    root = os.path.join(r.out, "c")
    n_circuits = s.circuits * W
    argv = trainer_argv(s, n_circuits, root, "dp", extra=["--distributed"])
    lines = []
    run_phase = trainer_mod.Trainer._run_phase

    def recorded(self, phase, ds, epoch, num_epoch, weights):
        meters, ran = run_phase(self, phase, ds, epoch, num_epoch, weights)
        lines.append(f"{phase}| Epoch: {epoch}/{num_epoch} |Recon: {meters['recon'].avg:.4f} "
                     f"|ACC: {meters['acc'].avg * 100:.2f} |Prob: {meters['prob'].avg:.4f} "
                     f"|Func: {meters['func'].avg:.4f}")
        return meters, ran

    trainer_mod.Trainer._run_phase = recorded
    try:
        r.dist.barrier()
        t0 = time.perf_counter()
        tr = cli.main(argv)
        r.sync()
        wall = time.perf_counter() - t0
        done = list(lines)
        del lines[:]
        resumed = cli.main(trainer_argv(s, n_circuits, root, "dp", stage_epochs="0,0,0",
                                        extra=["--distributed", "--resume"]))
    finally:
        trainer_mod.Trainer._run_phase = run_phase
    run_dir = os.path.join(root, "dp")
    r.say("c", f"cli.main({' '.join(argv)}) on {W} rank(s): {wall:.1f} s for 3 stages "
               f"({tr.step_mode}; {len(done)} phase epochs)")
    r.agree("c", "the epoch lines (every field but Net)", done)
    r.agree("c", "params and BN state after the 3 stages (digest)",
            digest(step_mod.param_leaves(tr.params) + step_mod.param_leaves(tr.state)))
    r.agree("c", "params after --resume (digest)", digest(step_mod.param_leaves(resumed.params)))
    r.dist.barrier()
    ok, line = True, ""
    if r.rank == 0:
        files = sorted(os.listdir(run_dir))
        logs = [f for f in files if f.startswith("log-")]
        with open(os.path.join(run_dir, logs[0])) as f:
            logged = [ln.rstrip("\n") for ln in f if "| Epoch:" in ln]
        pth = sorted(f for f in files if f.endswith(".pth"))
        last = torch.load(os.path.join(run_dir, "model_last.pth"), map_location="cpu",
                          weights_only=True)
        again = torch.load(os.path.join(run_dir, "stage_1.pth"), map_location="cpu",
                           weights_only=True)
        restored = (tensors_of(last["params"]) and len(tensors_of(last["params"]))
                    == len(tensors_of(again["params"])) and all(
                        torch.equal(a, b) for a, b in zip(tensors_of(last["params"]),
                                                          tensors_of(again["params"]))))
        ok = (pth == sorted(CHECKPOINTS) and len(logs) == 1 and len(logged) == 6
              and all(re.match(TRAINER_EPOCH_LINE, ln) for ln in logged)
              and [ln.split("|Net:")[0] for ln in logged] == done and restored
              and set(files) == set(CHECKPOINTS) | set(logs))
        line = (f"the run directory holds {files}: the five checkpoints and one log, written "
                f"by the chief alone; its 6 epoch lines are every rank's; --resume with "
                f"--stage_epochs 0,0,0 restored model_last.pth bit for bit (stage_1.pth) "
                f"{bool(restored)}")
        for ln in logged:
            r.say("c", f"log: {ln}")
    r.say("c", line)
    r.held("c", ok, "the CLI under the launch")

    got = trainer_epochs(s, r.dev, root, n_circuits, True,
                         ("grouped", "per_step", "split", "per_step", "grouped"))
    r.agree("c", "each trainer's meters", got["meters"])
    r.agree("c", "each trainer's params and BN state (digest)", got["digests"])
    ms = r.gather(got["ms"])
    prof = got.get("profile")
    one, ref = "", r.ref
    if ref:
        one = (f"; one card, the same per-rank data ({s.circuits} circuits, "
               f"{ref['steps']} train steps): " + ", ".join(
                   f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in ref["ms"])
               + (f", busy share {ref['profile']['busy'] / ref['profile']['wall']:.3f}"
                  if ref.get("profile") else ""))
    r.say("c", f"trainer epochs at dp = {W} ({n_circuits} circuits, {got['steps']} train "
               f"steps of {W} x bs{s.bs}), ms per train step (a new trainer's first epoch "
               f"with its capture / its second), in turns, rank 0: "
               + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in ms[0])
               + "; the slowest rank's second epochs: "
               + ", ".join(f"{k} {max(m[i][1][1] for m in ms):.3f}"
                           for i, (k, _) in enumerate(ms[0]))
               + (f"; rank 0's busy share over one grouped epoch under torch.profiler "
                  f"{prof['busy'] / prof['wall']:.3f} ({prof['wall'] / got['steps']:.3f} ms "
                  f"wall, {prof['busy'] / got['steps']:.3f} busy a step)" if prof else "")
               + one + f"; card {r.name}")
    r.dist.barrier()
    if r.rank == 0:
        shutil.rmtree(root, ignore_errors=True)


def tensors_of(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in tensors_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def phase_d(r: Rank):
    """One Balancer epoch at dp = N."""
    from ..cli import load_dataset
    from ..config import get_parse_args
    from ..models import dg_ae
    from ..train import step as step_mod
    from ..train.trainer_balancer import BalancerTrainer

    s, W = r.s, r.world
    root = os.path.join(r.out, "d")
    args = get_parse_args(trainer_argv(s, s.circuits * W, root, "bal"))
    train_ds, _ = load_dataset(args)
    p0, s0 = dg_ae.init_params(r.cfg, seed=SEED + 6, device=r.dev)
    t = BalancerTrainer(args, r.cfg, params=p0, state=s0, training_id="bal", save_dir=root,
                        batch_size=s.bs, distributed=True, seed=SEED, device=r.dev)
    t.set_training_args(rc_prob_func_weight=WEIGHTS[:3], lr=LR)
    m = t.train(1, train_ds, [])
    r.sync()
    meters = {k: v for k, v in m.items() if k != "time"}
    ok = all(math.isfinite(v) for v in meters.values())
    r.agree("d", "the Balancer epoch's meters", meters)
    r.agree("d", "params, BN state and the Balancer's state after it (digest)",
            digest(step_mod.param_leaves(t.params) + step_mod.param_leaves(t.state)
                   + step_mod.param_leaves(t.bal_state)))
    ms = r.gather(m["time"] * 1e3)
    r.say("d", f"BalancerTrainer at dp = {W}, one epoch of {len(train_ds) // (s.bs * W)} steps: "
               f"meters {meters}; ms a step by rank {[round(x, 3) for x in ms]}; card {r.name}")
    r.held("d", ok, "finite meters")
    r.dist.barrier()
    if r.rank == 0:
        shutil.rmtree(root, ignore_errors=True)


def sharded_want(r: Rank, route: str, n_lv: int) -> dict:
    """Launches of one sharded train step by the code: the struct towers'
    all-gather per half-round and tower (forward) and its all-reduce
    (backward); per real level the kernel route's all-gather and its
    all-reduce, or the edge route's max, two sums and the sums' two
    all-reduces; one mean. On the card the kernel route runs kernel 5 once
    and kernel 6's three launches per real level and member, and builds the
    member's level lists once; the row gathers' backward runs on both
    routes (``GATHER_BWD_LAUNCHES``)."""
    R = r.s.rounds
    per_level = 2 if route == "kernel" else 5
    want = {"collectives.launches": 2 * 4 * R + per_level * n_lv + 1}
    if r.card and route == "kernel":
        # the member's pack rows are an index_select: six gathers, not seven
        want.update({"level_kernel.step_launches": n_lv, "level_kernel.step_bwd_launches":
                     3 * n_lv, "level_kernel.lists_launches": 1,
                     "gather.bwd_launches": GATHER_BWD_LAUNCHES - 2})
    elif r.card:   # no level statics: the positive edges' two gathers in the loss
        want["gather.bwd_launches"] = 2 * 2
    return want


def sharded_stepper(r: Rank, mesh, batch: dict, draws, lr: float, weights):
    """(run, params, leaves): ``run()`` takes one sharded step (SGD at
    ``lr``) on the batch with the draws."""
    from ..models import dg_ae
    from ..parallel import sharded
    from ..train import step as step_mod

    params, state = dg_ae.init_params(r.cfg, seed=SEED + 3, device=r.dev)
    leaves = step_mod.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    step = sharded.make_sharded_train_step(r.cfg, torch.optim.SGD(leaves, lr=lr), mesh)
    neg, keep = on(draws, r.dev)
    return (lambda: step(params, state, batch, None, weights, neg_edges=neg, drop_keep=keep),
            params, leaves)


def single_grads(r: Rank, batches, draws, lr: float, weights):
    """On this rank's card alone: the mean over ``batches`` of the single-
    device step's gradients, metrics and new BN state, and the params after
    one SGD step at ``lr`` with that mean."""
    from ..models import dg_ae
    from ..ops.precision import matmul_precision
    from ..train import step as step_mod

    params, state = dg_ae.init_params(r.cfg, seed=SEED + 3, device=r.dev)
    leaves = step_mod.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    sums, states, mets = None, [], []
    for b, d in zip(batches, draws):
        for t in leaves:
            t.grad = None
        neg, keep = on(d, r.dev)
        with matmul_precision(r.cfg.matmul_precision):
            total, (ns, m) = step_mod.loss_and_metrics(params, state, b, None, weights, r.cfg,
                                                       True, neg_edges=neg, drop_keep=keep)
            total.backward()
        g = [None if t.grad is None else t.grad.detach().clone() for t in leaves]
        sums = g if sums is None else [None if a is None else a + c for a, c in zip(sums, g)]
        states.append(step_mod.param_leaves(state | ns))
        mets.append(m)
    n = len(batches)
    grads = [None if g is None else g / n for g in sums]
    with torch.no_grad():
        for t, g in zip(leaves, grads):
            if g is not None:
                t -= lr * g
    return {"grads": grads, "params": [t.detach() for t in leaves],
            "state": [sum(x) / n for x in zip(*states)],
            "metrics": {k: float(sum(m[k] for m in mets)) / n for k in mets[0]}}


def meshes(W: int) -> list:
    """(dp, mp) meshes with mp > 1 over W ranks: (W / 2, 2) from four ranks
    on, and (1, W); (1, 1) on one rank."""
    out = [(W // 2, 2)] if W >= 4 and W % 2 == 0 else []
    return out + [(1, W)]


def phase_e(r: Rank):
    """The sharded train step on (dp, mp) meshes, both routes, against the
    single-card step."""
    from ..data.batching import collate_shards, shard_levels_by_dst
    from ..models import dg_ae
    from ..parallel import mesh as mesh_mod
    from ..parallel import sharded
    from ..train import step as step_mod

    s, cfg = r.s, r.cfg
    for dp, mp in meshes(r.world):
        mesh = mesh_mod.make_mesh(dp, mp)
        shards = [circuits(s, SEED + 30 + d, s.bs) for d in range(dp)]
        hb = shard_levels_by_dst(collate_shards(shards, mp=mp, dims=common_dims(shards, mp)),
                                 mp)
        per_shard = [{k: v[d] for k, v in hb.items()} for d in range(dp)]
        draws = [host_draws(b, cfg, SEED + 40 + d) for d, b in enumerate(per_shard)]
        for route in ("kernel", "edge"):
            batches = [b if route == "kernel" else
                       {k: v for k, v in b.items() if not k.startswith("mp_lv_")}
                       for b in per_shard]
            mine = batches[mesh.dp_rank]
            n_lv = dg_ae.num_levels(mine)
            if sharded.route_of(mine, cfg, mp) != route:
                raise RuntimeError(f"[multichip] (e) ({dp}, {mp}) {route}: the batch did not "
                                   f"select the {route} route")
            # the forward against the single-device forward of the shard
            params, _ = dg_ae.init_params(cfg, seed=SEED + 3, device=r.dev)
            with torch.no_grad():
                hs1, hf1 = sharded.make_sharded_forward(cfg, mesh.mp_group)(params, mine)
                hs0, hf0, _ = dg_ae.forward(params, mine, cfg)
            n = int(mine["n_nodes"])
            d_hs = float(((hs1[:n] - hs0[:n]).abs() / (1e-5 + 1e-4 * hs0[:n].abs())).max())
            d_hf = float((hf1[:n] - hf0[:n]).abs().max()) / 1e-4
            run, params, leaves = sharded_stepper(r, mesh, mine, draws[mesh.dp_rank], SGD_LR,
                                                  SMOOTH_WEIGHTS)
            r.sync()
            c0 = counts()
            new_state, metrics = run()
            r.sync()
            got = delta(counts(), c0)
            for k in ("level_kernel.levels_walked", "level_kernel.bwd_levels_walked"):
                got.pop(k, None)
            want = sharded_want(r, route, n_lv)
            flat = [t.detach() for t in leaves] + step_mod.param_leaves(new_state)
            r.agree("e", f"({dp}, {mp}) {route}: params and BN state after the step (digest)",
                    digest(flat))
            ok, line = max(d_hs, d_hf) <= 1.0 and got == want, ""
            if r.rank == 0:
                ref = single_grads(r, batches, draws, SGD_LR, SMOOTH_WEIGHTS)
                d_p = max(float((a.detach() - c).abs().max())
                          for a, c in zip(leaves, ref["params"])) / 5e-6
                d_s = max(float(((a - c).abs() / (1e-6 + 1e-4 * c.abs())).max())
                          for a, c in zip(step_mod.param_leaves(new_state), ref["state"]))
                d_m = max(abs(float(metrics[k]) - v) / (1e-6 + 1e-5 * abs(v))
                          for k, v in ref["metrics"].items())
                ok = ok and max(d_p, d_s, d_m) <= 1.0
                line = (f"; against the single-card step of the {dp} shard(s) on rank 0's card "
                        f"(SGD lr {SGD_LR}, weights {SMOOTH_WEIGHTS}): params {d_p:.3f} of "
                        f"5e-6, BN state {d_s:.3f} of rtol 1e-4 / atol 1e-6, metrics "
                        f"{d_m:.3f} of rtol 1e-5 / atol 1e-6")
            r.say("e", f"(dp, mp) = ({dp}, {mp}), {route} route, bs{s.bs} shard of N="
                       f"{mine['gate'].shape[0]}, {n_lv} real levels: forward against the "
                       f"shard's single-device forward on each card: hs {d_hs:.3f} of rtol "
                       f"1e-4 / atol 1e-5, hf {d_hf:.3f} of atol 1e-4 (rank 0); launches of "
                       f"one step {got} (want {want})" + line)
            r.held("e", ok, f"({dp}, {mp}) {route}")


def giant_case(r: Rank, depth: int):
    from ..data.batching import collate, shard_levels_by_dst
    from ..data.synthetic import layered_circuit

    width, _, tt = r.s.giant
    t0 = time.perf_counter()
    g = layered_circuit(np.random.default_rng(0), "mig", width=width, depth=depth,
                        num_tt_pairs=tt)
    t1 = time.perf_counter()
    batch = shard_levels_by_dst(collate([g], mp=r.world), r.world)
    return batch, t1 - t0, time.perf_counter() - t1


def timed_steps(r: Rank, run, n: int) -> list:
    ms = []
    for _ in range(n):
        r.sync()
        t0 = time.perf_counter()
        run()
        r.sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def peaks(r: Rank, fn):
    """fn() with this card's peak allocated memory reset before it: (its
    result, the peak in GiB, the peak above what was allocated before)."""
    if not r.card:
        return fn(), 0.0, 0.0
    r.sync()
    base = torch.cuda.memory_allocated(r.dev)
    torch.cuda.reset_peak_memory_stats(r.dev)
    out = fn()
    r.sync()
    peak = torch.cuda.max_memory_allocated(r.dev)
    return out, peak / 2 ** 30, (peak - base) / 2 ** 30


def single_stepper(r: Rank, batch, draws, weights):
    """(run, leaves): one single-device train step (SGD at lr 0) on this
    rank's card."""
    from ..models import dg_ae
    from ..train import step as step_mod

    params, state = dg_ae.init_params(r.cfg, seed=SEED + 3, device=r.dev)
    leaves = step_mod.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    step = step_mod.make_train_step(r.cfg, torch.optim.SGD(leaves, lr=0.0))[0]
    neg, keep = on(draws, r.dev)
    return (lambda: step(params, state, batch, None, weights, neg_edges=neg, drop_keep=keep),
            leaves)


def phase_f(r: Rank):
    """The giant graph at mp = N on the dst-complete route."""
    from ..models import dg_ae
    from ..parallel import mesh as mesh_mod
    from ..parallel import sharded

    s, cfg, W = r.s, r.cfg, r.world
    mesh = mesh_mod.make_mesh(1, W)
    batch, t_gen, t_col = giant_case(r, s.giant[1])
    n_lv, N = dg_ae.num_levels(batch), batch["gate"].shape[0]
    draws = host_draws(batch, cfg, SEED + 12)
    if sharded.route_of(batch, cfg, W) != "kernel":
        raise RuntimeError("[multichip] (f): the giant batch did not select the kernel route")
    params, _ = dg_ae.init_params(cfg, seed=SEED + 3, device=r.dev)
    with torch.no_grad():
        hs1, hf1 = sharded.make_sharded_forward(cfg, mesh.mp_group)(params, batch)
    r.agree("f", "the sharded forward's hs and hf (digest)", digest([hs1, hf1]))
    run, _, leaves = sharded_stepper(r, mesh, batch, draws, 0.0, SMOOTH_WEIGHTS)
    r.sync()
    c0 = counts()
    run()
    r.sync()
    got = delta(counts(), c0)
    for k in ("level_kernel.levels_walked", "level_kernel.bwd_levels_walked"):
        got.pop(k, None)
    want = sharded_want(r, "kernel", n_lv)
    g_mp = [None if t.grad is None else t.grad.detach().clone() for t in leaves]
    ok, line = got == want, ""
    single = None
    if r.rank == 0:
        with torch.no_grad():
            hs0, hf0, _ = dg_ae.forward(params, batch, cfg)
        n = int(batch["n_nodes"])
        d_hs = float(((hs1[:n] - hs0[:n]).abs() / (1e-5 + 1e-4 * hs0[:n].abs())).max())
        d_hf = float((hf1[:n] - hf0[:n]).abs().max()) / 1e-4
        del hs0, hf0
        single = single_stepper(r, batch, draws, SMOOTH_WEIGHTS)
        single[0]()
        r.sync()
        g_1 = [None if t.grad is None else t.grad.detach() for t in single[1]]
        worst = leaf_ratio(g_mp, g_1)
        ok = ok and max(d_hs, d_hf, worst) <= 1.0
        line = (f"; against the single-card giant route on rank 0's card: hs {d_hs:.3f} of "
                f"rtol 1e-4 / atol 1e-5, hf {d_hf:.3f} of atol 1e-4, each gradient leaf "
                f"{worst:.3f} of {GRAD_TOL} x its own scale (floored at {GRAD_FLOOR} of the "
                f"largest)")
    del hs1, hf1
    r.say("f", f"layered MIG width {s.giant[0]} x depth {s.giant[1]} (N={N}, {n_lv} real "
               f"levels; generated in {t_gen:.1f} s, collated and shard_levels_by_dst in "
               f"{t_col:.1f} s on each rank's host) at mp = {W}, dst-complete route: member "
               f"tables Ep_m={batch['mp_lv_edge_src'].shape[-1]} "
               f"Np_m={batch['mp_lv_nodes'].shape[-1]}; launches of one step {got} (want "
               f"{want}; weights {SMOOTH_WEIGHTS})" + line)
    r.held("f", ok, "the giant graph at mp = N against one card")

    # ms a step and peak memory per card, in turns: single, sharded, sharded, single
    turns = []
    for who in ("single", "mp", "mp", "single"):
        if who == "mp":
            ms, peak, own = peaks(r, lambda: timed_steps(r, run, s.timed))
            turns.append((who, statistics.median(ms), r.gather((peak, own))))
        else:
            res = None
            if r.rank == 0:
                res = peaks(r, lambda: timed_steps(r, single[0], s.timed))
            r.dist.barrier()
            if r.rank == 0:
                turns.append((who, statistics.median(res[0]), [(res[1], res[2])]))
    if r.rank == 0:
        r.say("f", f"ms a step (medians of {s.timed}, synchronised) and peak allocated GiB per "
                   f"card (absolute / above what the rank held before), in turns: " + "; ".join(
                       f"{who} {ms:.3f} ms, peaks "
                       + ", ".join(f"{p:.3f} / {o:.3f}" for p, o in pk)
                       for who, ms, pk in turns) + f"; card {r.name}")
    # rank 0's profile of two sharded steps
    prof = None
    r.sync()
    if r.card and r.rank == 0:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            run()
            r.sync()
            wall = (time.perf_counter() - t0) * 1e3
    else:
        run()
        run()
        r.sync()
    if prof is not None:
        ev = device_events(prof)
        nccl = sum(e.time_range.elapsed_us() for e in ev if "nccl" in e.name.lower()) / 1e3
        k56 = sum(e.time_range.elapsed_us() for e in ev
                  if any(k in e.name for k in STEP_KERNELS)) / 1e3
        busy = busy_union(ev)
        r.say("f", f"rank 0 under torch.profiler, two sharded steps: wall {wall / 2:.3f} ms, "
                   f"device busy {busy / 2:.3f} ms a step (share {busy / wall:.3f}); NCCL "
                   f"kernels {nccl / 2:.3f} ms a step against kernels 5 and 6 "
                   f"({', '.join(STEP_KERNELS)}) {k56 / 2:.3f} ms a step; {len(ev) / 2:.0f} "
                   f"device events a step")
    del run, single, leaves, g_mp
    if r.card:
        torch.cuda.empty_cache()


def phase_g(r: Rank):
    """Past the giant graph: depth 1000, one step at mp = N and one on one card."""
    from ..models import dg_ae
    from ..parallel import mesh as mesh_mod

    s, cfg, W = r.s, r.cfg, r.world
    mesh = mesh_mod.make_mesh(1, W)
    batch, t_gen, t_col = giant_case(r, s.past_depth)
    n_lv, N = dg_ae.num_levels(batch), batch["gate"].shape[0]
    draws = host_draws(batch, cfg, SEED + 13)
    run, _, _ = sharded_stepper(r, mesh, batch, draws, 0.0, SMOOTH_WEIGHTS)
    ms, peak, own = peaks(r, lambda: timed_steps(r, run, 2))
    mp_peaks = r.gather((peak, own))
    del run
    if r.card:
        torch.cuda.empty_cache()
    line = ""
    if r.rank == 0:
        single, _ = single_stepper(r, batch, draws, SMOOTH_WEIGHTS)
        ms1, p1, o1 = peaks(r, lambda: timed_steps(r, single, 2))
        del single
        line = (f"; one card: {ms1[0]:.3f} / {ms1[1]:.3f} ms, peak {p1:.3f} / {o1:.3f} GiB")
    r.dist.barrier()
    r.say("g", f"layered MIG width {s.giant[0]} x depth {s.past_depth} (N={N}, {n_lv} real "
               f"levels; generated in {t_gen:.1f} s, collated in {t_col:.1f} s): two sharded "
               f"steps at mp = {W} {ms[0]:.3f} / {ms[1]:.3f} ms (the first builds), peak "
               f"allocated GiB per card (absolute / above what the rank held) "
               + ", ".join(f"{p:.3f} / {o:.3f}" for p, o in mp_peaks) + line
               + f"; card {r.name}")
    r.held("g", all(math.isfinite(x) for x in ms), "finite steps")
    if r.card:
        torch.cuda.empty_cache()


PHASES = {"k": phase_k, "a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d, "e": phase_e,
          "f": phase_f, "g": phase_g}


def worker(device: str, phases: str, out: str) -> None:
    ref = None
    path = os.path.join(out, "reference.json")
    if os.path.exists(path):
        with open(path) as f:
            ref = json.load(f)
    r = Rank(device, out, ref)
    if r.rank:     # rank 0 prints every phase's lines; the others' errors still show
        sys.stdout = open(os.devnull, "w")
    r.say("-", f"{r.world} rank(s) over {r.dist.get_backend()}; rank 0 on {r.name}; phases "
               f"{phases}")
    for p in phases:
        t0 = time.perf_counter()
        r.dist.barrier()
        PHASES[p](r)
        r.say(p, f"took {time.perf_counter() - t0:.1f} s")
    r.dist.barrier()
    r.say("-", "every phase held")
    r.dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the launcher


def launch(nproc: int | None, device: str, phases: str, out: str, timeout: float) -> int:
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip needs CUDA cards (torch.cuda.is_available() "
                               "is False); --device cpu runs the phases over gloo on the CPU")
        cards = torch.cuda.device_count()
        nproc = cards if nproc is None else nproc
        if nproc > cards:
            raise RuntimeError(f"dryrun_multichip: {nproc} ranks asked, {cards} card(s): one "
                               f"rank a card (NCCL takes one rank a device)")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        for line in smi.splitlines():
            log(f"[multichip] card {line}")
        log(f"[multichip] torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
        from ..ops import _build

        built = _build.build()
        log(f"[multichip] kernels built in {built.seconds:.1f} s: {built.path.name}")
    else:
        nproc = 4 if nproc is None else nproc
        torch.set_num_threads(1)
        os.environ["MGVAE_PLATFORM"] = "cpu"
    if nproc < 1:
        raise ValueError("dryrun_multichip: --nproc must be at least 1")
    from .. import native

    nat = native.build()
    log(f"[multichip] native host library built in {nat.seconds:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    try:
        if "c" in phases:
            s = SIZES[device]
            dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
            t0 = time.perf_counter()
            ref = trainer_epochs(s, dev, os.path.join(out, "c1"), s.circuits, False,
                                 ("grouped", "per_step", "per_step", "grouped"))
            shutil.rmtree(os.path.join(out, "c1"), ignore_errors=True)
            with open(os.path.join(out, "reference.json"), "w") as f:
                json.dump({k: ref[k] for k in ("ms", "steps", "profile") if k in ref}, f)
            log(f"[multichip] (c) one card (the launcher, no process group): {s.circuits} "
                f"circuits, {ref['steps']} train steps of bs{s.bs}, ms per train step (first / "
                f"second epoch): " + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b)
                                               in ref["ms"])
                + f"; {time.perf_counter() - t0:.1f} s")
            if device == "cuda":
                torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), "-m", "mgvae_tpu_torch.examples.dryrun_multichip",
               "--worker", "--device", device, "--phases", phases, "--out", out]
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, env=env)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            log(f"[multichip] {nproc} ranks past {timeout} s: stopped")
            return 124
        log(f"[multichip] {nproc} rank(s) exited {rc} after {time.perf_counter() - t0:.1f} s")
        return rc
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks, one card each (default: every card; 4 with --device cpu)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--phases", default="kabcdefg",
                    help="the phases to run, in order (letters of k, a-g)")
    ap.add_argument("--out", default=os.path.join(REPO, "exp", "dryrun_multichip"))
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds for the ranks, their start included")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if set(a.phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(a.phases) - set(PHASES))}")
    if a.worker:
        worker(a.device, a.phases, a.out)
        return 0
    return launch(a.nproc, a.device, a.phases, a.out, a.timeout)


if __name__ == "__main__":
    sys.exit(main())
