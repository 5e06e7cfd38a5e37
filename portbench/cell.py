"""One run of one cell: set-up, the measured window, the check.

Set-up makes the circuits and the weights from the seed, builds ONE
``Trainer`` of the program under test with those weights, and runs its
first epoch (``Trainer.train``): its first K-step call compiles nothing but
captures the step's CUDA graph after one eager step, and the val phase
captures the eval step's. That first call runs as calls of 1, 1, 1 and K - 3
steps through the trainer's own K-step object (``FirstSteps``), so that the
first two gradients (from Adam's first moments after steps 1 and 2: the
eager step's and the first replay's) and the parameters after step 3 can
be read; the trainer's epoch is otherwise unchanged.

The window runs whole epochs through ``Trainer.train`` until ``seconds``
have passed, and ends at an epoch's end (the trainer reads its metrics
back there), so it holds the val phase, the epoch plan, the read-back and
the checkpoints as a user's epochs do. Under data parallelism rank 0 says
when the window ends.

The check runs after the window, once the trainer is freed: the reference
follows the same three steps from the same weights and draws
(``reference.train_steps``), and ``check.numbers`` compares.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import check, flops, reference, traffic as traffic_mod

METRIC_COLUMNS = 3       # recon, prob, func: the first three of the trainer's metric rows


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict                  # the configuration file's settings
    traffic: dict              # the traffic file's parameters
    limits: dict               # the numbers compared (check.NAMES) -> their limits
    device: str = "cuda"


def program_config(cfg: dict, plant: str | None = None):
    from mgvae_tpu_torch.models.dg_ae import DGConfig

    if cfg["model"] != "DG_AE":
        raise ValueError(f"config: model {cfg['model']!r}: the harness trains DG_AE cells only")
    precision = "default" if plant == "tf32" else cfg["matmul_precision"]
    return DGConfig(modality=cfg["modality"], dim_hidden=cfg["dim_hidden"],
                    dim_feature=cfg["dim_feature"], s_rounds=cfg["s_rounds"],
                    t_rounds=cfg["t_rounds"], layernorm=cfg["layernorm"],
                    num_rounds=cfg["num_rounds"], input_quirk=cfg["input_quirk"],
                    dim_mlp=cfg["dim_mlp"], matmul_precision=precision)


def program_graphs(circuits: list) -> list:
    """The program's circuit objects, one per distinct circuit."""
    from mgvae_tpu_torch.data.graph import build_graph

    made: dict = {}
    out = []
    for c in circuits:
        if id(c) not in made:
            made[id(c)] = build_graph("portbench", c.gate, c.edge_index, c.prob,
                                      c.tt_pair_index, c.tt_dis)
        out.append(made[id(c)])
    return out


def leaf_norms(pairs) -> dict:
    """{leaf: its norm} of (leaf, tensor) pairs."""
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in pairs}


class FirstSteps:
    """Stands in for the trainer's K-step train call for its first call
    only, which it runs as calls of 1, 1, 1 and K - 3 steps of the same
    stacked batch through the trainer's own object (on the card: the eager
    step, then the capture and the graph's first replays), and keeps the
    first three steps' metric rows, the first and second gradients as Adam
    holds them after steps 1 and 2 and the parameters after step 3."""

    def __init__(self, trainer):
        self.trainer, self.call = trainer, trainer.multi_step
        self.rows = self.grad = self.grad2 = self.params3 = None
        trainer.multi_step = self

    def _moments(self, params) -> list:
        opt = self.trainer.optimizer
        return [(n, opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone())
                for n, p in reference.leaves(params)]

    def __call__(self, params, state, sbatch, gen, weights):
        tr = self.trainer
        tr.multi_step = self.call
        if "groups" in sbatch:
            raise ValueError("the check follows plain and chunked layouts, not split ones")
        K = int(np.shape(sbatch["gate"])[0])
        part = lambda a, b: {k: v[a:b] for k, v in sbatch.items()}
        beta1 = tr.optimizer.param_groups[0]["betas"][0]
        rows = []
        state, r = self.call(params, state, part(0, 1), gen, weights)
        rows.append(r)
        m1 = self._moments(params)
        self.grad = leaf_norms([(n, m / (1.0 - beta1)) for n, m in m1])
        state, r = self.call(params, state, part(1, 2), gen, weights)
        rows.append(r)
        self.grad2 = leaf_norms([(n, (m2 - beta1 * m) / (1.0 - beta1))
                                 for (n, m), (_, m2) in zip(m1, self._moments(params))])
        state, r = self.call(params, state, part(2, 3), gen, weights)
        rows.append(r)
        self.params3 = {n: p.detach().clone() for n, p in reference.leaves(params)}
        if K > 3:
            state, r = self.call(params, state, part(3, K), gen, weights)
            rows.append(r)
        rows = torch.cat(rows)
        self.rows = rows[:3, :METRIC_COLUMNS].double().cpu().tolist()
        return state, rows


class Recorder:
    """The traced window's spans from the benchmark's side: each K-step call
    of the trainer under a ``record_function`` range, with the real sizes
    of its steps (phase, nodes, edges, gates, pairs) and the program's
    launch counters before and after."""

    def __init__(self, trainer):
        from mgvae_tpu_torch.train.step import launch_counts

        self.trainer, self.launch_counts = trainer, launch_counts
        self.shapes, self.launches = [], {"train": {}, "val": {}}
        self.calls = {"train": trainer.multi_step, "val": trainer.multi_eval}
        trainer.multi_step = self._wrap("train")
        trainer.multi_eval = self._wrap("val")

    def _wrap(self, phase):
        call = self.calls[phase]

        def recorded(params, state, sbatch, gen, weights):
            valid = np.asarray(sbatch["node_valid"])
            upd = valid & (np.asarray(sbatch["gate"]) != 0)
            ev = np.asarray(sbatch["edge_valid"])
            tt = np.asarray(sbatch["tt_valid"])
            for k in range(valid.shape[0]):
                self.shapes.append((phase, int(valid[k].sum()), int(ev[k].sum()),
                                    int(upd[k].sum()), int(tt[k].sum())))
            before = self.launch_counts()
            with torch.profiler.record_function(f"portbench.kstep.{phase}"):
                out = call(params, state, sbatch, gen, weights)
            after = self.launch_counts()
            acc = self.launches[phase]
            for key, v in after.items():
                name = f"{key[0].__name__.rsplit('.', 1)[-1]}.{key[1]}"
                acc[name] = acc.get(name, 0) + v - before[key]
            return out

        return recorded

    def restore(self):
        self.trainer.multi_step, self.trainer.multi_eval = self.calls["train"], self.calls["val"]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float, rank: int = 0,
        world: int = 1, plant: str | None = None) -> dict:
    """One run; returns the result's fields (on rank 0 of a data-parallel
    launch; the other ranks return None after sending their readings).
    ``plant`` breaks the program on purpose, for the control and the faults
    (``calibrate.py``, the tests): "tf32", "frozen", "half", "noexchange"."""
    from mgvae_tpu_torch.train.trainer import Trainer

    cfg, tr_spec = cell.cfg, cell.traffic
    if tr_spec["dp"] != world:
        raise ValueError(f"{cell.name}: the traffic runs dp = {tr_spec['dp']}, this launch has "
                         f"{world} rank(s)")
    device = cell.device if cell.device == "cpu" else f"cuda:{rank}"
    if device != "cpu":
        torch.cuda.set_device(rank)
    marks = {"start": time.time() - t0}      # seconds from t0 to each stage of the set-up
    cfg = dict(cfg, num_experts=len(reference.GATES[cfg["modality"]]))
    data = traffic_mod.build(tr_spec, cfg["modality"], seed)
    train_g, val_g = program_graphs(data.train), program_graphs(data.val)
    params, state = reference.weight_tree(cfg, seed, device)
    params0 = reference.tree_map(lambda x: x.detach().clone(), params)
    marks["data"] = time.time() - t0
    # the trainer's log and checkpoints, under TMPDIR, removed when the run ends
    workdir = tempfile.mkdtemp(prefix=f"portbench_{cell.name}_rank{rank}_")
    undo = _plant(plant, device)
    try:
        trainer = Trainer(None, program_config(cfg, plant), params=params, state=state,
                          training_id="run", save_dir=workdir, lr=cfg["lr"],
                          rc_prob_func_weight=cfg["loss_weights"][:3], kl_weight=0.0,
                          batch_size=tr_spec["batch_size"], distributed=world > 1, seed=seed,
                          steps_per_call=tr_spec["steps_per_call"], device=device)
        trainer.set_training_args(lr_step=cfg["lr_step"])
        marks["trainer"] = time.time() - t0
        if plant == "frozen":
            trainer.optimizer.step = lambda *a, **k: None
        first = FirstSteps(trainer)
        trainer.train(1, train_g, val_g)            # epoch 0: the warm-up
        _sync(device)
        setup_s = marks["epoch 0"] = time.time() - t0
        window = _window(trainer, train_g, val_g, seconds, trace, device, rank, world)
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        prog = {"rows": first.rows, "grad": first.grad, "grad2": first.grad2,
                "change": {n: float(torch.linalg.vector_norm((first.params3[n] - p0).double()))
                           for n, p0 in reference.leaves(params0)}}
        del trainer, first, params, state
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    finally:
        undo()
        shutil.rmtree(workdir, ignore_errors=True)
    busy = window["trace"]["busy_s"] if trace else 0.0
    prog_changes, peak, busy = _gather(prog["change"], peak, busy, world, device)
    if rank != 0:
        return None
    t_check = time.perf_counter()
    ref = _reference(cell, cfg, data, params0, seed, world, device)
    nums = check.numbers(prog["rows"], ref["loss"], prog["grad"], ref["grad"], prog["grad2"],
                         ref["grad2"], prog_changes, ref["change"])
    correct, checks = check.judge(nums, cell.limits)
    work = traffic_mod.real_counts(data.train)
    epochs = window["epochs"]
    train_steps = epochs * (tr_spec["train_entries"] // (tr_spec["batch_size"] * world))
    gates_per_s = epochs * work["nodes"] / window["seconds"]
    step_flops = flops.train_flops(cfg, work["nodes"], work["gates"], work["edges"],
                                   work["pairs"])
    mfu = epochs * step_flops / (window["seconds"] * flops.PEAK_FLOP_S * world) * 100.0
    return {"correct": correct, "checks": checks, "numbers": {k: v[0] for k, v in nums.items()},
            "where": {k: v[1] for k, v in nums.items()},
            "attempted": train_steps, "failed": 0,
            "end_to_end": {"train_gates_per_s": gates_per_s, "dp_train_gates_per_s": gates_per_s,
                           "train_mfu": mfu, "setup_s": setup_s},
            "window": window, "memory_peak_bytes": peak, "busy_s": busy, "marks": marks,
            "check_s": time.perf_counter() - t_check,
            "readings": _readings(cfg, window, world) if trace else None}


def _window(trainer, train_g, val_g, seconds, trace, device, rank, world) -> dict:
    """Whole epochs until ``seconds`` have passed (rank 0's clock)."""
    out = {"epochs": 0}
    rec = prof = None
    if trace:
        trainer.step_times = []
        rec = Recorder(trainer)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA]
                                         if device != "cpu" else []))
        prof.start()
    t_ns = time.time_ns()
    start = time.perf_counter()
    flag = torch.zeros(1, device=device)
    while True:
        if time.perf_counter() - start >= seconds and rank == 0:
            flag.fill_(1.0)
        if world > 1:
            dist.broadcast(flag, 0)
        if float(flag) > 0:
            break
        with torch.profiler.record_function("portbench.epoch") if trace \
                else contextlib.nullcontext():
            trainer.train(1, train_g, val_g)
        out["epochs"] += 1
    _sync(device)
    out["seconds"] = time.perf_counter() - start
    t1_ns = time.time_ns()
    if trace:
        prof.stop()
        rec.restore()
        from . import trace as trace_mod

        out["trace"] = trace_mod.read(prof, t_ns, t1_ns, main_thread=_main_thread(prof))
        out["shapes"], out["launches"] = rec.shapes, rec.launches
        out["step_times"] = list(trainer.step_times)
        trainer.step_times = None
        del prof
    return out


def _main_thread(prof):
    """The thread that opened the benchmark's epoch ranges."""
    for e in prof.profiler.kineto_results.events():
        if e.name() == "portbench.epoch":
            return e.start_thread_id()
    return None


def _gather(change: dict, peak: int, busy: float, world: int, device) -> tuple:
    """Every rank's per-leaf change norms, the largest peak and the mean
    busy seconds, at every rank."""
    if world == 1:
        return [change], peak, busy
    names = sorted(change)
    mine = torch.tensor([change[n] for n in names] + [float(peak), busy], dtype=torch.float64,
                        device=device)
    got = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(got, mine)
    rows = [g.cpu().tolist() for g in got]
    return ([dict(zip(names, r[:-2])) for r in rows], int(max(r[-2] for r in rows)),
            sum(r[-1] for r in rows) / world)


def _readings(cfg: dict, window: dict, world: int) -> dict:
    """What the per-layer readers read (``metrics/*.py``): rank 0's traced
    window."""
    tr = window["trace"]
    steps = {p: sum(1 for s in window["shapes"] if s[0] == p) for p in ("train", "val")}
    return {"cfg": cfg, "chips": world, "kernels": tr["kernels"], "counts": tr["counts"],
            "busy_s": tr["busy_s"], "window_s": tr["window_s"], "steps": steps,
            "shapes": window["shapes"], "launches": window["launches"],
            "step_times": window["step_times"]}


def _reference(cell, cfg, data, params0, seed, world, device) -> dict:
    """The reference's first three steps, as the check compares them."""
    t = cell.traffic
    shards = reference.epoch_shards(len(data.train), seed, t["batch_size"], world)
    counts = [[reference.padded_nodes(sum(data.train[i].num_nodes for i in sh)),
               reference.bucket(sum(data.train[i].num_edges for i in sh))]
              for step in shards for sh in step]
    n_pad, e_pad = max(c[0] for c in counts), max(c[1] for c in counts)
    steps = []
    for step in shards[:3]:
        lays = [reference.join([data.train[i] for i in sh], device) for sh in step]
        for lay in lays:
            lay.n_pad, lay.e_pad = n_pad, e_pad
        steps.append(lays)
    gens = [reference.rank_generator(seed, r, device) for r in range(world)]
    out = reference.train_steps(cfg, params0, reference.initial_state(cfg, device), steps, gens, cfg["loss_weights"],
                                cfg["lr"])
    return {"loss": out["loss"].double().cpu().tolist(),
            "grad": leaf_norms(out["grad"].items()),
            "grad2": leaf_norms(out["grad2"].items()),
            "change": {n: float(torch.linalg.vector_norm((out["params"][n] - p0).double()))
                       for n, p0 in reference.leaves(params0)}}


def _tf32(x):
    """x with its float32 values rounded to TF32's 10-bit mantissa (to
    nearest), passing the gradient through unchanged."""
    if not x.is_floating_point():
        return x
    bits = x.detach().float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape).to(x.dtype)
    return x + (rounded - x).detach()


def _plant(plant: str | None, device):
    """Break the program on purpose; returns the undo. On the card "tf32"
    is the program's own TF32 path (``program_config``); the CPU has none,
    so there the program's products take TF32-rounded operands instead."""
    if plant == "tf32" and device == "cpu":
        real = torch.Tensor.__matmul__
        torch.Tensor.__matmul__ = lambda a, b: real(_tf32(a), _tf32(b))
        return lambda: setattr(torch.Tensor, "__matmul__", real)
    if plant in (None, "tf32", "frozen"):
        return lambda: None
    if plant == "half":
        from mgvae_tpu_torch.train import losses

        real = losses.masked_mean

        def half(x, valid, count=None):
            v = valid.to(x.dtype)
            keep = (torch.cumsum(v, 0) <= torch.ceil(v.sum() / 2)).to(x.dtype) * v
            return (x * keep).sum() / keep.sum().clamp(min=1.0)

        losses.masked_mean = half
        return lambda: setattr(losses, "masked_mean", real)
    if plant == "noexchange":
        from mgvae_tpu_torch.train import step

        real = step.mean_
        step.mean_ = lambda *a, **k: None
        return lambda: setattr(step, "mean_", real)
    raise ValueError(f"unknown plant {plant!r}")
