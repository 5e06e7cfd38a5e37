"""Training runtime, on one device or data-parallel over several: the
counterpart of ``mgvae_tpu/train/trainer.py`` (the reference's
trainer.py:20-278).

Public surface as in the JAX package: ``Trainer(args, model_cfg, ...)``,
``set_training_args``, ``weights``, ``train(num_epoch, train_ds, val_ds)``,
``save`` / ``load`` / ``resume``, ``model_epoch``, ``log_dir`` and
``step_times``. What it keeps exactly:

  * the batch order: one shuffle per phase from ``default_rng(seed + 2)``,
    drop_last, so that both packages see the same graphs in each batch;
  * the lr schedule: decay by 0.1 every ``lr_step`` epochs of the global
    ``model_epoch``; ``set_training_args(lr=...)`` resets it;
  * ``model_{e}.pth`` and ``model_last.pth`` in the train phase of every
    tenth epoch, before the val phase; the reference epoch line;
  * the batch layout at one device: with ``fixed_dims`` a running max of the
    padded dims, and on CUDA the smallest chunk count C whose chunks pass
    the fused level kernel's size gate (``ops/level_kernel.kernel_fits``),
    searched only where the level kernels run (``num_rounds == 1``, D <=
    128; else C = 1, as the JAX trainer);
    without it ``collate_fit`` on CUDA and ``collate`` on the CPU; a forced
    split count G runs ``collate_split`` on the stratified layout.

Collation runs in a prefetch thread (no CUDA call): through the native
host library (``mgvae_tpu_torch/native``), whose calls release the GIL,
else numpy; the host-to-device copy stays on the step's thread. The fixed
dims' scan of an epoch is one threaded native call
(``GroupStatsCache.group_dims``) against a stats cache per dataset (two
held, by strong reference: train and val), as in the JAX trainer; without
the library it trial-collates every shard. Both give the same dims.
In grouped phases (below) the thread looks ahead once its phase's items
are made: it plans the phase that follows (val after train, the next
epoch's train after val, across ``train`` calls), on a copy of the plan
state with the same calls in the same order, and collates that phase's
first item while the card runs this phase's last steps; a phase without
steps is planned on the way to the next that has some. The next phase
takes the plan and its state up when it was made for the same dataset and
settings from the trainer's present plan state, else drops it and plans
itself; ``load``, ``set_training_args`` and a phase left early drop it.
The batches are those of planning each phase on the step's thread, bit
for bit. The thread ends once it has looked ahead; what it made is the
trainer's, freed with it.
Metrics stay on the device and are read back once per epoch. Random draws (DG_VAE's noise, the
negatives, the dropout masks) come from one ``torch.Generator`` on the
trainer's device, seeded ``seed + 1``. The epoch line carries `` |KL:``
only when a nonzero KL was metered (DG_VAE), as in the JAX package.

Data parallelism: one process per device, launched by torchrun (or the
JAX package's launch variables, ``parallel.mesh``). Under a launch of W > 1
processes, or with ``distributed`` under a process group of one, the
trainer runs the data-parallel step (``train.step.make_train_step(...,
group=)``): every rank draws the same shuffle and a step takes W *
``batch_size`` graphs, rank r's shard the r-th ``batch_size`` of them;
every rank derives the same running-max dims (and chunk count) from every
shard of the step, without communication, and collates only its own shard
at those dims (split shards at the agreed per-group dims); the step
averages the gradients, the BN running state and the metrics over the
ranks, so every rank logs the same losses. The epoch line, the log file
and the checkpoints are the chief's (rank 0); ``resume`` loads on every
rank. ``distributed`` with ``num_devices`` other than W raises: the port
runs one process per device.

``trace_dir``: the chief captures epoch 0 of every ``train()`` call with
``torch.profiler`` (host and, on the card, device activity) and writes it
into the directory as a TensorBoard / Chrome trace file
(``*.pt.trace.json``) when the epoch ends, or when the call raises. The
capture changes no number. The multi-task subclasses
(``trainer_balancer``, ``trainer_gradnorm``) have their own ``train`` and
capture nothing, as in the JAX package; ``EarlyTrainer`` runs this
``train`` an epoch at a time.

``step_times``: the trainer's span log (``utils/spans``), off while None
(the default: one flag test at each span site, no profiler call). Set to
a list, each phase of ``train`` opens a ``torch.profiler.record_function``
range around each part of its host work, on the profiler's clock, and
appends one entry ``(name, steps done in the phase, host seconds)`` as
each range closes, ``<phase>`` "train" or "val":

  * ``trainer.plan`` -> ``plan:<phase>``: once a phase, the epoch plan
    (the shuffle, the running-max dims scan, the chunk pick), or the wait
    for the plan made ahead and its take-up;
  * ``trainer.prefetch_wait`` -> ``prefetch_wait:<phase>``: the step
    thread blocked on the prefetch queue, for each item and for its end;
    the first wait holds the thread's start and the phase's first item:
    the wait for the one made ahead, else its whole collate;
  * ``trainer.step`` -> ``<phase>``: each K-step or single call, from its
    start to its return, its steps done after it;
  * ``trainer.readback`` -> ``fetch:<phase>``: the epoch's metric rows'
    copy to the host;
  * ``trainer.log`` -> ``log:<phase>``: the meters and the epoch line;
  * ``trainer.save`` -> ``save:<phase>``: the chief's two checkpoints of
    every tenth epoch (train phase);
  * inside each K-step call: ``kstep.stage`` -> ``stage:<phase>``, the fill
    of its pinned staging area, and within it ``kstep.stage_wait`` ->
    ``stage_wait:<phase>``, the wait on the card for that area's last
    copies; ``kstep.capture`` -> ``capture:<phase>``, each CUDA graph
    captured (one where ``_GroupRunner.captures`` counts; never inside the
    capture or the step's body).

A ``trace_dir`` capture turns the same ranges on for its epoch without a
list, so its trace file carries them. The prefetch thread's look-ahead
opens bare ranges while the spans are on, with no entry:
``trainer.plan_ahead`` around each plan it makes ahead and
``trainer.collate_ahead`` around the first item's collate (a ``trace_dir``
capture profiles every thread; a profiler that follows the step's
thread alone does not see them). The multi-task subclasses open none.

``steps_per_call`` K (default 8, as the JAX trainer's): each phase's
steps run in groups of K through the K-step calls
(``train.step.make_multi_step`` / ``make_multi_eval``), the tail step by
step, with the JAX trainer's rules (``mgvae_tpu/train/trainer.py:722-876``):
per step throughout when the dims are free (``fixed_dims=False``), when the
phase has fewer than K steps, and on a multi-host launch (the JAX trainer
groups only when ``jax.process_count() == 1``, mesh or not). The port runs
one process per device, so a single-host launch of W processes is the
counterpart of JAX's one process over W devices and groups; a launch is
multi-host when torchrun's ``WORLD_SIZE`` exceeds its ``LOCAL_WORLD_SIZE``
(any ``WORLD_SIZE > 1`` without ``LOCAL_WORLD_SIZE``), or under the JAX
package's variables when ``NUM_PROCESSES > 1`` (one process per host;
``parallel.mesh.multi_host_launch``). Under a process group each step of a
group is the data-parallel step (``make_multi_step(..., group=)``): rank
r's shard of each of the K steps, collated at the dims every rank agrees
on, and one all-reduce a step. A gloo group on the card (processes sharing
one card) steps singly too: the K-step call's CUDA graph holds NCCL's
all-reduce only. ``step_mode`` says which, on the ``[INFO] Start
training`` line. The prefetch thread collates a whole group in one call
(``collate_shards`` of the K steps as shards, ``collate_split_step`` for
split batches), the bytes each step's own collate would give. On the card each step of a group is a
replay of the step's captured CUDA graph; on the CPU it runs eagerly. The
metrics, the draws and every tensor come out as the per-step run's: bit
for bit on the fused route (the trainer's layouts), and within the order
of the weight gradients' sums on the step and giant routes (``train/step``).
A progress line is printed when ``log_every`` steps have passed since the
last one (a group advances K at once).

Not ported (ROADMAP "Not ported by design"): the packed transfer, the thin
wire and the split layout's pre-grown dims (they change padding only).
"""
from __future__ import annotations

import copy
import functools
import os
import queue
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import (
    GroupStatsCache,
    _partition_by_size,
    _partition_chunks,
    collate,
    collate_chunked,
    collate_fit,
    collate_shards,
    collate_split,
    collate_split_step,
    natural_dims,
    split_dims,
    split_groups_by_shape,
)
from ..models.dg_ae import DGConfig, init_params
from ..native import get_lib
from ..ops.level_kernel import MAX_DIM as KERNEL_MAX_DIM
from ..ops.level_kernel import kernel_fits
from ..parallel.mesh import local_device, maybe_initialize_distributed, multi_host_launch
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logger import AverageMeter, Logger
from ..utils.spans import Spans
from .step import (METRIC_KEYS, make_multi_eval, make_multi_step, make_optimizer,
                   make_train_step, param_leaves, set_lr)

# chunk counts tried on the first step, smallest first (the JAX trainer's)
CHUNK_CANDIDATES = (1, 2, 3, 4, 6, 8)
PREFETCH_DEPTH = 2
# what the epoch plans draw from and grow: the look-ahead plans on a copy
PLAN_STATE = ("_np_rng", "_dims_max", "_chunks", "_split", "_split_dims_max", "_split_layout")


def resolve_device(device) -> torch.device:
    """The trainer's device; "cuda" without a card raises (nothing falls
    back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card unless the caller asks "
                           "for the CPU (device='cpu'; for the CLI, MGVAE_PLATFORM=cpu)")
    return dev


def join_launch(distributed: bool, num_devices, device) -> tuple[int, int]:
    """The launch checks, run before any data is built. Joins the process
    group that the launch variables describe (``parallel.mesh``; a partial
    launch raises RuntimeError) and returns (rank, world size). With
    ``distributed``, ``num_devices`` other than the processes launched
    raises ValueError: the port runs one process per device."""
    rank, world = maybe_initialize_distributed(device)
    if distributed and num_devices and num_devices != world:
        raise ValueError(
            f"--distributed over {num_devices} devices needs {num_devices} processes, one per "
            f"device; this launch has {world}: run torchrun --nproc_per_node {num_devices} "
            "-m mgvae_tpu_torch.train --distributed ...")
    return rank, world


def shard_dims(graphs, num_chunks: int) -> dict:
    """The padded dims of one step's graphs as ``collate`` (C = 1) or each
    chunk of ``collate_chunked`` gives them: the elementwise max of the
    chunks' natural dims."""
    if num_chunks == 1:
        return natural_dims(graphs)
    dl = [natural_dims([graphs[i] for i in b]) for b in _partition_chunks(graphs, num_chunks)]
    return {k: max(d[k] for d in dl) for k in dl[0]}


def _running_max(cur: dict, new: dict) -> bool:
    """Grow ``cur`` to the elementwise max with ``new``; whether it grew."""
    grew = False
    for k, v in new.items():
        if v > cur.get(k, 0):
            cur[k] = v
            grew = True
    return grew


class _Ahead:
    """A phase planned ahead by the previous phase's prefetch thread
    (``Trainer._look_ahead``) for ``dataset`` under ``key``. ``planned`` is
    set once ``plan`` and ``state`` (the plan state after it) or ``error``
    are in, with ``next``, the phase after it, where it has no steps;
    ``made`` once ``first`` (its first item) is in too. ``dropped``, shared
    along the chain, stops the thread making it."""

    def __init__(self, dataset, key: tuple, dropped: threading.Event):
        self.dataset, self.key, self.dropped = dataset, key, dropped
        self.plan = self.state = self.first = self.error = self.next = None
        self.planned, self.made = threading.Event(), threading.Event()


class Trainer:
    def __init__(
        self,
        args,
        model_cfg: DGConfig,
        params=None,
        state=None,
        training_id: str = "default",
        save_dir: str = "./exp",
        lr: float = 1e-4,
        rc_prob_func_weight=(1.0, 4.0, 2.0),
        kl_weight: float = 0.0,
        batch_size: int = 32,
        distributed: bool = True,
        seed: int = 0,
        num_devices: int | None = None,
        log_every: int = 0,
        fixed_dims: bool = True,
        steps_per_call: int = 8,
        split: int | str = "auto",
        device="cuda",
        trace_dir: str | None = None,
    ):
        rank, world = join_launch(distributed, num_devices, device)
        self.device = resolve_device(local_device(device))
        self.args = args
        self.model_cfg = model_cfg
        self.lr = lr
        self.lr_step = -1
        self.rc_prob_func_weight = list(rc_prob_func_weight)
        self.kl_weight = kl_weight
        self.batch_size = batch_size
        self.log_every = log_every
        # Fixed dims: a running max of the padded batch dims (the JAX trainer
        # keeps it to stop recompiles; here it keeps the chunking choice and
        # the batch shapes stable from epoch to epoch)
        self.fixed_dims = fixed_dims
        self._dims_max: dict = {}
        self._chunks: int | None = None     # resolved on the first step
        # split: "auto" resolves to off (on the H100 fit C=3 ranked ahead of
        # split G=4 at bs64, PERF.md); an int forces G groups
        self.split_arg = split
        self._split: int | None = None
        self._split_dims_max: list = []
        self._split_layout: str | None = None   # "stratified" | "uniform"
        # (dataset, its length, GroupStatsCache) of the last two datasets
        # scanned (train and val), held by strong reference: compared with
        # ``is``, so a collected dataset's id can never serve stale stats
        self._stats_caches: list = []
        # the look-ahead (``_look_ahead``): the record of the next phase,
        # planned ahead from the trainer's present plan state, or None; the
        # phases that follow each phase of the running ``train`` call
        self._ahead: _Ahead | None = None
        self._upcoming: dict = {}
        # the span log: a list turns the trainer's spans on (utils/spans)
        self.step_times = None
        self._spans = Spans()
        # with a directory, the chief captures the first epoch of every
        # train() call with torch.profiler into it (a TensorBoard / Chrome
        # trace file), as the JAX trainer captures it with jax.profiler
        self.trace_dir = trace_dir

        self.log_dir = os.path.join(save_dir, training_id)
        os.makedirs(self.log_dir, exist_ok=True)
        self.distributed = distributed
        # the data-parallel group: every process of a launch of several, or
        # with ``distributed`` the group of one that a caller set up
        self.group = (dist.group.WORLD if dist.is_initialized() and (distributed or world > 1)
                      else None)
        self.num_devices = world
        self.rank = rank
        self.is_chief = rank == 0

        if params is None:
            params, state = init_params(model_cfg, seed=seed, device=self.device)
        self.params, self.state = params, state
        self.optimizer = make_optimizer(self.params, lr)
        self.train_step, self.eval_step = make_train_step(model_cfg, self.optimizer,
                                                          group=self.group)
        self.steps_per_call = max(int(steps_per_call), 1)
        self.multi_step = make_multi_step(model_cfg, self.optimizer, group=self.group)
        self.multi_eval = make_multi_eval(model_cfg, group=self.group)
        # the K-step calls time their staging and captures into the trainer's spans
        self.multi_step.spans = self.multi_eval.spans = self._spans
        self.grouped, self.step_mode = self._step_mode()
        self.model_epoch = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._np_rng = np.random.default_rng(seed + 2)

        self.logger = None
        if self.is_chief:
            time_str = time.strftime("%Y-%m-%d-%H-%M")
            self.logger = Logger(os.path.join(self.log_dir, f"log-{time_str}.txt"))
            mode = ("single device" if self.group is None
                    else f"data-parallel over {world} process(es), one device each")
            print(f"[INFO] Training {mode}; device={self.device}")

    def _step_mode(self) -> tuple[bool, str]:
        """(grouped, why): how the phases' steps run, by the JAX trainer's rule
        (``use_multi = ... jax.process_count() == 1``,
        ``mgvae_tpu/train/trainer.py:870``): in groups of ``steps_per_call``
        on a single-host launch, with or without a process group; one step a
        call on a multi-host launch (``parallel.mesh.multi_host_launch``) and
        under a group whose all-reduce a CUDA graph cannot hold (gloo on the
        card)."""
        K = self.steps_per_call
        if K == 1:
            return False, "per step (steps_per_call 1)"
        if self.group is not None and multi_host_launch():
            return False, "per step: a multi-host launch, as the JAX trainer's across hosts"
        if (self.group is not None and self.device.type == "cuda"
                and dist.get_backend(self.group) != "nccl"):
            return False, (f"per step: a {dist.get_backend(self.group)} group on the card (the "
                           "K-step call's CUDA graph holds NCCL's all-reduce only)")
        return True, f"grouped: {K} steps a call"

    # ------------------------------------------------------------------
    def set_training_args(self, rc_prob_func_weight=(), lr: float = -1, lr_step: int = -1,
                          kl_weight: float = None):
        if len(rc_prob_func_weight) == 3 and list(rc_prob_func_weight) != self.rc_prob_func_weight:
            print(f"[INFO] Update rc_prob_func_weight from {self.rc_prob_func_weight} to {list(rc_prob_func_weight)}")
            self.rc_prob_func_weight = list(rc_prob_func_weight)
        if lr > 0 and lr != self.lr:
            print(f"[INFO] Update learning rate from {self.lr} to {lr}")
            self.lr = lr
            set_lr(self.optimizer, lr)
        if lr_step > 0 and lr_step != self.lr_step:
            print(f"[INFO] Update learning rate step from {self.lr_step} to {lr_step}")
            self.lr_step = lr_step
        if kl_weight is not None:
            self.kl_weight = kl_weight
        self._drop_ahead()

    @property
    def weights(self) -> list:
        return self.rc_prob_func_weight + [self.kl_weight]

    # ------------------------------------------------------------------
    def save(self, path: str):
        """The chief writes the checkpoint; the other ranks hold the same
        params, BN state and Adam state."""
        if self.is_chief:
            save_checkpoint(path, self.model_epoch, self.params, self.state,
                            self.optimizer.state_dict(), self.lr)

    def load(self, path: str):
        """Restore params (copied into the optimizer's own tensors), BN
        state, Adam state, ``model_epoch`` and lr from ``path``, a checkpoint
        of this package or of the JAX package (``utils/checkpoint``). The rngs
        are not restored, as in the JAX package."""
        epoch, lr, params, state = load_checkpoint(path, self.params, self.state,
                                                   self.optimizer, self.device)
        with torch.no_grad():
            for dst, src in zip(param_leaves(self.params), param_leaves(params), strict=True):
                if dst is not src:
                    dst.copy_(src)
        self.state = state
        self.model_epoch = epoch
        self.lr = lr
        set_lr(self.optimizer, lr)
        self._drop_ahead()
        print(f"[INFO] Continue training from epoch {self.model_epoch}")
        return path

    def resume(self) -> bool:
        path = os.path.join(self.log_dir, "model_last.pth")
        if os.path.exists(path):
            self.load(path)
            return True
        return False

    # ------------------------------------------------------------------
    def _epoch_plan(self, dataset):
        """The epoch's plan made on the caller's thread (``_plan``), after
        dropping whatever was planned ahead."""
        self._drop_ahead()
        return self._plan(dataset)

    def _plan(self, dataset):
        """The epoch's shuffled ids, step count, dims (None, a dict, or one
        dict per split group) and chunk count."""
        idx = np.arange(len(dataset))
        self._np_rng.shuffle(idx)
        n_steps = len(idx) // (self.batch_size * self.num_devices)
        if n_steps == 0 and len(dataset) and self.is_chief:
            print(
                f"[WARN] dataset of {len(dataset)} graphs yields 0 steps at "
                f"batch_size {self.batch_size} x {self.num_devices} device(s) "
                "(drop_last) — epoch will be empty"
            )
        dims = None
        if self.fixed_dims:
            if self._split is None and n_steps:  # defer on empty epochs
                self._split = (max(self.split_arg, 1) if isinstance(self.split_arg, int) else 1)
                if self._split > 1:
                    print(f"[INFO] fixed-dims: splitting each shard into {self._split} "
                          "shape-sorted groups (collate_split)")
            if self._split is not None and self._split > 1:
                if self._split_layout != "uniform":
                    sidx = self._stratified_perm(dataset, n_steps)
                    if self._split_layout is None:
                        self._split_layout = "uniform" if sidx is None else "stratified"
                    if sidx is not None:
                        idx = sidx
                dims = self._update_split_dims(dataset, idx, n_steps)
            else:
                dims = self._update_dims_max(dataset, idx, n_steps)
        return idx, n_steps, dims, (self._chunks or 1)

    def _get_stats_cache(self, dataset):
        """The dataset's ``GroupStatsCache``, built on its first scan; None
        when the native library is unavailable."""
        if get_lib() is None:
            return None
        for ds_ref, ds_len, cache in self._stats_caches:
            if ds_ref is dataset and ds_len == len(dataset):
                return cache
        cache = GroupStatsCache([dataset[i] for i in range(len(dataset))])
        self._stats_caches.append((dataset, len(dataset), cache))
        if len(self._stats_caches) > 2:
            self._stats_caches.pop(0)
        return cache

    def _shape_sort_ids(self, dataset) -> np.ndarray:
        """Dataset ids sorted by the split shape key (max level, edges,
        nodes): the order whose contiguous quantiles are the strata."""
        cache = self._get_stats_cache(dataset)
        if cache is not None:
            return np.lexsort((cache.n, cache.e, cache.lmax))
        lmax = np.array([int(dataset[i].forward_level.max(initial=0))
                         for i in range(len(dataset))])
        e = np.array([dataset[i].num_edges for i in range(len(dataset))])
        n = np.array([dataset[i].num_nodes for i in range(len(dataset))])
        return np.lexsort((n, e, lmax))

    def _stratified_perm(self, dataset, n_steps):
        """Split-mode epoch layout: G contiguous shape strata, each shuffled,
        every shard drawn from its per-stratum quota, so that a shard's
        shape-sorted group g is a random subset of stratum g. Every graph
        still appears once per epoch. None when a stratum cannot fill its
        quota."""
        G = self._split
        order = self._shape_sort_ids(dataset)
        strata = [s[self._np_rng.permutation(len(s))] for s in np.array_split(order, G)]
        sizes = [len(a) for a in np.array_split(np.arange(self.batch_size), G)]
        n_shards = n_steps * self.num_devices
        if any(n_shards * m > len(s) for m, s in zip(sizes, strata)):
            return None
        shards = [np.concatenate([strata[g][j * sizes[g]:(j + 1) * sizes[g]] for g in range(G)])
                  for j in range(n_shards)]
        used = np.concatenate(shards) if shards else np.zeros(0, np.int64)
        rest = np.setdiff1d(order, used, assume_unique=True)
        return np.concatenate([used, rest]).astype(np.int64)

    def _shard_ids(self, idx, steps):
        """Every rank's shard of each of ``steps``, as dataset ids: the same
        on every rank."""
        bs, w = self.batch_size, self.num_devices
        return [idx[j * bs:(j + 1) * bs] for s in steps for j in range(s * w, (s + 1) * w)]

    def _shards(self, dataset, idx, steps):
        return [[dataset[i] for i in ids] for ids in self._shard_ids(idx, steps)]

    def _split_scan(self, dataset, idx, n_steps) -> list:
        """The per-group dims of this epoch's shards, maxed over the shards
        for each group position: one native call over every (shard, group)
        against the stats cache, else ``split_dims``' trial collates."""
        G = self._split
        cache = self._get_stats_cache(dataset)
        if cache is None:
            return split_dims(self._shards(dataset, idx, range(n_steps)), G)
        groups = [ids[part] for ids in self._shard_ids(idx, range(n_steps))
                  for part in split_groups_by_shape(cache.lmax[ids], cache.e[ids],
                                                    cache.n[ids], G)]
        dl = cache.group_dims(groups)
        # groups were appended shard-major: position g of shard j is j * G + g
        return [{k: max(d[k] for d in dl[g::G]) for k in dl[g]} for g in range(G)]

    def _update_split_dims(self, dataset, idx, n_steps):
        """Running max of the per-group dims over this epoch's shards."""
        if n_steps:
            dl = self._split_scan(dataset, idx, n_steps)
            if not self._split_dims_max:
                self._split_dims_max = [{} for _ in dl]
            for cur, new in zip(self._split_dims_max, dl):
                _running_max(cur, new)
        return [dict(d) for d in self._split_dims_max] or None

    def _scan_dims(self, dataset, idx, num_chunks: int, steps) -> dict:
        """The max of the padded dims of every shard of ``steps`` (of each
        of its chunks, for C > 1): one native call over every (shard,
        chunk) group against the stats cache, else a trial collate each."""
        cache = self._get_stats_cache(dataset)
        if cache is None:
            dmax: dict = {}
            for shard in self._shards(dataset, idx, steps):
                _running_max(dmax, shard_dims(shard, num_chunks))
            return dmax
        groups = []
        for ids in self._shard_ids(idx, steps):
            if num_chunks == 1:
                groups.append(ids)
            else:
                groups.extend(ids[b] for b in _partition_by_size(cache.n[ids], num_chunks))
        if not groups:
            return {}
        dl = cache.group_dims(groups)
        return {k: max(d[k] for d in dl) for k in dl[0]}

    def _chunks_searched(self) -> bool:
        """Whether a chunk count is searched at all: on the card, for the
        level kernels' route (``num_rounds == 1``) at a width they take. The
        JAX trainer returns C = 1 off its kernels' backend and for
        ``num_rounds != 1``, and past D = 128 no C passes its gate."""
        cfg = self.model_cfg
        return (self.device.type == "cuda" and cfg.num_rounds == 1
                and cfg.dim_hidden <= KERNEL_MAX_DIM)

    def _pick_chunks(self, dataset, idx, n_steps) -> int:
        """The smallest C whose per-chunk dims on the first step pass
        ``kernel_fits``; 1 where no chunk count is searched (the CPU, whose
        plain path has no size gate, ``num_rounds > 1`` and D > 128)."""
        if not self._chunks_searched():
            return 1
        for C in CHUNK_CANDIDATES:
            if C > max(self.batch_size // 2, 1):
                break
            d = self._scan_dims(dataset, idx, C, range(min(n_steps, 1)))
            if kernel_fits(d["N"], d["EP"], d["NP"], self.model_cfg.dim_hidden):
                if C > 1:
                    print(f"[INFO] fixed-dims: collating each shard as {C} kernel-sized chunks")
                return C
        return 1

    def _update_dims_max(self, dataset, idx, n_steps) -> dict:
        """Grow the running dims max over this epoch's shards; on the first
        step pick the chunk count, and pick it again only when the max grows
        past the kernel's size gate."""
        if self._chunks is None and n_steps:
            self._chunks = self._pick_chunks(dataset, idx, n_steps)
        C = self._chunks or 1
        grew = _running_max(self._dims_max, self._scan_dims(dataset, idx, C, range(n_steps)))
        if grew and self._chunks_searched() and not kernel_fits(
                self._dims_max["N"], self._dims_max["EP"], self._dims_max["NP"],
                self.model_cfg.dim_hidden):
            new_c = self._pick_chunks(dataset, idx, n_steps)
            if new_c != self._chunks:
                self._chunks = new_c
                self._dims_max = self._scan_dims(dataset, idx, new_c, range(n_steps))
        return dict(self._dims_max)

    def _collate_step(self, graphs, dims, num_chunks: int) -> dict:
        if isinstance(dims, list):  # split mode: per-group dims
            return collate_split(graphs, len(dims), dims=dims)
        if dims is None and self.device.type == "cuda":
            # free dims: chunk big batches so that each chunk takes the fused kernels
            return collate_fit(graphs)
        if num_chunks > 1:
            return collate_chunked(graphs, num_chunks, dims=dims)
        return collate(graphs, dims=dims)

    def _prefetch(self, items, ahead=None, upcoming=(), use_multi=False):
        """The phase's items, made by calling each of ``items`` (host
        batches: the native library or numpy, no CUDA call) in a prefetch
        thread PREFETCH_DEPTH items ahead; first ``ahead.first`` where the
        previous phase's thread made the first item ahead. An error in the
        thread is raised here; closing the generator early stops the thread.
        With ``upcoming`` (the datasets of the phases that follow), the
        thread then looks ahead (``_look_ahead``) from this phase's plan
        state, on past the phase's end; the record of the first is the
        trainer's ``_ahead`` from the start, so that the next phase finds it."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        stop = threading.Event()
        nxt = state = None
        if upcoming:
            state = self._plan_state()
            nxt = _Ahead(upcoming[0], self._phase_key(upcoming[0], use_multi), threading.Event())
            self._ahead = nxt

        def producer():
            end = RuntimeError("the prefetch thread stopped before the epoch's end")
            try:
                for make in items:
                    if stop.is_set():
                        return
                    q.put(make())
                end = None
            except Exception as e:  # handed to the consumer, which raises it
                end = e
            finally:
                q.put(end)
            if end is None and nxt is not None:
                self._look_ahead(nxt, state, upcoming, use_multi)

        t = threading.Thread(target=producer, name="mgvae-prefetch", daemon=True)
        done = False
        try:
            # the first wait holds the thread's start: the thread may keep
            # the GIL through the Python of its first collate
            with self._spans("trainer.prefetch_wait"):
                t.start()
                if ahead is None:
                    b = q.get()
                else:
                    ahead.made.wait()
                    if ahead.error is not None:
                        raise ahead.error
                    b, ahead.first = ahead.first, None
            while b is not None:
                if isinstance(b, BaseException):
                    raise b
                yield b
                with self._spans("trainer.prefetch_wait"):
                    b = q.get()
            done = True
        finally:
            if not done:    # left early or raised: nothing is planned ahead of it
                stop.set()
                self._drop_ahead()
                while t.is_alive():  # unblock a pending put until the thread returns
                    try:
                        q.get(timeout=0.05)
                    except queue.Empty:
                        pass

    def _step_graphs(self, dataset, idx, s: int) -> list:
        """This rank's shard of step ``s``."""
        bs, j = self.batch_size, s * self.num_devices + self.rank
        return [dataset[i] for i in idx[j * bs:(j + 1) * bs]]

    def _phase_items(self, dataset, plan, use_multi: bool) -> list:
        """The calls that make the phase's items under ``plan``, in order:
        ("group", (stacked host batch, K)) for each group of K =
        ``steps_per_call`` steps, collated in one call with the K steps as
        shards, then ("single", host batch) for each step of the tail; every
        step singly without ``use_multi``, with free dims, or when the epoch
        has fewer than K steps (the JAX trainer's ``_iter_grouped``)."""
        idx, n_steps, dims, C = plan
        K = self.steps_per_call
        starts, singles = range(0), range(n_steps)
        if use_multi and dims is not None and n_steps >= K:
            starts = range(0, n_steps - K + 1, K)
            singles = range(len(starts) * K, n_steps)

        def group(s0):
            shards = [self._step_graphs(dataset, idx, s) for s in range(s0, s0 + K)]
            if isinstance(dims, list):   # split: per-group dims
                return "group", (collate_split_step(shards, dims), K)
            return "group", (collate_shards(shards, dims=dims, num_chunks=C), K)

        def single(s):
            return "single", self._collate_step(self._step_graphs(dataset, idx, s), dims, C)

        return ([functools.partial(group, s0) for s0 in starts]
                + [functools.partial(single, s) for s in singles])

    def _iter_batches(self, dataset):
        """Host batches of one epoch, one per step, collated in the prefetch
        thread (the multi-task trainers' epochs; nothing is planned ahead)."""
        for _, batch in self._iter_grouped(dataset, False):
            yield batch

    def _iter_grouped(self, dataset, use_multi: bool, upcoming=()):
        """The items of one epoch (``_phase_items``), collated in the
        prefetch thread. The plan, and the first item, are the ones the
        previous phase's thread made ahead for this phase (``_take_ahead``),
        else the plan is made here; with ``upcoming``, this phase's thread
        then plans those phases in turn and collates the first item of the
        first that has steps."""
        with self._spans("trainer.plan"):
            ahead = self._take_ahead(dataset, use_multi)
            plan = self._epoch_plan(dataset) if ahead is None else ahead.plan
        items = self._phase_items(dataset, plan, use_multi)
        if ahead is not None and not items and self._ahead is not None:
            return iter(())     # planned on the way to the next, which is being made
        first = ahead is not None and bool(items)
        return self._prefetch(items[first:], ahead if first else None, upcoming, use_multi)

    # ------------------------------------------------------------------
    # the look-ahead: the next phase planned and its first item collated
    # in the prefetch thread while the card runs this phase's last steps
    def _phase_key(self, dataset, use_multi: bool) -> tuple:
        """What a phase's plan and items depend on besides the dataset
        object and the plan state."""
        return (len(dataset), use_multi, self.batch_size, self.num_devices, self.rank,
                self.steps_per_call, self.fixed_dims, self.split_arg, self.device,
                self.model_cfg)

    def _plan_state(self) -> dict:
        """A copy of what the epoch plans draw from and grow: the shuffle
        stream, the running-max dims, the chunk count and the split state."""
        return copy.deepcopy({k: getattr(self, k) for k in PLAN_STATE})

    def _look_ahead(self, rec, state, upcoming, use_multi: bool):
        """In the prefetch thread, once its phase's items are made: plan
        the phases of ``upcoming`` in turn, from the plan state ``state``, on
        a shallow copy of the trainer that holds it (the trainer's own is
        untouched until the step thread takes a phase up), and collate the
        first item of the first with steps. ``rec`` is the first's record;
        a phase without steps links the next one's before its plan is
        published. An error is kept in the record and raised by the phase
        that takes it up."""
        planner = copy.copy(self)
        planner.__dict__.update(state)
        for i, dataset in enumerate(upcoming):
            nxt, items = None, ()
            try:
                if rec.dropped.is_set():
                    return
                with self._spans.range_only("trainer.plan_ahead"):
                    rec.plan = planner._plan(dataset)
                rec.state = planner._plan_state()
                items = planner._phase_items(dataset, rec.plan, use_multi)
                if not items and i + 1 < len(upcoming):
                    nxt = rec.next = _Ahead(upcoming[i + 1],
                                            planner._phase_key(upcoming[i + 1], use_multi),
                                            rec.dropped)
                rec.planned.set()
                if items and not rec.dropped.is_set():
                    with self._spans.range_only("trainer.collate_ahead"):
                        rec.first = items[0]()
            except Exception as e:  # raised on the step thread at the phase that uses it
                rec.error = e
            finally:
                rec.planned.set()
                rec.made.set()
            if nxt is None:
                return
            rec = nxt

    def _take_ahead(self, dataset, use_multi: bool):
        """This phase's record when the look-ahead made it for this dataset
        and these settings: waits for its plan, makes the plan state after
        it the trainer's and its ``next`` the trainer's ``_ahead``. Else
        None, with whatever was planned ahead dropped. A record is always
        planned from the trainer's present plan state: each plan on the
        step's thread drops it first, and only a take-up moves the state."""
        rec = self._ahead
        if rec is None or rec.dataset is not dataset or rec.key != self._phase_key(dataset,
                                                                                   use_multi):
            self._drop_ahead()
            return None
        rec.planned.wait()
        self._ahead = rec.next
        if rec.plan is None:
            raise rec.error
        self.__dict__.update(rec.state)
        return rec

    def _drop_ahead(self):
        """Forget the phases planned ahead; their thread stops before its
        next plan or collate. The trainer's plan state was never theirs."""
        if self._ahead is not None:
            self._ahead.dropped.set()
            self._ahead = None

    # ------------------------------------------------------------------
    def _start_trace(self):
        """A started torch.profiler capture of the host (every thread: the
        prefetch thread's look-ahead ranges too) and, on the card, the
        device, written into ``trace_dir`` by TensorBoard's trace handler
        when it stops; None without ``trace_dir`` or off the chief."""
        if not (self.trace_dir and self.is_chief):
            return None
        from torch.profiler import (ProfilerActivity, _ExperimentalConfig, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        trace = profile(activities=activities,
                        on_trace_ready=tensorboard_trace_handler(self.trace_dir),
                        experimental_config=_ExperimentalConfig(profile_all_threads=True))
        trace.start()
        return trace

    def _run_phase(self, phase: str, ds, epoch: int, num_epoch: int, weights):
        """One phase of one epoch: its steps, its meters and its epoch line;
        returns (meters, whether it had a step). ``train`` turns the spans
        (``utils/spans``) on for the phase, or leaves them off."""
        spans = self._spans
        meters = {k: AverageMeter() for k in ("recon", "prob", "func", "kl", "acc", "tp", "fp", "tn", "fn", "time")}
        # metrics stay on the device, one [9] row per step, read back
        # once at the epoch's end: a read per step would wait for the
        # device on every step of a host-bound loop
        pending = []
        steps_done = 0
        last_logged = 0
        t0 = time.time()
        for kind, item in self._iter_grouped(ds, self.grouped, self._upcoming.get(phase, ())):
            with spans("trainer.step"):
                if kind == "group":
                    sbatch, k = item
                    if phase == "train":
                        self.state, rows = self.multi_step(self.params, self.state, sbatch,
                                                           self._gen, weights)
                    else:
                        rows = self.multi_eval(self.params, self.state, sbatch, self._gen,
                                               weights)
                else:
                    k = 1
                    if phase == "train":
                        self.state, m = self.train_step(self.params, self.state, item,
                                                        self._gen, weights)
                    else:
                        m = self.eval_step(self.params, self.state, item, self._gen, weights)
                    rows = torch.stack([m[key] for key in METRIC_KEYS])[None]
                pending.append(rows)
                steps_done += k
                spans.steps = steps_done
                if (self.log_every and self.is_chief
                        and steps_done - last_logged >= self.log_every):
                    last_logged = steps_done
                    mm = dict(zip(METRIC_KEYS, pending[-1][-1].tolist()))
                    print(
                        f"[{phase} {self.model_epoch}] {epoch}/{num_epoch} it {steps_done} "
                        f"|Recon: {mm['recon_loss']:.4f} |Prob: {mm['prob_loss']:.4f} "
                        f"|Func: {mm['func_loss']:.4f}"
                    )
        with spans("trainer.readback"):
            rows = (torch.cat(pending).cpu().numpy() if pending
                    else np.zeros((0, len(METRIC_KEYS)), np.float32))
        with spans("trainer.log"):
            for row in rows:
                m = dict(zip(METRIC_KEYS, (float(x) for x in row)))
                n_pred = max(m["n_pred"], 1.0)
                meters["recon"].update(m["recon_loss"])
                meters["prob"].update(m["prob_loss"])
                meters["func"].update(m["func_loss"])
                meters["kl"].update(m["kl_loss"])
                meters["acc"].update((m["tp"] + m["tn"]) / n_pred)
                meters["tp"].update(m["tp"] / n_pred)
                meters["fp"].update(m["fp"] / n_pred)
                meters["tn"].update(m["tn"] / n_pred)
                meters["fn"].update(m["fn"] / n_pred)
            meters["time"].update((time.time() - t0) / max(steps_done, 1), n=max(steps_done, 1))
            # reference epoch-line format (trainer.py:208-212); the KL
            # field only when a nonzero KL was metered
            kl_part = (" |KL: {:.4f}".format(meters["kl"].avg)
                       if meters["kl"].avg else "")
            if self.logger is not None:
                self.logger.write(
                    "{}| Epoch: {:}/{:} |Recon: {:.4f} |ACC: {:.2f} |Prob: {:.4f} |Func: {:.4f}{}|Net: {:.2f}s\n".format(
                        phase, epoch, num_epoch, meters["recon"].avg, meters["acc"].avg * 100,
                        meters["prob"].avg, meters["func"].avg, kl_part, meters["time"].avg,
                    )
                )
        if phase == "train" and self.model_epoch % 10 == 0 and self.is_chief:
            with spans("trainer.save"):
                self.save(os.path.join(self.log_dir, f"model_{self.model_epoch}.pth"))
                self.save(os.path.join(self.log_dir, "model_last.pth"))
        return meters, bool(pending)

    def train(self, num_epoch: int, train_dataset, val_dataset):
        weights = self.weights
        print(f"[INFO] Start training, lr = {self.lr:.6f}; steps {self.step_mode}")
        phase_meters = {}
        meters = None
        # what follows each phase, for the prefetch thread's look-ahead: val
        # after train, the next epoch's train (this call's or the next's)
        # after val; grouped phases only
        self._upcoming = ({"train": (val_dataset, train_dataset),
                           "val": (train_dataset, val_dataset)} if self.grouped else {})
        trace = self._start_trace()
        try:
            for epoch in range(num_epoch):
                for phase, ds in (("train", train_dataset), ("val", val_dataset)):
                    with self._spans.recording(self.step_times, phase, ranges=trace is not None):
                        meters, ran = self._run_phase(phase, ds, epoch, num_epoch, weights)
                    phase_meters[phase] = meters if ran else phase_meters.get(phase, meters)
                if trace is not None:   # capture only the first epoch of this call
                    trace.stop()
                    trace = None
                self.model_epoch += 1
                if self.lr_step > 0 and self.model_epoch % self.lr_step == 0:
                    self.lr *= 0.1
                    print(f"[INFO] Learning rate decay to {self.lr}")
                    set_lr(self.optimizer, self.lr)
        finally:
            if trace is not None:   # an exception stops the capture too
                trace.stop()
        if not num_epoch:
            return {}
        # last epoch's meters: val phase when it had batches, else train
        # (the val split can be smaller than batch_size under drop_last)
        val_empty = not phase_meters.get("val", meters)["recon"].count
        if val_empty and not getattr(self, "_warned_empty_val", False):
            self._warned_empty_val = True
            print(
                "[WARN] validation split smaller than batch_size: the val "
                "epoch is empty under drop_last (reference parity) — "
                "returned metrics fall back to TRAIN meters. Early stopping "
                "on these stops on training loss, not validation loss."
            )
        best = phase_meters.get("train", meters) if val_empty else phase_meters.get("val")
        out = {k: v.avg for k, v in best.items()}
        out["train"] = {k: v.avg for k, v in phase_meters.get("train", meters).items()}
        out["val"] = {k: v.avg for k, v in phase_meters.get("val", meters).items()}
        return out
