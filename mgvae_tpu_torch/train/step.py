"""Train and eval steps on one device.

Counterpart of the single-device path of ``mgvae_tpu/train/step.py``: one
step is the forward (struct towers, level statics, level recurrence), the
recon, prob and func losses, the backward and an Adam update, on a plain, a
chunked or a split host batch (``models/dg_ae.forward``); the losses read
the batch's top-level arrays and stay global. PyTorch runs it eagerly; on
CUDA the struct towers and the level recurrence, forward and backward, are
the hand-written kernels (autograd Functions in ``ops/struct_kernel`` and
``ops/level_kernel``).

Loss weights are [w_recon, w_prob, w_func, w_kl]; the KL term is DG_VAE's
(``cfg.variational``) and 0 otherwise. Random draws (the variational noise,
the negatives, the dropout masks) come from one ``torch.Generator`` in that
order, or are passed in.

Data parallelism (``make_train_step(..., group=)``, the JAX package's mesh
path, ``mgvae_tpu/train/step.py:158-219``): each process runs the
single-device step on its own shard, with its own draws (the generator
folded by its rank in the group, ``fold_generator``), and between
``backward()`` and the optimizer step ONE all-reduce of the gradients, the
BatchNorm running state and the metrics, each divided by the group's size:
every rank then takes the same Adam step and reports the same metrics.

The K-step calls (``make_multi_step`` / ``make_multi_eval``, the JAX
package's ``mgvae_tpu/train/step.py:222-313``): K optimizer (or eval) steps
on a batch stacked on a leading step axis, metrics as a [K, 9] block. On
the card each is ONE captured CUDA graph of the step per batch layout,
replayed once per step: the struct towers' and the level recurrence's
hand-written kernels, the losses, the backward and a capturable Adam
update, with the trainer's generator registered, so that K replays draw
what K eager steps draw. The first step of a new layout runs eagerly, as a
real step, before the capture. On the CPU the same steps run eagerly.
Under a data-parallel group (``group=``, the JAX package's ``mesh=``) each
step draws from the rank's folded generator and runs ``train_step``'s one
all-reduce between its backward and its optimizer step; on the card that
NCCL all-reduce is captured in the step's graph and replayed with it.
What a captured collective over several ranks needs (NCCL 2.28, torch
2.11): the group's communicator must exist before the capture
(ProcessGroupNCCL makes it at the group's first collective, which no
capture may hold; the eager warm-up step's all-reduce makes it on every
rank); the capture refuses only its own thread's unsafe calls
(``capture_error_mode="thread_local"``), as the process group's watchdog
thread queries its events meanwhile; the capture runs on a stream of the
rank's own card (the runner's: ``torch.cuda.graph``'s default capture
stream is made once, on whichever card is current at its first use); and
the ranks' collectives must pair up in order. Each step, eager or
replayed, issues exactly one all-reduce of one flat fp32 buffer whose size
the model fixes, so they pair step by step as long as every rank runs the
same steps, as the trainer gives them; a layout recaptured after an
eviction (``GRAPHS_KEPT``) adds no collective. On four cards of one host
each replay enqueues one ``ncclDevKernel_AllReduce_Sum_f32_RING_LL`` and
the replays equal the eager steps bit for bit on every rank
(``examples/dryrun_multichip.py`` (b)).
Either way a step walks every row of its level tables (``table_levels``:
shapes alone fix the walk), where ``train_step`` walks the real levels;
a padding level has no valid slot, so on the fused route (kernels 1 and 2,
the trainer's) both give the same bits (with L <= 128 levels; past that
kernel 2's blocks of levels regroup). On the step and giant routes their
backwards take blocks of levels from the top, which shift with the walk
unless the padding levels fill whole blocks, so there the K-step call and
``train_step`` may differ by the order of the weight gradients' sums.

Not ported: ``rehydrate`` / ``rehydrate_split``, which rebuild on the
device what the JAX package's thin host-to-device wire drops (the port
sends whole batches).
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..models import dg_ae
from ..models.dg_ae import DGConfig
from ..ops import level_kernel, struct_kernel
from ..ops.precision import matmul_precision
from ..parallel import collectives
from ..parallel.collectives import mean_
from .losses import func_loss, kl_loss, prob_loss, recon_loss

# epoch-metric row layout, as in the JAX package
METRIC_KEYS = ("recon_loss", "prob_loss", "func_loss", "kl_loss",
               "tp", "fp", "tn", "fn", "n_pred")


def param_leaves(tree) -> list:
    """The tensors of a params tree, in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam over the params tree's leaves (made to require grad) with torch's
    defaults, betas (0.9, 0.999) and eps 1e-8: the update rule of
    ``optax.adam``. On the card it is ``capturable`` with the lr as a device
    tensor, so that a captured step (``make_multi_step``) reads the lr that
    ``set_lr`` writes; the per-step path takes the same optimizer, so both
    update alike. A loaded state dict (``load_state_dict``) keeps these
    settings: only the lr's value and the moments come from it."""
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    if leaves[0].is_cuda:
        opt = torch.optim.Adam(leaves, lr=torch.tensor(float(lr), device=leaves[0].device),
                               betas=(0.9, 0.999), eps=1e-8, capturable=True, foreach=True)
    else:
        opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    own = [{k: g[k] for k in ("lr", "capturable", "foreach")} for g in opt.param_groups]

    def keep_own_settings(optimizer):
        for group, mine in zip(optimizer.param_groups, own, strict=True):
            lr_now = float(group["lr"])
            group.update(mine)
            _set_group_lr(group, lr_now)
        if own[0]["capturable"]:
            for p, st in optimizer.state.items():
                if "step" in st:
                    st["step"] = st["step"].to(dtype=torch.float32, device=p.device)

    opt.register_load_state_dict_post_hook(keep_own_settings)
    return opt


def _set_group_lr(group: dict, lr: float) -> None:
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(lr)
    else:
        group["lr"] = lr


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The lr of every group; a device lr is written in place, where a
    captured step reads it."""
    for group in optimizer.param_groups:
        _set_group_lr(group, lr)


def losses_from_forward(params, state, b: dict, hs, hf, gen, weights, cfg: DGConfig,
                        train: bool, neg_edges=None, drop_keep=None, aux=None):
    """The losses of one forward's (hs, hf, aux) on the device batch ``b``;
    returns (total, (new_state, metrics))."""
    rc, metrics = recon_loss(params, hs, b, gen, neg_edges=neg_edges,
                             mask_collisions=cfg.neg_collision_mask)
    pl, new_state = prob_loss(params, state, hf, b, train, gen, drop_keep=drop_keep)
    fl = func_loss(hf, b)
    kl = (kl_loss(aux, b) if cfg.variational
          else torch.zeros((), dtype=hs.dtype, device=hs.device))
    w = [float(x) for x in weights]
    total = w[0] * rc + w[1] * pl + w[2] * fl + w[3] * kl
    metrics = dict(metrics)
    metrics.update(recon_loss=rc.detach(), prob_loss=pl.detach(), func_loss=fl.detach(),
                   kl_loss=kl.detach(), loss=total.detach())
    return total, (new_state, metrics)


def loss_and_metrics(params, state, batch: dict, gen, weights, cfg: DGConfig, train: bool,
                     neg_edges=None, drop_keep=None, vae_eps=None):
    """Forward and losses of a host batch; returns (total, (new_state,
    metrics)). ``neg_edges``, ``drop_keep`` and ``vae_eps`` replace the
    draws from ``gen`` (the parity tests pass the JAX package's)."""
    device = params["hs_linear"]["w"].device
    return loss_and_metrics_device(params, state, dg_ae.batch_to_device(batch, device),
                                   dg_ae.level_counts(batch), gen, weights, cfg, train,
                                   neg_edges=neg_edges, drop_keep=drop_keep, vae_eps=vae_eps)


def loss_and_metrics_device(params, state, b: dict, n_levels, gen, weights, cfg: DGConfig,
                            train: bool, neg_edges=None, drop_keep=None, vae_eps=None):
    """``loss_and_metrics`` of a batch on the device with the level counts
    to walk (``dg_ae.level_counts`` or ``dg_ae.table_levels``)."""
    hs, hf, aux = dg_ae.forward_device(params, b, cfg, n_levels, gen=gen, vae_eps=vae_eps)
    return losses_from_forward(params, state, b, hs, hf, gen, weights, cfg, train,
                               neg_edges=neg_edges, drop_keep=drop_keep, aux=aux)


# rank r's stream of each base generator (``fold_generator``): one per
# (generator, rank), shared by every step function that draws from it; by
# the base generator's id, with the generator held (torch's Generator takes
# no weak reference), so an id is never reused while its entry lives
_FOLDED: dict = {}


def fold_generator(gen, rank: int):
    """The draws of rank ``rank``: ``gen`` itself at rank 0 (so that one
    rank draws what the single-device step draws), else a generator on
    ``gen``'s device seeded from ``gen``'s seed and the rank, made on the
    rank's first draw: the stream counterpart of the JAX step's
    ``fold_in(rng, axis_index("dp"))``. The folded generator is one per
    (``gen``, rank), kept for the life of the process: ``train_step``,
    ``eval_step`` and the K-step calls of one trainer draw from the same
    stream, so that a grouped epoch draws what the per-step epoch draws on
    every rank. None stays None (the caller passes its draws)."""
    if gen is None or rank == 0:
        return gen
    mine = _FOLDED.setdefault(id(gen), (gen, {}))[1]
    if rank not in mine:
        seed = (gen.initial_seed() + rank * 0x9E3779B97F4A7C15) % (1 << 63)
        mine[rank] = torch.Generator(device=gen.device).manual_seed(seed)
    return mine[rank]


def make_train_step(cfg: DGConfig, optimizer: torch.optim.Optimizer, group=None):
    """Returns (train_step, eval_step).

    train_step(params, state, batch, gen, weights, neg_edges=None,
    drop_keep=None, vae_eps=None) -> (state, metrics) updates ``params`` IN PLACE through
    ``optimizer`` (which must hold the params' leaves, ``make_optimizer``)
    and returns the new BatchNorm running state and the metrics (detached
    0-d tensors; reading them syncs the device).

    eval_step(params, state, batch, gen, weights, neg_edges=None,
    vae_eps=None) -> metrics runs under ``no_grad`` with the running
    statistics and no dropout.

    Both run the forward, the losses and (train_step) ``total.backward()``
    under ``matmul_precision(cfg.matmul_precision)`` and restore the flags
    after; Adam updates the fp32 master params. With
    ``cfg.compute_dtype="bfloat16"`` the forward runs in bf16
    (``models/dg_ae.forward_device``) and the gradients reach the master
    params in fp32.

    ``group``: a process group of data-parallel ranks (``parallel.mesh``),
    each with its own shard in ``batch``. The train step then averages the
    gradients, the BN running state and the metrics over the group before
    the optimizer step, in one all-reduce; the eval step averages its
    metrics. ``gen`` is folded by the rank (``fold_generator``);
    ``neg_edges``, ``drop_keep`` and ``vae_eps`` are the rank's own.
    Over a group of one rank the mean is exact: the step equals the
    single-device step bit for bit.
    """
    dg_ae.check_supported(cfg)
    dp = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)

    def train_step(params, state, batch, gen, weights, neg_edges=None, drop_keep=None,
                   vae_eps=None):
        optimizer.zero_grad(set_to_none=True)
        with matmul_precision(cfg.matmul_precision):
            total, (new_state, metrics) = loss_and_metrics(
                params, state, batch, fold_generator(gen, rank), weights, cfg, True,
                neg_edges=neg_edges, drop_keep=drop_keep, vae_eps=vae_eps)
            total.backward()
        if group is not None:
            grads = [t.grad for t in param_leaves(params) if t.grad is not None]
            rest = param_leaves(new_state) + [metrics[k] for k in sorted(metrics)]
            mean_([(grads + rest, dp)], group)
        optimizer.step()
        return state | new_state, metrics

    @torch.no_grad()
    def eval_step(params, state, batch, gen, weights, neg_edges=None, vae_eps=None):
        with matmul_precision(cfg.matmul_precision):
            _, (_, metrics) = loss_and_metrics(params, state, batch,
                                               fold_generator(gen, rank), weights, cfg,
                                               False, neg_edges=neg_edges, vae_eps=vae_eps)
        if group is not None:
            mean_([([metrics[k] for k in sorted(metrics)], dp)], group)
        return metrics

    return train_step, eval_step


# The launch counters of the kernels' wrappers and of the collectives. A
# capture runs no kernel and no collective: the counts it made are taken
# back, and every replay adds what its graph enqueues, so that a run's
# counts stay per step whether its steps ran eagerly or as replays.
LAUNCH_COUNTERS = (
    (level_kernel, ("lists_launches", "launches", "bwd_launches", "levels_walked",
                    "bwd_levels_walked", "step_launches", "step_bwd_launches",
                    "giant_launches", "giant_bwd_launches")),
    (struct_kernel, ("launches", "bwd_launches")),
    (collectives, ("launches",)),
)
# eager steps of a new layout before its capture: real steps of the group,
# which also make what the capture must find made (Adam's moments, the
# kernels' launch configurations, the metric row)
CAPTURE_WARMUP = 1
# captured layouts kept per K-step call, the least recently used dropped
# (the trainer's running max of the dims, and the 3-stage CLI's weights,
# make a few)
GRAPHS_KEPT = 8


def launch_counts() -> dict:
    return {(m, n): getattr(m, n) for m, names in LAUNCH_COUNTERS for n in names}


def _add_launches(counts: dict, sign: int = 1) -> None:
    for (m, n), v in counts.items():
        setattr(m, n, getattr(m, n) + sign * v)


def step_of(sbatch: dict, k: int) -> dict:
    """Step ``k`` of a host batch stacked on a leading step axis
    (``data.batching.collate_shards``, ``collate_split_step``)."""
    out = {}
    for key, v in sbatch.items():
        if key == "groups":
            out[key] = tuple({kk: vv[k] for kk, vv in g.items()} for g in v)
        else:
            out[key] = v[k]
    return out


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_clone(v) for v in tree)
    return tree.clone()


class _Layout:
    """One batch layout's step of a K-step call: its static batch
    (``dg_ae.StaticBatch``), the level counts it walks, its static BN state
    and metric row, and on the card the captured graph, the launches one
    replay enqueues, and the tensors the graph read where the capture found
    them (``pins``)."""

    def __init__(self, batch: dict, device):
        self.batch = dg_ae.StaticBatch(batch, device)
        self.levels = dg_ae.table_levels(batch)
        self.state = None
        self.row = None
        self.graph = None
        self.eager = 0
        self.launches: dict = {}
        self.pins = None


class _GroupRunner:
    """The K-step call of one phase. ``body(layout, params, gen, weights,
    draws)`` runs one step on the layout's static tensors, and writes its
    new BN state (train) and its metric row into them; under a group each
    step means its gradients, BN state and metrics over the group first."""

    def __init__(self, cfg: DGConfig, phase: str, optimizer=None, group=None):
        dg_ae.check_supported(cfg)
        self.cfg, self.phase, self.optimizer = cfg, phase, optimizer
        self.group = group
        self.dp = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        self.layouts: collections.OrderedDict = collections.OrderedDict()
        self.stream = None
        self.captures = 0        # graphs captured, over all layouts

    def _pins(self, params, gen) -> tuple:
        """The addresses a captured step read its params, the optimizer's
        state and lr, and the generator at."""
        ptrs = [t.data_ptr() for t in param_leaves(params)]
        if self.optimizer is not None:
            for p in param_leaves(params):
                ptrs += [t.data_ptr() for t in self.optimizer.state.get(p, {}).values()
                         if isinstance(t, torch.Tensor)]
            ptrs += [g["lr"].data_ptr() for g in self.optimizer.param_groups
                     if isinstance(g["lr"], torch.Tensor)]
        return tuple(ptrs), id(gen)

    def _body(self, layout: _Layout, params, gen, weights, draws) -> None:
        cfg, b = self.cfg, layout.batch.views
        neg_edges, drop_keep, vae_eps = draws
        if self.phase == "train":
            opt = self.optimizer
            opt.zero_grad(set_to_none=True)
            with matmul_precision(cfg.matmul_precision):
                total, (new_state, metrics) = loss_and_metrics_device(
                    params, layout.state, b, layout.levels, gen, weights, cfg, True,
                    neg_edges=neg_edges, drop_keep=drop_keep, vae_eps=vae_eps)
                total.backward()
            if self.group is not None:   # train_step's one mean, in its order
                grads = [t.grad for t in param_leaves(params) if t.grad is not None]
                rest = param_leaves(new_state) + [metrics[k] for k in sorted(metrics)]
                mean_([(grads + rest, self.dp)], self.group)
            opt.step()
        else:
            with torch.no_grad(), matmul_precision(cfg.matmul_precision):
                _, (new_state, metrics) = loss_and_metrics_device(
                    params, layout.state, b, layout.levels, gen, weights, cfg, False,
                    neg_edges=neg_edges, vae_eps=vae_eps)
                if self.group is not None:
                    mean_([([metrics[k] for k in sorted(metrics)], self.dp)], self.group)
            new_state = {}
        with torch.no_grad():
            for key, sub in new_state.items():
                for dst, src in zip(param_leaves(layout.state[key]), param_leaves(sub),
                                    strict=True):
                    dst.copy_(src)
            row = torch.stack([metrics[k] for k in METRIC_KEYS])
            if layout.row is None:
                layout.row = row
            else:
                layout.row.copy_(row)

    def _capture(self, layout: _Layout, params, gen, weights) -> None:
        """The step as a CUDA graph on the runner's stream. The capture's
        own counts are taken back; a capture that fails raises. Under a
        group the all-reduce is captured with the step: its communicator
        was made by the eager steps before, and the capture refuses only
        this thread's unsafe calls (the process group's watchdog thread
        queries its own events meanwhile)."""
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("this torch cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state): the K-step call "
                               "needs it on the card")
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        before = launch_counts()
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)
        mode = "global" if self.group is None else "thread_local"
        try:
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode=mode):
                self._body(layout, params, gen, weights, (None, None, None))
        except Exception as e:
            raise RuntimeError(f"capturing the {self.phase} step of a K-step call failed: "
                               f"{e}") from e
        finally:
            after = launch_counts()
            _add_launches({k: after[k] - before[k] for k in after}, -1)
        layout.launches = {k: after[k] - before[k] for k in after}
        layout.graph = graph
        self.captures += 1
        layout.pins = self._pins(params, gen)

    def __call__(self, params, state, sbatch: dict, gen, weights, neg_edges=None,
                 drop_keep=None, vae_eps=None):
        K = int(np.shape(sbatch["gate"])[0])
        dev = params["hs_linear"]["w"].device
        card = dev.type == "cuda"
        explicit = (neg_edges, drop_keep, vae_eps)
        if card and any(d is not None for d in explicit):
            raise ValueError("explicit draws are for the CPU: on the card a K-step call draws "
                             "from its generator")
        if card and gen is None:
            raise ValueError("a K-step call on the card draws from a generator: pass one")
        if card and self.group is not None and dist.get_backend(self.group) != "nccl":
            raise ValueError(
                f"a K-step call on the card under a {dist.get_backend(self.group)} group: its "
                "all-reduce is captured in the step's CUDA graph, which needs NCCL (gloo "
                "copies the card's tensors through the host); run per step "
                "(make_train_step(group=)) or over an NCCL group")
        gen = fold_generator(gen, self.rank)
        first = step_of(sbatch, 0)
        key = (dg_ae.StaticBatch.signature(first), tuple(float(w) for w in weights))
        layout = self.layouts.pop(key, None) or _Layout(first, dev)
        self.layouts[key] = layout
        while len(self.layouts) > GRAPHS_KEPT:
            self.layouts.popitem(last=False)
        if card and self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev) if card else None
        with torch.cuda.stream(self.stream) if card else contextlib.nullcontext():
            if card:
                self.stream.wait_stream(current)
            if layout.state is None:
                layout.state = _tree_clone(state)
            else:
                with torch.no_grad():
                    for dst, src in zip(param_leaves(layout.state), param_leaves(state),
                                        strict=True):
                        if dst is not src:
                            dst.copy_(src)
            area = layout.batch.stage(sbatch, K)
            if card and layout.graph is not None and layout.pins != self._pins(params, gen):
                layout.graph, layout.eager = None, 0     # the tensors it read are gone
            rows = None
            for k in range(K):
                layout.batch.load(area[k])
                draws = tuple(None if d is None else d[k] for d in explicit)
                if not card or (layout.graph is None and layout.eager < CAPTURE_WARMUP):
                    self._body(layout, params, gen, weights, draws)
                    layout.eager += 1
                else:
                    if layout.graph is None:
                        self._capture(layout, params, gen, weights)
                    layout.graph.replay()
                    _add_launches(layout.launches)
                if rows is None:
                    rows = torch.empty((K,) + tuple(layout.row.shape), dtype=layout.row.dtype,
                                       device=dev)
                rows[k].copy_(layout.row)
            layout.batch.staged_loaded()
            new_state = _tree_clone(layout.state) if self.phase == "train" else None
            if card:
                current.wait_stream(self.stream)
        return rows if self.phase == "eval" else (state | new_state, rows)


def make_multi_step(cfg: DGConfig, optimizer: torch.optim.Optimizer, group=None):
    """K optimizer steps in one call (the JAX package's ``make_multi_step``,
    ``mgvae_tpu/train/step.py:222-283``, whose one dispatched ``lax.scan``
    this takes the place of).

    multi_step(params, state, sbatch, gen, weights, neg_edges=None,
    drop_keep=None, vae_eps=None) -> (state, metrics [K, 9]) takes a host
    batch with a leading step axis of K (``collate_shards`` of the K steps'
    graphs as shards, ``collate_chunked`` layouts stacked, or
    ``collate_split_step``), updates ``params`` in place through
    ``optimizer`` (``make_optimizer``), and returns the new BN state and
    one metric row per step, in ``METRIC_KEYS`` order, on the device. Each
    step is ``train_step``'s on that step's batch, walking every row of the
    level tables (``dg_ae.table_levels``).

    On the card the step of each batch layout and weights is captured once
    as a CUDA graph, on a stream of its own, after ``CAPTURE_WARMUP`` eager
    steps, and replayed for every later step of the layout: the batch comes
    through ``dg_ae.StaticBatch`` (one copy per step from a pinned staging
    area), the BN state through static tensors that each replay updates,
    and the draws from ``gen``, registered with the graph. The graph reads
    the params, Adam's state and the lr where the capture found them; a call
    that finds them moved (a loaded state dict) captures anew. A capture
    that fails raises: nothing runs eagerly in its place. ``neg_edges`` /
    ``drop_keep`` / ``vae_eps``: per-step lists of explicit draws, for the
    CPU's parity tests; the card refuses them.

    ``group``: a process group of data-parallel ranks (the JAX package's
    ``mesh=``), each with its own shard of every step in ``sbatch``. Each
    step then does what ``make_train_step(group=)``'s does: it draws from
    ``gen`` folded by the rank (``fold_generator``, the stream the rank's
    ``train_step`` draws from) and, between the backward and the optimizer
    step, means the gradients, the BN state and the metrics over the group
    in one all-reduce (``parallel.collectives.mean_``), in ``train_step``'s
    order: one rank's call is bit for bit its K ``train_step(group=)``
    calls on the same padded walk. On the card the all-reduce is NCCL's,
    captured inside the step's graph and replayed with it (a replay adds
    one to ``collectives.launches``); a group of another backend (gloo,
    which several processes sharing one card run) raises ValueError
    before any step runs.

    On the CPU each step runs eagerly, on the same static tensors (under a
    group, over gloo)."""
    return _GroupRunner(cfg, "train", optimizer, group)


def make_multi_eval(cfg: DGConfig, group=None):
    """K eval steps in one call (``mgvae_tpu/train/step.py:286-313``):
    multi_eval(params, state, sbatch, gen, weights, neg_edges=None,
    vae_eps=None) -> metrics [K, 9], each step ``eval_step``'s (no grad,
    the running statistics, no dropout), captured and replayed on the card
    as ``make_multi_step``'s; under ``group`` each step means its metrics
    over the group, as ``eval_step(group=)``'s."""
    return _GroupRunner(cfg, "eval", group=group)
