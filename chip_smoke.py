"""Smoke run of the PyTorch + CUDA port (mgvae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises and the script exits nonzero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile csrc/*.cu with nvcc for sm_90a; print the seconds and
     ptxas' report.
  3. kernel vs plain: for aig/mig/xag/xmg, a bs16 batch of synthetic
     circuits (16 inputs, 264 gates) at D=64, s/t_rounds 4, layernorm; the
     level-scan kernel and its plain PyTorch version on the same inputs on
     the card; max |dhf| must be <= 1e-4 (fp32, TF32 off; only the order of
     sums differs).
  4. main path: Model(modality="mig", ...).encode_many over 64 circuits
     (four bs16 requests): shapes, finite values, the kernel's launch count
     equal to the real levels of the batches, and the first request against
     the same model run on the CPU.
  5. timing (informational): median wall time of one bs16 MIG encode with
     the kernel and with the plain version, its stages, and the level scan
     alone (CUDA events), each with the card's name and power limit.
  6. backward kernel vs plain: for the phase-3 batches, the forward kernel
     with residuals against level_scan_reference(with_residuals=True), and
     the backward kernels against level_scan_bwd_reference on the same
     residuals and a fixed random hf cotangent: max |d| of each of the six
     gradients <= 1e-4 * max(scale, 1), the JAX package's bound; the
     backward's launches equal to two per real level plus one (the
     weight-gradient kernel).
  7. training main path: MIG, four bs16 batches, stage-3 weights
     [1, 4, 4, 0], Adam lr 1e-4, 20 train_steps: every loss and metric
     finite, each step's forward launches equal to its batch's real levels
     and its backward launches to two per real level plus one. Then one
     step's losses and gradients on the card against the same step on the
     CPU (same params, batch, negatives and dropout masks): each gradient
     leaf within 1e-4 * its own scale (floored at 2e-2 of the largest).
  8. timing (informational): median wall time of one bs16 MIG train step
     and of its stages (forward, losses, backward, Adam), and by CUDA
     events the level-scan forward with residuals (kernel vs plain) and the
     level-scan backward alone (kernel vs autograd through the plain
     version).
  9. profile (informational): torch.profiler over 10 MIG bs16 train
     steps; device time per step, busy share, device kernels per step, and
     the kernels by device time.

Prints a {"kernels": [...]} JSON line (one entry per kernel and path: the
encode path's level scan, the training path's level scan with residuals,
the level-scan backward), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

NUM_INPUTS, NUM_GATES = 16, 264
BATCH, N_CIRCUITS = 16, 64
DIM, ROUNDS = 64, 4
MODALITIES = ("aig", "mig", "xag", "xmg")
# kernel vs plain on the card: fp32, TF32 off; only the order of sums
# differs (the plain version's index_add_ sums use atomics on the card)
KERNEL_TOL = 1e-4
# card vs CPU, whole model: fp32 matmuls and atomic index_add_ sums in
# another order over 8 struct half-rounds and ~50 levels
CPU_TOL = 1e-4
# gradients, kernel vs plain and card vs CPU: relative to each gradient's
# own largest entry; card vs CPU floors a leaf's scale at GRAD_FLOOR of the
# largest entry over all leaves (leaves whose gradient is 0 in exact
# arithmetic carry rounding noise only)
GRAD_TOL = 1e-4
GRAD_FLOOR = 2e-2
TRAIN_STEPS, TRAIN_LR = 20, 1e-4
PROFILE_STEPS = 10
WEIGHTS = [1.0, 4.0, 4.0, 0.0]    # stage-3 loss weights (train.py)
SEED = 0
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def dataset(random_circuit, modality: str, seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [random_circuit(rng, modality, num_inputs=NUM_INPUTS, num_gates=NUM_GATES,
                           num_tt_pairs=64) for _ in range(n)]


def median_wall(fn, reps: int, sync) -> float:
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def event_ms(torch, fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_train(torch, step, card: str) -> None:
    """torch.profiler over PROFILE_STEPS calls of ``step`` (after 3 warm-up
    calls): wall and device time per step, the card's busy share, device
    kernels and copies per step, and the 25 entries with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side events only: an operator's self device time repeats its kernels'
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / PROFILE_STEPS
    log(f"[profile] card: {card}")
    wall_ms = wall / PROFILE_STEPS * 1e3
    log(f"[profile] MIG bs{BATCH} train step over {PROFILE_STEPS} steps under torch.profiler: "
        f"wall {wall_ms:.3f} ms per step; device time {dev_ms:.3f} ms per step; busy share "
        f"{dev_ms / wall_ms:.3f}; device kernels and copies per step "
        f"{len(on_card) / PROFILE_STEPS:.1f}")
    for line in ka.table(sort_by="self_device_time_total", row_limit=25,
                         max_name_column_width=60).splitlines():
        log(f"[profile] {line}")


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from mgvae_tpu_torch import Model, collate, random_circuit
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import _build, level_kernel
    from mgvae_tpu_torch.ops.level_kernel import level_scan, level_scan_reference
    from mgvae_tpu_torch.train import step as train_step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    log(f"[device] {torch.cuda.get_device_name(0)}; devices={torch.cuda.device_count()}; {card}")
    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize

    # ---- 2. build ---------------------------------------------------------
    built = _build.build()
    log(f"[build] {built.path.name}: {built.seconds:.1f} s (0.0 = already built)")
    for line in built.log.splitlines():
        log(f"[build] {line}")
    _build.library()

    # ---- 3. kernel vs plain, per modality ---------------------------------
    enc_err = 0.0
    phase3 = []   # (modality, cfg, params, batch) for phase 6
    for i, mod in enumerate(MODALITIES):
        cfg = dg_ae.DGConfig(modality=mod, dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                             layernorm=True)
        params, _ = dg_ae.init_params(cfg, seed=SEED, device=dev)
        batch = collate(dataset(random_circuit, mod, 100 + i, BATCH))
        b = dg_ae.batch_to_device(batch, dev)
        hs = dg_ae.struct_hs(params, b, cfg)
        args = dg_ae.level_scan_inputs(params, b, cfg, hs)
        n_lv, N = dg_ae.num_levels(batch), hs.shape[0]
        hf_k = level_scan(*args, num_nodes=N, num_levels=n_lv)
        hf_r = level_scan_reference(*args, num_nodes=N, num_levels=n_lv)
        sync()
        valid = torch.as_tensor(batch["node_valid"], device=dev)
        if not (torch.isfinite(hf_k).all() and torch.isfinite(hf_r).all()):
            raise RuntimeError(f"[kernel] {mod}: non-finite hf")
        err = (hf_k - hf_r)[valid].abs().max().item()
        pad = hf_k[~valid].abs().max().item()
        L, Ep, _ = args[0].shape
        log(f"[kernel] {mod}: N={N} n={int(batch['n_nodes'])} E={batch['edge_src'].shape[0]} "
            f"L={L} real_levels={n_lv} Np={args[4].shape[1]} Ep={Ep} T={cfg.num_experts} "
            f"max|dhf| valid rows={err:.3e} max|hf| padding rows={pad:.3e}")
        if not err <= KERNEL_TOL or pad != 0.0:
            raise RuntimeError(f"[kernel] {mod}: kernel disagrees with plain version "
                               f"(max|dhf|={err}, padding={pad}, tol {KERNEL_TOL})")
        enc_err = max(enc_err, err)
        phase3.append((mod, cfg, params, batch))

    # ---- 4. main path: MIG bs16 encode_many -------------------------------
    model = Model(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                  layernorm=True, seed=SEED, device=DEVICE)
    graphs = dataset(random_circuit, "mig", 7, N_CIRCUITS)
    requests = [graphs[s : s + BATCH] for s in range(0, N_CIRCUITS, BATCH)]
    expected = sum(dg_ae.num_levels(collate(r)) for r in requests)
    level_kernel.launches = 0
    out = model.encode_many(graphs, batch_size=BATCH)
    sync()
    launched = enc_launches = level_kernel.launches
    log(f"[main] encode_many: {len(graphs)} circuits in {len(requests)} bs{BATCH} requests; "
        f"level_scan launches={launched}, real levels={expected}")
    if launched != expected or launched == 0:
        raise RuntimeError(f"[main] kernel launches {launched} != real levels {expected}")
    if len(out) != len(graphs):
        raise RuntimeError(f"[main] {len(out)} outputs for {len(graphs)} circuits")
    for g, (hs, hf) in zip(graphs, out):
        want = (g.num_nodes, DIM)
        if hs.shape != want or hf.shape != want:
            raise RuntimeError(f"[main] shapes {hs.shape} {hf.shape}, want {want}")
        if not (np.isfinite(hs).all() and np.isfinite(hf).all()):
            raise RuntimeError("[main] non-finite embeddings")
    # the same model (same seed, so the same weights) on the CPU, where the
    # level scan runs its plain version, for the first request
    cpu_model = Model(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                      layernorm=True, seed=SEED, device="cpu")
    d_hs = d_hf = 0.0
    for (hs, hf), (hs_c, hf_c) in zip(out, cpu_model.encode_many(requests[0])):
        d_hs = max(d_hs, float(np.abs(hs - hs_c).max()))
        d_hf = max(d_hf, float(np.abs(hf - hf_c).max()))
    log(f"[main] card vs CPU, first request: max|dhs|={d_hs:.3e} max|dhf|={d_hf:.3e} "
        f"(tol {CPU_TOL})")
    if not (d_hs <= CPU_TOL and d_hf <= CPU_TOL):
        raise RuntimeError("[main] card and CPU disagree")
    nz = sum(int((np.abs(hf) > 0).any(axis=1).sum()) for _, hf in out)
    log(f"[main] rows with nonzero hf: {nz} of {sum(g.num_nodes for g in graphs)}")

    # ---- 5. timing (informational) ----------------------------------------
    cfg, params = model.cfg, model.params
    batch = collate(requests[0])
    n_lv = dg_ae.num_levels(batch)

    def encode(scan):
        b = dg_ae.batch_to_device(batch, dev)
        hs = dg_ae.struct_hs(params, b, cfg)
        return hs, scan(*dg_ae.level_scan_inputs(params, b, cfg, hs),
                        num_nodes=hs.shape[0], num_levels=n_lv)

    b = dg_ae.batch_to_device(batch, dev)
    hs = dg_ae.struct_hs(params, b, cfg)
    args = dg_ae.level_scan_inputs(params, b, cfg, hs)
    with torch.inference_mode():
        for _ in range(3):  # warm-up
            encode(level_scan)
            encode(level_scan_reference)
        reps = 20
        t = {"plain": [], "kernel": []}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for name in order:
                scan = level_scan if name == "kernel" else level_scan_reference
                t[name].append(median_wall(lambda: encode(scan), reps, sync))
        enc_k, enc_p = statistics.mean(t["kernel"]), statistics.mean(t["plain"])
        collate_s = median_wall(lambda: collate(requests[0]), 5, lambda: None)
        h2d_s = median_wall(lambda: dg_ae.batch_to_device(batch, dev), reps, sync)
        struct_s = median_wall(lambda: dg_ae.struct_hs(params, b, cfg), reps, sync)
        statics_s = median_wall(lambda: dg_ae.level_scan_inputs(params, b, cfg, hs), reps, sync)
        scan = dict(num_nodes=hs.shape[0], num_levels=n_lv)
        ms_p1 = event_ms(torch, lambda: level_scan_reference(*args, **scan), reps)
        ms_k1 = event_ms(torch, lambda: level_scan(*args, **scan), reps)
        ms_k2 = event_ms(torch, lambda: level_scan(*args, **scan), reps)
        ms_p2 = event_ms(torch, lambda: level_scan_reference(*args, **scan), reps)
    ms_k, ms_p = (ms_k1 + ms_k2) / 2, (ms_p1 + ms_p2) / 2
    log(f"[time] card: {card}")
    log(f"[time] MIG bs{BATCH} encode (host batch -> hs, hf on card), median of {reps}: "
        f"kernel {enc_k * 1e3:.3f} ms = {BATCH / enc_k:.1f} graphs/s; "
        f"plain {enc_p * 1e3:.3f} ms = {BATCH / enc_p:.1f} graphs/s "
        f"(runs {[round(x * 1e3, 3) for x in t['kernel']]} / "
        f"{[round(x * 1e3, 3) for x in t['plain']]} ms)")
    log(f"[time] stages: collate (host) {collate_s * 1e3:.3f} ms; to device {h2d_s * 1e3:.3f} ms; "
        f"struct towers + hs_linear {struct_s * 1e3:.3f} ms; level statics "
        f"{statics_s * 1e3:.3f} ms; level scan kernel {ms_k:.3f} ms")
    log(f"[time] level scan alone ({n_lv} levels), CUDA events over {reps} calls: "
        f"kernel {ms_k1:.4f}/{ms_k2:.4f} ms, plain {ms_p1:.4f}/{ms_p2:.4f} ms")

    # ---- 6. backward kernel vs plain, per modality ------------------------
    res_err = bwd_err = 0.0
    grad_names = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak")
    for mod, cfg, params, batch in phase3:
        b = dg_ae.batch_to_device(batch, dev)
        with torch.no_grad():
            hs = dg_ae.struct_hs(params, b, cfg)
            args = dg_ae.level_scan_inputs(params, b, cfg, hs)
        n_lv, N = dg_ae.num_levels(batch), hs.shape[0]
        hf_k, re_k, rn_k = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
        hf_r, re_r, rn_r = level_scan_reference(*args, num_nodes=N, num_levels=n_lv,
                                                with_residuals=True)
        sync()
        fwd = [(k - r).abs().max().item() for k, r in ((hf_k, hf_r), (re_k, re_r), (rn_k, rn_r))]
        if not max(fwd) <= KERNEL_TOL:
            raise RuntimeError(f"[bwd] {mod}: residual forward disagrees: max|d| hf, res_e, "
                               f"res_n = {fwd} (tol {KERNEL_TOL})")
        res_err = max(res_err, *fwd)
        ghf = torch.randn(hf_k.shape, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        bargs = (*args[:9], args[10], args[11])
        level_kernel.bwd_launches = 0
        grads_k = level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv)
        sync()
        n_bwd = level_kernel.bwd_launches
        grads_r = level_kernel.level_scan_bwd_reference(ghf, re_k, rn_k, *bargs, num_levels=n_lv)
        sync()
        report = []
        for name, k, r in zip(grad_names, grads_k, grads_r):
            if not (torch.isfinite(k).all() and torch.isfinite(r).all()):
                raise RuntimeError(f"[bwd] {mod}: non-finite {name}")
            err, scale = (k - r).abs().max().item(), r.abs().max().item()
            report.append(f"{name} {err:.3e}/{scale:.3e}")
            if not err <= GRAD_TOL * max(scale, 1.0):
                raise RuntimeError(f"[bwd] {mod}: {name} kernel disagrees with plain version: "
                                   f"max|d|={err}, scale={scale}")
            bwd_err = max(bwd_err, err)
        log(f"[bwd] {mod}: residual forward max|d| hf/res_e/res_n = "
            f"{fwd[0]:.3e}/{fwd[1]:.3e}/{fwd[2]:.3e}; backward max|d|/scale: {'; '.join(report)}; "
            f"bwd launches={n_bwd}, real levels={n_lv}")
        if n_bwd != 2 * n_lv + 1:
            raise RuntimeError(f"[bwd] {mod}: backward launches {n_bwd} != 2 * real levels "
                               f"{n_lv} + 1")

    # ---- 7. training main path: MIG bs16 train steps ---------------------
    cfg = model.cfg
    params, state = dg_ae.init_params(cfg, seed=SEED, device=dev)
    optimizer = train_step_mod.make_optimizer(params, TRAIN_LR)
    train_step, eval_step = train_step_mod.make_train_step(cfg, optimizer)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batches = [collate(r) for r in requests]
    levels = [dg_ae.num_levels(bt) for bt in batches]
    keys = train_step_mod.METRIC_KEYS + ("loss",)
    per_step, rows = [], []
    level_kernel.launches = level_kernel.bwd_launches = 0
    for i in range(TRAIN_STEPS):
        f0, b0 = level_kernel.launches, level_kernel.bwd_launches
        state, metrics = train_step(params, state, batches[i % len(batches)], gen, WEIGHTS)
        per_step.append((level_kernel.launches - f0, level_kernel.bwd_launches - b0))
        rows.append(torch.stack([metrics[k] for k in keys]))
    sync()
    train_fwd, train_bwd = level_kernel.launches, level_kernel.bwd_launches
    rows = torch.stack(rows).cpu()
    log(f"[train] {TRAIN_STEPS} train_steps over {len(batches)} bs{BATCH} MIG batches "
        f"(real levels {levels}), lr {TRAIN_LR}, weights {WEIGHTS}: level_scan launches="
        f"{train_fwd}, level_scan_bwd launches={train_bwd}")
    for i in (0, 1, TRAIN_STEPS - 1):
        log(f"[train] step {i}: " + ", ".join(
            f"{k}={v:.6g}" for k, v in zip(keys, rows[i].tolist())))
    if not torch.isfinite(rows).all():
        raise RuntimeError("[train] non-finite loss or metric")
    want = [(n, 2 * n + 1) for n in (levels[i % len(batches)] for i in range(TRAIN_STEPS))]
    if per_step != want or train_fwd == 0 or train_bwd == 0:
        raise RuntimeError(f"[train] per-step launches {per_step} != (real levels, 2 * real "
                           f"levels + 1) {want}")
    for leaf in train_step_mod.param_leaves(params):
        if not torch.isfinite(leaf).all():
            raise RuntimeError("[train] non-finite parameter after training")

    # one step on the card and on the CPU: same params, batch, negatives and
    # dropout masks; losses and gradients must agree
    batch = batches[0]
    cpu_gen = torch.Generator().manual_seed(SEED + 2)
    n_real, e_pad, n_pad = int(batch["n_nodes"]), batch["edge_src"].shape[0], batch["gate"].shape[0]
    neg = tuple(t.to(torch.int32) for t in torch.randint(0, n_real, (2, e_pad), generator=cpu_gen))
    keep = [torch.rand(n_pad, cfg.dim_mlp, generator=cpu_gen) < 0.8 for _ in range(2)]
    one = {}
    for where in ("cpu", DEVICE):
        p1, s1 = dg_ae.init_params(cfg, seed=SEED + 3, device=where)
        leaves = train_step_mod.param_leaves(p1)
        for t in leaves:
            t.requires_grad_(True)
        total, (_, m1) = train_step_mod.loss_and_metrics(
            p1, s1, batch, None, WEIGHTS, cfg, True, neg_edges=tuple(t.to(where) for t in neg),
            drop_keep=[k.to(where) for k in keep])
        total.backward()
        one[where] = ({k: float(m1[k]) for k in keys},
                      [torch.zeros(t.shape) if t.grad is None else t.grad.cpu() for t in leaves])
    (m_c, g_c), (m_g, g_g) = one["cpu"], one[DEVICE]
    # the losses, not the counts: a logit within rounding of 0 may flip one
    loss_keys = ("recon_loss", "prob_loss", "func_loss", "loss")
    loss_err = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1.0) for k in loss_keys)
    g_scale = max(g.abs().max().item() for g in g_c)
    # per leaf: (|d| / tol, |d|, leaf scale); the worst leaf is reported
    g_leaf = max(((a - c).abs().max().item() / (GRAD_TOL * max(c.abs().max().item(),
                                                                GRAD_FLOOR * g_scale)),
                  (a - c).abs().max().item(), c.abs().max().item())
                 for a, c in zip(g_g, g_c))
    log(f"[train] card vs CPU, one step: losses {m_g['recon_loss']:.6f}/{m_g['prob_loss']:.6f}/"
        f"{m_g['func_loss']:.6f} vs {m_c['recon_loss']:.6f}/{m_c['prob_loss']:.6f}/"
        f"{m_c['func_loss']:.6f}; max rel |d| of the losses {loss_err:.3e}; tp/fp "
        f"{m_g['tp']:.0f}/{m_g['fp']:.0f} vs {m_c['tp']:.0f}/{m_c['fp']:.0f}; "
        f"gradients, worst leaf against its own scale: max|d| {g_leaf[1]:.3e} at scale "
        f"{g_leaf[2]:.3e}, {g_leaf[0]:.3f} of its tolerance (tol {GRAD_TOL} * max(leaf scale, "
        f"{GRAD_FLOOR} * {g_scale:.3e}))")
    if not (loss_err <= CPU_TOL and g_leaf[0] <= 1.0):
        raise RuntimeError("[train] card and CPU disagree on one training step")

    # ---- 8. training timing (informational) -------------------------------
    batch = batches[0]
    n_lv = dg_ae.num_levels(batch)
    stage = {"forward": [], "losses": [], "backward": [], "adam": []}

    def staged_step():
        t = [time.perf_counter()]
        optimizer.zero_grad(set_to_none=True)
        b = dg_ae.batch_to_device(batch, dev)
        hs, hf, _ = dg_ae.forward_device(params, b, cfg, n_lv)
        sync(); t.append(time.perf_counter())
        total, _ = train_step_mod.losses_from_forward(params, state, b, hs, hf, gen, WEIGHTS,
                                                      cfg, True)
        sync(); t.append(time.perf_counter())
        total.backward()
        sync(); t.append(time.perf_counter())
        optimizer.step()
        sync(); t.append(time.perf_counter())
        for name, a, z in zip(stage, t, t[1:]):
            stage[name].append(z - a)

    for _ in range(3):  # warm-up
        train_step(params, state, batch, gen, WEIGHTS)
        staged_step()
    for v in stage.values():
        v.clear()
    reps = 20
    step_s = median_wall(lambda: train_step(params, state, batch, gen, WEIGHTS), reps, sync)
    for _ in range(reps):
        staged_step()
    stage_ms = {k: statistics.median(v) * 1e3 for k, v in stage.items()}
    b = dg_ae.batch_to_device(batch, dev)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    N = hs.shape[0]
    # the training path's forward: the kernel with residuals vs the plain one
    with torch.no_grad():
        rkern = lambda: level_kernel._forward_cuda(args, N, n_lv, residuals=True)
        rplain = lambda: level_scan_reference(*args, num_nodes=N, num_levels=n_lv,
                                              with_residuals=True)
        for _ in range(3):
            rkern()
            rplain()
        rms_p1 = event_ms(torch, rplain, reps)
        rms_k1 = event_ms(torch, rkern, reps)
        rms_k2 = event_ms(torch, rkern, reps)
        rms_p2 = event_ms(torch, rplain, reps)
        _, re_k, rn_k = rkern()
    rms_k, rms_p = (rms_k1 + rms_k2) / 2, (rms_p1 + rms_p2) / 2
    # the level-scan backward alone: the kernels on saved residuals vs
    # autograd through the plain forward (its graph kept between calls)
    ghf = torch.randn((N, DIM), device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    for i in level_kernel.FLOAT_ARGS:
        args[i].requires_grad_(True)
    hf_plain = level_scan_reference(*args, num_nodes=N, num_levels=n_lv)
    diff = [args[i] for i in level_kernel.FLOAT_ARGS]
    kern = lambda: level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv)
    plain = lambda: torch.autograd.grad(hf_plain, diff, ghf, retain_graph=True)
    for _ in range(3):
        kern()
        plain()
    bms_p1 = event_ms(torch, plain, reps)
    bms_k1 = event_ms(torch, kern, reps)
    bms_k2 = event_ms(torch, kern, reps)
    bms_p2 = event_ms(torch, plain, reps)
    bms_k, bms_p = (bms_k1 + bms_k2) / 2, (bms_p1 + bms_p2) / 2
    log(f"[time] card: {card}")
    log(f"[time] MIG bs{BATCH} train step (host batch -> Adam update, synchronised), median of "
        f"{reps}: {step_s * 1e3:.3f} ms = {BATCH / step_s:.1f} graphs/s")
    log(f"[time] train step stages, median of {reps}: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in stage_ms.items()))
    log(f"[time] level scan forward with residuals ({n_lv} levels), CUDA events over {reps} "
        f"calls: kernel {rms_k1:.4f}/{rms_k2:.4f} ms, plain {rms_p1:.4f}/{rms_p2:.4f} ms")
    log(f"[time] level scan backward alone ({n_lv} levels), CUDA events over {reps} calls: "
        f"kernel {bms_k1:.4f}/{bms_k2:.4f} ms, autograd through the plain version "
        f"{bms_p1:.4f}/{bms_p2:.4f} ms")

    # ---- 9. train-step profile (informational) ----------------------------
    profile_train(torch, lambda: train_step(params, state, batch, gen, WEIGHTS), card)

    print(json.dumps({"kernels": [{
        "name": "level_scan",                  # encode path (phases 3-5)
        "route": "cuda",
        "source": "mgvae_tpu_torch/csrc/level_scan.cu",
        "replaces": "mgvae_tpu/ops/pallas/level_kernel.py:173",
        "launches": enc_launches,
        "max_abs_err": enc_err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }, {
        "name": "level_scan_residuals",        # training path's forward (phases 6-8)
        "route": "cuda",
        "source": "mgvae_tpu_torch/csrc/level_scan.cu",
        "replaces": "mgvae_tpu/ops/pallas/level_kernel.py:173",
        "launches": train_fwd,
        "max_abs_err": res_err,
        "ms": rms_k,
        "plain_ms": rms_p,
    }, {
        "name": "level_scan_bwd",
        "route": "cuda",
        "source": "mgvae_tpu_torch/csrc/level_scan_bwd.cu",
        "replaces": "mgvae_tpu/ops/pallas/level_kernel.py:487",
        "launches": train_bwd,
        "max_abs_err": bwd_err,
        "ms": bms_k,
        "plain_ms": bms_p,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
