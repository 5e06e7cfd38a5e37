"""Smoke run of the PyTorch + CUDA port (mgvae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises and the script exits nonzero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile csrc/*.cu with nvcc for sm_90a; print the seconds and
     ptxas' report.
  3. kernel vs plain: for aig/mig/xag/xmg, a bs16 batch of synthetic
     circuits (16 inputs, 264 gates) at D=64, s/t_rounds 4, layernorm; the
     struct-tower kernel and the level-scan kernel each against its plain
     PyTorch version on the same inputs on the card; max |d state| and
     max |dhf| must be <= 1e-4 (fp32, TF32 off; only the order of sums
     differs); the level-list kernel against the torch sorts, entry for
     entry.
  4. main path: Model(modality="mig", ...).encode_many over 64 circuits
     (four bs16 requests): shapes, finite values, the struct kernel's
     launches equal to 2 * s_rounds per request, the level kernel's to one
     persistent launch per request and the levels those launches walked to
     the real levels of the batches, and the first request against the same
     model run on the CPU.
  5. timing (informational): median wall time of one bs16 MIG encode with
     the kernels and with the plain versions, its stages (the level lists'
     build on its own line), and by CUDA events the struct towers (forward,
     kernel vs plain) and the level scan alone (its list build included, as
     its wrapper builds them), each with the card's name and power limit.
  6. backward kernels vs plain: for the phase-3 batches, each forward
     kernel with residuals against its plain version (struct towers:
     struct_towers_reference(with_residuals=True); level scan:
     level_scan_reference(with_residuals=True), on the rows the kernel
     writes: live edges and updated slots), and each backward against
     its plain version (struct_towers_bwd_reference,
     level_scan_bwd_reference) on the same residuals and a fixed random
     cotangent: max |d| of each of the six outputs <= 1e-4 * max(scale, 1),
     the JAX package's bound; the struct backward's launches equal to
     4 * s_rounds + 1 (a row launch and a weight-gradient partial launch
     per half-round, one sum over the splits), the
     level backward's to three (the persistent sweep, the weight gradients'
     partials, their sums) with the real levels walked; both level kernels
     and the struct forward twice, bit for bit the same (the struct
     forward's serving launch too).
  7. training main path: MIG, four bs16 batches, stage-3 weights
     [1, 4, 4, 0], Adam lr 1e-4, 20 train_steps: every loss and metric
     finite; each step's struct launches 2 * s_rounds forward and
     4 * s_rounds + 1 backward, one level forward launch and three level
     backward launches, each having walked its batch's real levels. Then one
     step's losses and gradients on the card
     against the same step on the CPU (same params, batch, negatives and
     dropout masks): each gradient leaf within 1e-4 * its own scale
     (floored at 2e-2 of the largest).
  8. timing (informational): median wall time of one bs16 MIG train step
     and of its stages (forward, losses, backward, Adam), and by CUDA
     events the struct towers and the level scan, each forward with
     residuals (kernel vs plain) and backward alone (kernel vs autograd
     through the plain version); the struct backward's device time per call
     by kernel name under torch.profiler (row, partial and sum launches).
  9. profile (informational): torch.profiler over 10 MIG bs16 train
     steps; device time per step, busy share, device kernels per step, and
     the kernels by device time.
  [trainer] the 3-stage CLI, ``cli.main(argv)`` as ``python -m
     mgvae_tpu_torch.train`` runs it (MIG, DG_AE, bs16, layernorm, D=64,
     s/t_rounds 4, --stage_epochs 1,1,1, 176 synthetic circuits: 9 train
     and 1 val step an epoch), in-process on the card: per train step struct
     launches 8 / 17, level 1 / 3, level lists 1, per val step 8 / 1 / 1, no
     step or giant launch; the five checkpoint files and six epoch lines of
     the reference format; a --resume rerun with no epochs restores params,
     BN and Adam state bit for bit; one epoch card vs CPU through two
     Trainers from the same params with the same host-made negatives and
     dropout masks (per-step losses within rtol 1e-4, params after within
     2e-4, see TRAINER_PARAM_ATOL); a bs64 epoch with the chunk count C
     that pick_chunks chose (one fused launch per chunk); and, for
     information, the trainer's ms per train step beside a bare train_step
     loop over the same collated batches.
  [variants] the model variants at the same width (MIG bs16, D=64, s/t_rounds
     4, layernorm, random weights from seed 0): DG_VAE (the variational head
     and the KL term), AE (the directed GCN struct encoder, plain torch as in
     the JAX package) and num_rounds = 2 (the general level loop, plain torch
     on every device: neither package has a kernel for it), beside DG_AE.
     Three train steps of each (weights [1, 4, 4, 1]) with the launches of
     each step, counts set to 0 before it: DG_VAE's equal DG_AE's (struct
     8 / 17, level 1 / 3, lists 1), AE (0, 0, 1, 3, 1), num_rounds = 2
     (8, 17, 0, 0, 0: the struct towers keep their kernels, no level, list,
     step or giant launch); kl_loss nonzero exactly for DG_VAE. For each of
     the three, the encode (launches; hs, hf and DG_VAE's aux within 1e-4 of
     the CPU's) and one train step card vs CPU with host-made negatives,
     dropout masks and posterior noise, held as phase 7 holds its step, the
     prob term apart as in phase 12 (weights [1, 0, 4, 1] and
     card_vs_cpu_prob). Model(variational=True).encode_many: a second model
     of the same seed gives the same hf, the next request fresh draws. The
     CLI with the parser's default model (DG_VAE), --kl_weight 0.1, one
     epoch a stage: the five files and six epoch lines with the KL field.
     For information: the median bs16 train step of the four models in
     this call, and torch.profiler over one AE and one num_rounds = 2 step.
  [precision] the precision modes: (b) three bf16 train steps of phase 7's
     model (compute_dtype="bfloat16"; fp32 master params) with their
     launches, counts set to 0 before them: the main path of the four bf16
     kernels; (a) the bf16 struct towers with residuals, their backward,
     the bf16 fused level scan with residuals and its backward against
     their plain bf16 versions on phase 3's MIG batch (each output within
     2^-6 of its own largest entry, two bf16 ulps at the top of its range),
     with CUDA-event times; the bf16 bs16 encode and one train step card vs
     CPU (hs, hf within 2^-6 of their scale, each gradient leaf within 2^-3
     of its own) and card bf16 vs card fp32 (the JAX package's bf16 bounds:
     values atol 3e-2 / rtol 1e-1, gradients 0.05 * max(scale, 1)); (c) one
     bf16 step on the bs64 collate_fit (C=3) and collate_split (G=4) layouts
     card vs CPU (as the bs16 step) with their launches; (d) the bs16 train step under "default"
     (TF32) and "highest" in turns: both medians, their ratio, and the drift
     of hs, hf and the losses (each within 1e-2 * max(its scale, 1)); (e)
     bf16 on the step and giant routes, run after phase 17 on its batches
     (see there).

 10. step kernels vs plain: for aig/mig/xag/xmg, 64 circuits collated with
     collate_chunked(graphs, 2) (per-chunk N_sub > 8192, so the chunks fail
     the fused route's size gate); on every real level of both chunks, the
     single-level step kernel with residuals against level_step_reference
     (h_new, res_e, res_n: max |d| <= 1e-4) and its backward against
     level_step_bwd_reference on the same residuals and a fixed random
     cotangent (each of the seven outputs, d_hf included, within
     1e-4 * max(scale, 1)); then the whole step route (one launch per level
     index for both chunks, the scatter inside the kernel; its backward on
     a carried ghf in blocks of K level indices, step_chunk_levels) against
     level_scan_step_reference / level_scan_step_bwd_reference in the same
     block order: hf and the residuals within 1e-4, each backward output
     within 1e-4 * max(scale, 1), d_pack 0 on the rows not walked, two runs
     bit for bit the same, hf equal bit for bit to the route's serving
     launch and to the per-row loop of single-level calls.
 11. bs64 encode: Model.forward(list of 64 MIG circuits), which collates
     with collate_fit (C and the per-chunk dims are printed): struct
     launches 2 * s_rounds, one level-scan launch per chunk which together
     walk the real (chunk, level) rows, no step launch; rows against the
     same model on the CPU (max |d| <= 1e-4).
 12. step route: the forward and 5 train steps (lr 1e-3, fixed negatives
     and dropout masks, so that the loss must fall) on the MIG
     collate_chunked(graphs, 2) batch: per step, step launches equal to the
     level indices (max real levels) and step backward launches to
     step_route_launch_count(real levels, K) (per level index a slot and a
     source launch, per block of K level indices and chunk the weight
     gradients), no fused level launch; losses
     finite and falling; one step card vs CPU as in phase 7, without the
     prob loss (see SMOOTH_WEIGHTS), and beside it the prob loss alone card
     vs CPU with the units of its readout that lie within rounding of a kink
     masked on both sides (the readout's pre-activations and the gradients
     of every leaf). Then the peak device memory of the level recurrence
     alone (forward and backward) on the route and by the per-row loop of
     single-level calls: the route's must stay within 1.25 x (stacked
     residuals + hf + ghf's copy + d_pack_lv).
 13. split batch: the same on collate_split(graphs, 4): per step, struct
     launches 2 * s_rounds per group forward and 4 * s_rounds + 1 backward,
     one level-scan launch per group forward and three backward, which walk
     the groups' real levels.
 14. timing (informational): by CUDA events the single-level step kernel
     (with and without residuals) and its backward against their plain
     versions on the widest level of the phase-12 batch; the route's
     forward with residuals and its backward on the whole batch against the
     plain route; median wall time of one bs64 MIG train step by its three
     layouts (collate_fit's chunks on the fused route, two chunks on the
     step route, four split groups), in turns.

 15. giant kernels vs plain: one layered circuit of width 512 collated alone
     (MIG at depth 200: the giant example's circuit, N = 114,688 padded;
     aig/xag/xmg at depth 24): the giant forward kernel against
     level_scan_giant_reference (max |dhf| <= 1e-4) and equal bit for bit to
     the fused kernel's hf on the same inputs; the giant backward kernel,
     which recomputes from hf in chunks of K levels
     (level_kernel.giant_chunk_levels), against
     level_scan_giant_bwd_reference in the same chunk order on the same hf
     and a fixed random cotangent (each of the six outputs within
     1e-4 * max(scale, 1)) and against the fused backward's outputs from
     saved residuals (<= RECOMPUTE_TOL * max(scale, 1)); both giant kernels
     twice, bit for bit the same; launches: one forward, and backward the
     kernels the C entry counts as it enqueues them, against
     giant_bwd_launch_count(real levels, K) (per chunk a recompute, a sweep,
     the weight-gradient partials and their sums).
 16. giant encode: Model.forward(g) on the depth-200 circuit: shapes, finite,
     struct launches 2 * s_rounds, one giant launch, no fused or step
     launch; rows against the same model on the CPU.
 17. giant training: 4 train_steps on collate([g]) with the example's weights
     [1, 4, 2, 0] and lr 1e-4, fixed negatives and dropout masks: per step
     one giant launch forward and giant_bwd_launch_count backward, no fused
     or step launch; loss finite and lower at the end; one step card
     vs CPU with SMOOTH_WEIGHTS and the masked prob loss beside it, as in
     phase 12; one step with remat_struct=True against
     False (struct forward launches doubled, gradients equal); the peak
     device memory of one step on the giant route, with the remat, and with
     the route forced to the fused kernels and their residuals; the struct
     backward's scratch by buffer; the giant step's own peak (above what
     the script held before it) must stay within GIANT_PEAK_GIB with and
     without the remat; the peak of the
     level recurrence alone (forward and backward) by both routes: the giant
     route's must stay within 1.25 x (hf + ghf's copy + d_pack_lv). Then a plain
     collate of the 64 bs64 MIG circuits (N = 20480, C == 1, which fails the
     fused route's size gate): one forward (hf equal to phase 11's rows) and
     one train step, both on the giant route.
  [precision] (e) bf16 values on the step and giant routes (kernels 3-6),
     the model as compute_dtype="bfloat16" casts it: (e1) the giant forward
     and backward on phase 15's MIG batch and the step route's forward and
     backward on phase 12's two-chunk batch against their plain bf16
     versions (each output within 2^-6 of its own scale; the giant
     backward's plain version rounds as the JAX giant kernel does: fp32 ghf
     and recompute), the giant forward equal bit for bit to kernel 1's bf16
     launch without residuals, with CUDA-event times beside the fp32
     kernels' in turns; (e2) one bf16 train step on the two-chunk batch by
     the step route and (e3) the bf16 giant encode and one train step, card
     vs CPU (hs / hf within 2^-6 of their scale, each gradient leaf within
     2^-3 of its own, as [precision] (c)), each with its launches (those of
     fp32: step 49 / 118, giant 1 / 136); the giant step's median wall time
     beside fp32's and its own peak device memory beside phase 17's, and the level
     recurrence alone in bf16 against phase 17's law (hf + ghf's copy +
     d_pack_lv in their bf16 / fp32 / bf16 bytes, and fp32's; its K and
     scratch are fp32's), which must stay within 1.25 x fp32's law and
     below fp32's own peak.
 18. timing (informational): by CUDA events the giant forward and backward
     kernels alone against their plain versions and against the fused
     kernels on the same batch, and the struct forward without and with
     residuals on the giant batch beside its bounds; median wall time of the
     giant encode and of the giant train step with its stages;
     torch.profiler over 3 giant train steps.

Prints a {"kernels": [...]} JSON line (one entry per kernel and path: the
encode path's struct towers, level lists and level scan, the training path's struct
towers and level scan with residuals, the two backwards, the step route's
forward and backward (its passes over the bs64 two-chunk batch, with the
launches of one pass beside), the giant forward and backward, the four
bf16 kernels of the fused route ([precision]; bounds with the values' bytes
halved) and the four of the step and giant routes ([precision] (e), their
launches from (e2) and (e3), the fp32 kernel's time in the same call as
fp32_ms); each with
its launches on its main path, its
time, its plain version's, and its bound: the larger of its bytes over
3.35 TB/s and its operations at their type's peak (67 TFLOP/s in fp32; the
bf16 entries' products, bf16 operands with fp32 accumulation, at 989
TFLOP/s on the tensor cores), computed from this run's inputs, with both
terms as bytes_ms and operations_ms), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

NUM_INPUTS, NUM_GATES = 16, 264
BATCH, N_CIRCUITS = 16, 64
DIM, ROUNDS = 64, 4
# the struct backward's launches per call: a row launch and a weight-gradient
# partial launch per half-round, one sum
SBWD_LAUNCHES = 4 * ROUNDS + 1
MODALITIES = ("aig", "mig", "xag", "xmg")
# kernel vs plain on the card: fp32, TF32 off; only the order of sums
# differs (the kernels sum in a fixed order, the plain versions' index_add_
# with atomics)
KERNEL_TOL = 1e-4
# card vs CPU, whole model: the same fp32 math with sums in another order
# (the kernels' and cuBLAS' against the CPU's) over 8 struct half-rounds
# and ~50 levels
CPU_TOL = 1e-4
# gradients, kernel vs plain and card vs CPU: relative to each gradient's
# own largest entry; card vs CPU floors a leaf's scale at GRAD_FLOOR of the
# largest entry over all leaves (leaves whose gradient is 0 in exact
# arithmetic carry rounding noise only)
GRAD_TOL = 1e-4
GRAD_FLOOR = 2e-2
TRAIN_STEPS, TRAIN_LR = 20, 1e-4
LARGE_STEPS, LARGE_LR = 5, 1e-3   # the bs64 phases: few steps, fixed draws, the loss must fall
CHUNKS, GROUPS = 2, 4             # collate_chunked / collate_split of the 64 circuits
# the card's published peaks (H100 SXM data sheet, dense rates): device memory,
# fp32 outside the tensor cores, and bf16 products (bf16 operands, fp32
# accumulation) on the tensor cores
PEAK_BYTES_S, PEAK_FLOP_S, PEAK_BF16_FLOP_S = 3.35e12, 67e12, 989e12
PROFILE_STEPS = 10
WEIGHTS = [1.0, 4.0, 4.0, 0.0]    # stage-3 loss weights (train.py)
# The bs64 card-vs-CPU steps leave the prob loss out. Its readout MLP has
# ~1.1M ReLU units per bs64 step, and about one of them per step has a
# pre-activation within the card-CPU rounding difference (~1e-6) of 0: the
# unit is then on for one device and off for the other, which moves its
# gradients by ~1e-4, far past a tolerance made for rounding. The bs16 step
# of phase 7 (a quarter of the units) keeps the prob loss.
SMOOTH_WEIGHTS = [1.0, 0.0, 4.0, 0.0]
# the giant example: one layered MIG circuit collated alone (phases 15-18);
# the other modalities check the kernels at a smaller depth
GIANT_WIDTH, GIANT_DEPTH, GIANT_SMALL_DEPTH = 512, 200, 24
GIANT_STEPS, GIANT_LR, GIANT_WEIGHTS = 4, 1e-4, [1.0, 4.0, 2.0, 0.0]
# the giant step's own peak device memory (above what the script holds
# before it), at most: the struct backward keeps one half-round of scratch
# (7.67 GiB when it kept all 2R)
GIANT_PEAK_GIB = 5.0
# The giant backward recomputes what the fused backward reads from saved
# residuals, with the same device functions; the two differ in the order of
# the weight gradients' sums: the fused backward sums chunks of levels into
# partials and those pairwise, the giant sums a partial per level of a chunk,
# those pairwise, and the chunks in launch order. At 257k rows they agree to
# ~1e-6 of an output's scale (a single fp32 accumulator over all rows had
# cost 1.06e-5).
RECOMPUTE_TOL = 1e-5
# [precision]: the JAX package's bf16 bounds (tests/test_pallas_kernel.py:95-114):
# values atol 2e-2 / rtol 1e-1 against bf16, atol 3e-2 / rtol 1e-1 against
# fp32; gradients 0.05 * max(scale, 1). They are made for bf16 against fp32
# and hold every comparison. Two bf16 paths that round at the same points (a
# kernel and its plain version, the card and the CPU) are held tighter too,
# each tensor against its own largest entry: values and a kernel's gradients
# within BF16_ULPS (two bf16 ulps at the top of the range, no floor); a train
# step's gradient leaves card vs CPU within BF16_LEAF of their own scale,
# floored at GRAD_FLOOR of the largest entry over all leaves as phase 7
# floors them. A leaf's gradient is a sum over every edge or node whose
# terms cancel, and each term differs between the two by about a bf16 ulp
# (the card's and the CPU's fp32 sums round to bf16 apart): the error
# follows the terms, not the sum (the expert value bias, a sum over ~8k
# edges, moved 6.8% of its own scale on a bs64 step). TF32 against full
# fp32: each tensor within 1e-2 * max(its scale, 1).
BF16_ATOL, BF16_F32_ATOL, BF16_RTOL, BF16_GRAD = 2e-2, 3e-2, 1e-1, 0.05
BF16_ULPS, BF16_LEAF = 2.0 ** -6, 2.0 ** -3
TF32_DRIFT = 1e-2
BF16_STEPS = 3
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# Operations per row and feature of the struct backward's LayerNorm and GRU
# backward, counted from struct_towers_bwd.cu's row kernel (statistics, the
# LayerNorm's and the GRU's cotangents, the column sums, dxi += dgi).
STRUCT_BWD_ELEMENTWISE = 40


def bound(bytes_moved: float, flops: float, bf16_products: float = 0.0) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations at
    their type's rate (``flops`` at fp32's, ``bf16_products`` at the bf16
    tensor cores'), whichever is larger (both terms kept beside it)."""
    by_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    by_ops = (flops / PEAK_FLOP_S + bf16_products / PEAK_BF16_FLOP_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_ms": by_bytes, "operations_ms": by_ops}


def profile_train(torch, step, card: str, label: str, steps: int = PROFILE_STEPS,
                  rows: int = 25, warm: int = 3) -> None:
    """torch.profiler over ``steps`` calls of ``step`` (after ``warm``
    warm-up calls; 0 where the caller ran it already): wall and device time
    per step, the card's busy share, device kernels and copies per step, and
    the ``rows`` entries with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side events only: an operator's self device time repeats its kernels'
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / steps
    log(f"[profile] card: {card}")
    wall_ms = wall / steps * 1e3
    log(f"[profile] {label} over {steps} steps under torch.profiler: "
        f"wall {wall_ms:.3f} ms per step; device time {dev_ms:.3f} ms per step; busy share "
        f"{dev_ms / wall_ms:.3f}; device kernels and copies per step "
        f"{len(on_card) / steps:.1f}")
    for line in ka.table(sort_by="self_device_time_total", row_limit=rows,
                         max_name_column_width=60).splitlines():
        log(f"[profile] {line}")


def step_casts(torch, step, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` calls of ``step`` (after 2 warm-up
    calls), per step: wall and device time, device kernels, and the dtype
    and device conversions (``aten::_to_copy``, forward and backward): their
    calls, their host time (inclusive), and the copy kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    to_copy = [e for e in prof.key_averages() if e.key == "aten::_to_copy"]
    return {"wall_ms": wall / steps * 1e3,
            "device_ms": sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / steps,
            "kernels": len(on_card) / steps,
            "to_copy_calls": sum(e.count for e in to_copy) / steps,
            "to_copy_host_ms": sum(e.cpu_time_total for e in to_copy) / 1e3 / steps,
            "copy_kernels_ms": sum(e.time_range.elapsed_us() for e in on_card
                                   if "copy_kernel" in e.name) / 1e3 / steps}


# [variants]: the train steps of each variant on the card; their weights
# (stage 3's with the KL term, DG_VAE's only); the card-vs-CPU step's, with
# the prob term held apart as in phases 12 and 17 (SMOOTH_WEIGHTS' reason)
VARIANT_STEPS = 3
VARIANT_WEIGHTS = [1.0, 4.0, 4.0, 1.0]
VARIANT_SMOOTH_WEIGHTS = [1.0, 0.0, 4.0, 1.0]
VAE_ARGV = ["--exp_id", "vae", "--type", "mig", "--batch_size", str(BATCH), "--layernorm",
            "--stage_epochs", "1,1,1", "--synthetic_circuits", "176", "--kl_weight", "0.1"]
VAE_EPOCH_LINE = (r"^(train|val)\| Epoch: 0/1 \|Recon: \d+\.\d{4} \|ACC: \d+\.\d{2} "
                  r"\|Prob: \d+\.\d{4} \|Func: \d+\.\d{4} \|KL: -?\d+\.\d{4}\|Net: "
                  r"\d+\.\d{2}s$")
TRAINER_ARGV = ["--exp_id", "smoke", "--model", "DG_AE", "--type", "mig", "--batch_size",
                str(BATCH), "--layernorm", "--stage_epochs", "1,1,1", "--synthetic_circuits",
                "176", "--matmul_precision", "highest"]
# D = 64 and s/t_rounds 4 are the parser's defaults; 158 train, 18 val; full
# fp32, as the epoch is held card against CPU
# card vs CPU through the trainer: per-step losses, and params after one
# epoch of 9 Adam steps at lr 1e-4. The comparison's weights leave the prob
# term out (SMOOTH_WEIGHTS' reason, and the readout biases before BatchNorm
# have a gradient of 0 in exact arithmetic, rounding noise that Adam scales
# to +-lr a step on each device). The attention's query side and key bias
# shift every logit into a node alike, so the softmax cancels their
# gradient in the same way; they are held to the Adam bound 2 * lr * steps.
TRAINER_LOSS_RTOL, TRAINER_PARAM_ATOL = 1e-4, 2e-4
SOFTMAX_INVARIANT = ("wq", "bq", "wa_q", "ba", "bk")


def named_leaves(tree, prefix=""):
    """The leaves' paths, in ``train.step.param_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}/{i}")]
    return [prefix]
EPOCH_LINE = (r"^(train|val)\| Epoch: 0/1 \|Recon: \d+\.\d{4} \|ACC: \d+\.\d{2} "
              r"\|Prob: \d+\.\d{4} \|Func: \d+\.\d{4}\|Net: \d+\.\d{2}s$")


def trainer_phase(torch, dev, card: str) -> None:
    """[trainer]: the 3-stage CLI (``python -m mgvae_tpu_torch.train``) run
    in-process on the card at full width, with its launches per step, its
    files and log lines, ``--resume`` bit for bit, one epoch card vs CPU
    through the trainer, a bs64 epoch's chunk count, and the trainer's ms
    per step beside a bare train_step loop (informational)."""
    from mgvae_tpu_torch import cli
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import level_kernel, struct_kernel
    from mgvae_tpu_torch.ops import mlp as mlp_mod
    from mgvae_tpu_torch.train import losses as losses_mod
    from mgvae_tpu_torch.train import step as step_mod
    from mgvae_tpu_torch.train import trainer as trainer_mod

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "exp", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    save = ["--save_dir", root]

    def counts():
        return (struct_kernel.launches, struct_kernel.bwd_launches, level_kernel.launches,
                level_kernel.bwd_launches, level_kernel.lists_launches,
                level_kernel.step_launches + level_kernel.step_bwd_launches
                + level_kernel.giant_launches + level_kernel.giant_bwd_launches)

    names = "(struct, struct bwd, level, level bwd, lists, step and giant)"
    per_step = {"train": [], "val": []}
    metrics = {"train": [], "val": []}
    make = trainer_mod.make_train_step

    def counting_make(cfg, optimizer):
        """make_train_step whose steps record their launches and metrics."""
        train_step, eval_step = make(cfg, optimizer)

        def recorded(phase, fn):
            def call(*a, **kw):
                before = counts()
                out = fn(*a, **kw)
                per_step[phase].append(tuple(x - y for x, y in zip(counts(), before)))
                metrics[phase].append(out[1] if phase == "train" else out)
                return out
            return call

        return recorded("train", train_step), recorded("val", eval_step)

    def run(argv):
        trainer_mod.make_train_step = counting_make
        try:
            return cli.main(argv)
        finally:
            trainer_mod.make_train_step = make

    for m in (level_kernel, struct_kernel):
        m.launches = m.bwd_launches = 0
    level_kernel.lists_launches = level_kernel.step_launches = level_kernel.step_bwd_launches = 0
    level_kernel.giant_launches = level_kernel.giant_bwd_launches = 0
    t0 = time.perf_counter()
    trainer = run(TRAINER_ARGV + save)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {ph: sorted(set(v)) for ph, v in per_step.items()}
    log(f"[trainer] python -m mgvae_tpu_torch.train {' '.join(TRAINER_ARGV)} in-process on "
        f"{dev}: {wall:.1f} s for 3 stages; {len(per_step['train'])} train steps and "
        f"{len(per_step['val'])} val steps; chunks {trainer._chunks}, dims {trainer._dims_max}; "
        f"launches per step {names}: train {got['train']}, val {got['val']}")
    want = {"train": [(2 * ROUNDS, SBWD_LAUNCHES, 1, 3, 1, 0)], "val": [(2 * ROUNDS, 0, 1, 0, 1, 0)]}
    if got != want or len(per_step["train"]) != 3 * 9 or len(per_step["val"]) != 3:
        raise RuntimeError(f"[trainer] launches per step {got} != {want}, or not 27 train and 3 "
                           f"val steps")
    rows = torch.stack([torch.stack([m[k] for k in step_mod.METRIC_KEYS])
                        for m in metrics["train"] + metrics["val"]]).cpu()
    if not torch.isfinite(rows).all():
        raise RuntimeError("[trainer] non-finite loss or metric")
    run_dir = os.path.join(root, "smoke")
    files = ("stage_1.pth", "stage_2.pth", "stage_3.pth", "model_0.pth", "model_last.pth")
    missing = [f for f in files if not os.path.isfile(os.path.join(run_dir, f))]
    logs = [f for f in os.listdir(run_dir) if f.startswith("log-")]
    with open(os.path.join(run_dir, logs[0])) as f:
        lines = [ln.rstrip("\n") for ln in f if "| Epoch:" in ln]
    for ln in lines:
        log(f"[trainer] log: {ln}")
    if missing or len(logs) != 1 or len(lines) != 6 or not all(
            re.match(EPOCH_LINE, ln) for ln in lines):
        raise RuntimeError(f"[trainer] files missing {missing}, or not 6 epoch lines of the "
                           f"reference format")

    # --resume with no epochs: stage_1.pth then holds what was restored
    last = torch.load(os.path.join(run_dir, "model_last.pth"), map_location="cpu",
                      weights_only=True)
    resumed = run(TRAINER_ARGV[:-4] + ["--stage_epochs", "0,0,0", "--synthetic_circuits", "176",
                                       "--resume"] + save)
    again = torch.load(os.path.join(run_dir, "stage_1.pth"), map_location="cpu",
                       weights_only=True)

    def tensors(tree):
        if isinstance(tree, dict):
            return [t for k in sorted(tree, key=str) for t in tensors(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in tensors(v)]
        return [tree] if isinstance(tree, torch.Tensor) else []

    pairs = [(x, y) for key in ("params", "state", "optimizer")
             for x, y in zip(tensors(last[key]), tensors(again[key]), strict=True)]
    on_card = all(t.device.type == dev.type for t in step_mod.param_leaves(resumed.params))
    equal = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)
    log(f"[trainer] --resume: model_epoch {resumed.model_epoch} (saved {last['epoch']}), "
        f"{len(pairs)} tensors (params, BN state, Adam state) bit for bit: {equal}; params on "
        f"the card: {on_card}")
    if not (equal and on_card and pairs and resumed.model_epoch == last["epoch"]):
        raise RuntimeError("[trainer] --resume did not restore the saved tensors bit for bit")

    # one epoch on the card against one on the CPU: same params, graphs and
    # order, and the same host-made draws
    args = cli.get_parse_args(TRAINER_ARGV)
    cfg = cli.model_config(args)
    train_ds, val_ds = cli.load_dataset(args)

    def host_negatives(gen, num_samples, b):
        n = int(b["n_nodes"])
        r = np.random.default_rng([n, num_samples, int(b["n_edges"])])
        src = r.integers(0, n, num_samples)
        dst = (src + 1 + r.integers(0, n - 1, num_samples)) % n
        return tuple(losses_mod.to_valid_runs(
            torch.as_tensor(x, dtype=torch.int32, device=b["edge_src"].device), b)
            for x in (src, dst))

    def host_dropout(x, p, train, gen=None, keep=None):
        if not train or p <= 0.0:
            return x
        r = np.random.default_rng(list(x.shape))
        keep = torch.as_tensor(r.random(tuple(x.shape)) < 1.0 - p, device=x.device)
        return torch.where(keep, x / (1.0 - p), 0.0)

    draws = (losses_mod.sample_negative_edges, mlp_mod.dropout)
    losses_mod.sample_negative_edges, mlp_mod.dropout = host_negatives, host_dropout
    side = {}
    try:
        for where in (DEVICE, "cpu"):
            for ph in metrics:
                metrics[ph].clear()
            p0, s0 = dg_ae.init_params(cfg, seed=SEED + 5, device=where)
            trainer_mod.make_train_step = counting_make
            try:
                t = trainer_mod.Trainer(args, cfg, params=p0, state=s0, training_id=f"vs_{where}",
                                        save_dir=root, batch_size=BATCH, distributed=False,
                                        seed=SEED, steps_per_call=1, device=where)
            finally:
                trainer_mod.make_train_step = make
            t.set_training_args(rc_prob_func_weight=SMOOTH_WEIGHTS[:3], lr=TRAIN_LR)
            t.train(1, train_ds, val_ds)
            side[where] = ({ph: [[float(m[k]) for k in ("recon_loss", "prob_loss", "func_loss")]
                                 for m in v] for ph, v in metrics.items()},
                           [x.detach().cpu() for x in step_mod.param_leaves(t.params)])
    finally:
        losses_mod.sample_negative_edges, mlp_mod.dropout = draws
    (l_g, p_g), (l_c, p_c) = side[DEVICE], side["cpu"]
    loss_err = max(abs(a - c) / max(abs(c), 1e-12) for ph in l_c
                   for ra, rc in zip(l_g[ph], l_c[ph], strict=True) for a, c in zip(ra, rc))
    leaf_ids = named_leaves(p0)
    worst = {True: (0.0, ""), False: (0.0, "")}
    for name, a, c in zip(leaf_ids, p_g, p_c, strict=True):
        inv = name.startswith("/experts/") and name.split("/")[-1] in SOFTMAX_INVARIANT
        worst[inv] = max(worst[inv], ((a - c).abs().max().item(), name))
    adam_bound = 2 * TRAIN_LR * len(l_c["train"])
    log(f"[trainer] one epoch card vs CPU ({len(l_c['train'])} train and {len(l_c['val'])} val "
        f"steps, weights {SMOOTH_WEIGHTS[:3]}, lr {TRAIN_LR}, host-made draws): per-step "
        f"losses max rel |d| {loss_err:.3e} (tol {TRAINER_LOSS_RTOL}); params after, max |d| "
        f"{worst[False][0]:.3e} at {worst[False][1]} (tol {TRAINER_PARAM_ATOL}); the "
        f"softmax-invariant attention leaves {worst[True][0]:.3e} at {worst[True][1]} (Adam "
        f"bound {adam_bound:.1e})")
    if not (loss_err <= TRAINER_LOSS_RTOL and worst[False][0] <= TRAINER_PARAM_ATOL
            and worst[True][0] <= adam_bound and len(l_c["train"]) == 9):
        raise RuntimeError("[trainer] the card's epoch and the CPU's disagree")

    # a bs64 epoch: the chunk count pick_chunks chose, and its launches
    per_step["train"].clear()
    trainer_mod.make_train_step = counting_make
    try:
        t64 = trainer_mod.Trainer(args, cfg, training_id="bs64", save_dir=root, batch_size=64,
                                  distributed=False, seed=SEED, steps_per_call=1, device=DEVICE)
    finally:
        trainer_mod.make_train_step = make
    t64.train(1, train_ds, [])
    torch.cuda.synchronize()
    got64 = sorted(set(per_step["train"]))
    C64 = t64._chunks
    log(f"[trainer] bs64 epoch: pick_chunks chose C={C64} (dims per chunk {t64._dims_max}); "
        f"{len(per_step['train'])} train steps, launches per step {names}: {got64}")
    if got64 != [(2 * ROUNDS, SBWD_LAUNCHES, C64, 3 * C64, 1, 0)] or C64 < 2:
        raise RuntimeError(f"[trainer] bs64 launches {got64}: want one fused launch forward and "
                           f"three backward per chunk, C={C64} >= 2")

    # (informational) the trainer's ms per train step against a bare
    # train_step loop over the same collated batches, in one call
    tt = trainer_mod.Trainer(args, cfg, training_id="time", save_dir=root, batch_size=BATCH,
                             distributed=False, seed=SEED, steps_per_call=1, device=DEVICE)
    tt.set_training_args(rc_prob_func_weight=[1.0, 4.0, 4.0], lr=TRAIN_LR)
    epochs_ms = [tt.train(1, train_ds, [])["train"]["time"] * 1e3 for _ in range(3)]
    # the host work an epoch adds to the steps: its plan (the shuffle and
    # the dims scan, a collate per shard) and a collate per step
    t1 = time.perf_counter()
    idx, n_steps, dims, C = tt._epoch_plan(train_ds)
    plan_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    batches = [tt._collate_step([train_ds[i] for i in idx[s * BATCH:(s + 1) * BATCH]], dims, C)
               for s in range(n_steps)]
    collate_ms = (time.perf_counter() - t1) * 1e3 / n_steps
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def bare():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in batches:
            tt.state, _ = tt.train_step(tt.params, tt.state, b, gen, tt.weights)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / len(batches) * 1e3

    bare_ms = [bare() for _ in range(3)]
    log(f"[trainer] card: {card}")
    log(f"[trainer] MIG bs{BATCH} trainer epoch ({len(batches)} train steps, collate in the "
        f"prefetch thread, the dims scan on the epoch's thread, synchronised at the epoch's "
        f"end), ms per train step over three epochs: "
        + ", ".join(f"{x:.3f}" for x in epochs_ms)
        + f"; bare train_step loop over the same collated batches, three passes: "
        + ", ".join(f"{x:.3f}" for x in bare_ms)
        + f"; on the host alone, the epoch's plan (shuffle and dims scan) {plan_ms:.3f} ms, "
        f"collate {collate_ms:.3f} ms per step")
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    t_main = time.perf_counter()

    def clock(phase):
        """Each phase's start, for the command's time budget."""
        log(f"[clock] {phase} starts at {time.perf_counter() - t_main:.1f} s")

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    from mgvae_tpu_torch import (Model, collate, collate_chunked, collate_fit, collate_split,
                                 layered_circuit, random_circuit)
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import _build, level_kernel, struct_kernel
    from mgvae_tpu_torch.ops import mlp as mlp_mod
    from mgvae_tpu_torch.ops.init import linear_apply
    from mgvae_tpu_torch.ops.level_kernel import level_scan, level_scan_reference
    from mgvae_tpu_torch.ops.precision import matmul_precision as precision_scope
    from mgvae_tpu_torch.ops.struct_kernel import (struct_inputs, struct_tables,
                                                   struct_towers_bwd_reference,
                                                   struct_towers_reference)
    from mgvae_tpu_torch.examples.level_scan_profile import by_name
    from mgvae_tpu_torch.train import losses as losses_mod
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

    # The bounds of the "kernels" line. Bytes: every input array read once
    # and every output array written once, as the wrapper takes and returns
    # them (level tables and residuals over the real levels only; of the
    # step's hf only the rows of the level's distinct sources, its d_hf
    # whole). Operations: what this run's data needs with each slot reading
    # its own expert only: 2 * D * 2D per valid edge (key and value) and
    # 2 * D * 3D per updated slot (GRU input) forward; in the backward the
    # transposed products and the weight gradients, twice that and more.
    # The struct backward per half-round and tower: the weight gradients
    # (nbr^T dgi, state_in^T dgh: 12 N D^2) and the LayerNorm and GRU backward
    # (STRUCT_BWD_ELEMENTWISE operations per row and feature); every
    # half-round but the last (k = 0, whose initial state is a constant) also
    # the two row products (dgi W_fold^T, dgh W_hh^T: 12 N D^2) and the
    # transposed neighbor sum (D per edge). In bf16 (2-byte values) the
    # products run at the bf16 tensor cores' rate, the rest at fp32's.
    def typed_bound(moved, products, elementwise, vb):
        if vb == 2:
            return bound(moved, elementwise, bf16_products=products)
        return bound(moved, products + elementwise)

    def struct_bound(sargs, tables, n_edges, residuals, backward=False):
        N, D, hr = sargs[0].shape[2], sargs[1].shape[2], 2 * ROUNDS
        vb = sargs[0].element_size()   # the value type's bytes: the state and residuals
        state, res = 2 * N * D * vb, hr * 2 * N * 7 * D * vb
        if backward:   # in: dstate, res, wfold, w_hh, ln_w, lists; out: the six gradients
            moved = state + res + nbytes(sargs[1], sargs[2], sargs[4], *tables) + nbytes(*sargs)
            return typed_bound(moved, (2 * hr - 1) * 2 * 12 * N * D * D,
                               hr * 2 * STRUCT_BWD_ELEMENTWISE * N * D
                               + (hr - 1) * 2 * n_edges * D, vb)
        moved = nbytes(*sargs, *tables) + state + (res if residuals else 0)
        return typed_bound(moved, hr * 2 * 12 * N * D * D, hr * 2 * n_edges * D, vb)

    def level_work(evalid, upd, D, backward):
        """(products, elementwise operations) of the real levels' work."""
        e, u = int((evalid > 0).sum()), int((upd > 0).sum())
        if backward:
            return u * 12 * D * D + e * 8 * D * D, 0
        return e * 4 * D * D + u * 6 * D * D, e * 6 * D + u * 12 * D

    def level_bound(args, n_lv, N, residuals, backward=False):
        D, ep, np_ = args[0].shape[2] - 2, args[0].shape[1], args[4].shape[1]
        vb = args[0].element_size()    # the value type's bytes: hf, ghf and the residuals
        tabs = [a[:n_lv] for a in args[:7]]
        res = n_lv * (ep * (3 * D + 1) + np_ * 4 * D) * vb
        work = level_work(tabs[3], tabs[5], D, backward)
        if backward:   # in: ghf, residuals, tables, weights; out: d_pack, five weight gradients
            moved = (N * D * vb + res + nbytes(*tabs[1:], args[7], args[8], args[10], args[11])
                     + nbytes(tabs[0], *args[7:]))
            return typed_bound(moved, *work, vb)
        return typed_bound(nbytes(*tabs, *args[7:]) + N * D * vb + (res if residuals else 0),
                           *work, vb)

    def giant_bwd_bound(args, n_lv, N):
        # in: ghf, hf, tables, pack_lv, weights; out: d_pack, five weight gradients;
        # operations: the backward's and the recomputed forward's
        D, vb = args[0].shape[2] - 2, args[0].element_size()   # ghf and hf in the value type
        tabs = [a[:n_lv] for a in args[:7]]
        work = [b + f for b, f in zip(level_work(tabs[3], tabs[5], D, True),
                                      level_work(tabs[3], tabs[5], D, False))]
        moved = (2 * N * D * vb + nbytes(*tabs, *args[7:])
                 + nbytes(tabs[0], args[7], args[8], args[9], args[10], args[11]))
        return typed_bound(moved, *work, vb)

    def step_bound(step_args, residuals, backward=False):
        hf, pack, src, dslot, evalid, upd, e_n, *w = step_args
        D, ep, np_ = pack.shape[1] - 2, pack.shape[0], upd.shape[0]
        res = (ep * (3 * D + 1) + np_ * 4 * D) * 4
        flops = sum(level_work(evalid, upd, D, backward))
        if backward:   # in: g, residuals, tables, weights; out: d_pack, weight gradients, d_hf
            moved = (np_ * D * 4 + res + nbytes(src, dslot, evalid, upd, e_n, w[0], w[1], w[3], w[4])
                     + nbytes(pack, *w) + hf.shape[0] * D * 4)
            return bound(moved, flops)
        sources = int(torch.unique(src[evalid > 0]).numel())
        moved = sources * D * 4 + nbytes(*step_args[1:]) + np_ * D * 4 + (res if residuals else 0)
        return bound(moved, flops)

    clock("phase 2")
    # ---- 2. build ---------------------------------------------------------
    built = _build.build()
    log(f"[build] {built.path.name}: {built.seconds:.1f} s (0.0 = already built)")
    for line in built.log.splitlines():
        log(f"[build] {line}")
    _build.library()

    clock("phase 3")
    # ---- 3. kernel vs plain, per modality ---------------------------------
    enc_err = struct_err = 0.0
    lists_err = 0
    phase3 = []   # (modality, cfg, params, batch) for phase 6
    for i, mod in enumerate(MODALITIES):
        cfg = dg_ae.DGConfig(modality=mod, dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                             layernorm=True, matmul_precision="highest")
        params, _ = dg_ae.init_params(cfg, seed=SEED, device=dev)
        batch = collate(dataset(random_circuit, mod, 100 + i, BATCH))
        b = dg_ae.batch_to_device(batch, dev)
        sargs = struct_inputs(params["struct"], dg_ae.struct_input(b["gate"], cfg), b, True)
        tables = struct_tables(b)
        st_k = struct_kernel._forward_cuda(sargs, tables, ROUNDS, True, residuals=False)
        st_r = struct_towers_reference(*sargs, tables, ROUNDS, True)
        sync()
        if not (torch.isfinite(st_k).all() and torch.isfinite(st_r).all()):
            raise RuntimeError(f"[kernel] {mod}: non-finite struct state")
        s_err = (st_k - st_r).abs().max().item()
        log(f"[kernel] {mod}: struct towers {2 * ROUNDS} half-rounds x 2 towers, N={st_k.shape[1]} "
            f"D={DIM}: max|d state| all rows={s_err:.3e}; launch layout "
            f"{struct_kernel.forward_layout(st_k.shape[1], DIM)}")
        if not s_err <= KERNEL_TOL:
            raise RuntimeError(f"[kernel] {mod}: struct kernel disagrees with plain version "
                               f"(max|d state|={s_err}, tol {KERNEL_TOL})")
        struct_err = max(struct_err, s_err)
        hs = dg_ae.struct_hs(params, b, cfg)
        args = dg_ae.level_scan_inputs(params, b, cfg, hs)
        n_lv, N = dg_ae.num_levels(batch), hs.shape[0]
        # the index lists that the level kernels read: the kernel against the torch sorts
        tabs = [args[j] for j in (1, 2, 3, 5, 6)]
        lists_k = level_kernel.level_lists(*tabs, cfg.num_experts)
        lists_r = level_kernel.level_lists_reference(*tabs, cfg.num_experts)
        l_err = max(int((k.long() - r.long()).abs().max()) for k, r in zip(lists_k, lists_r))
        log(f"[kernel] {mod}: level lists of {args[1].shape[0]} levels (Ep={args[1].shape[1]}, "
            f"Np={args[4].shape[1]}): max|d| against the plain version, any entry = {l_err}")
        if l_err != 0:
            raise RuntimeError(f"[kernel] {mod}: the level-list kernel disagrees with its plain "
                               f"version")
        lists_err = max(lists_err, l_err)
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

    clock("phase 4")
    # ---- 4. main path: MIG bs16 encode_many -------------------------------
    model = Model(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                  layernorm=True, seed=SEED, device=DEVICE)
    graphs = dataset(random_circuit, "mig", 7, N_CIRCUITS)
    requests = [graphs[s : s + BATCH] for s in range(0, N_CIRCUITS, BATCH)]
    expected = sum(dg_ae.num_levels(collate(r)) for r in requests)
    s_expected = 2 * ROUNDS * len(requests)
    level_kernel.launches = level_kernel.levels_walked = struct_kernel.launches = 0
    level_kernel.lists_launches = 0
    out = model.encode_many(graphs, batch_size=BATCH)
    sync()
    enc_launches, walked = level_kernel.launches, level_kernel.levels_walked
    enc_lists = level_kernel.lists_launches
    enc_struct = struct_kernel.launches
    log(f"[main] encode_many: {len(graphs)} circuits in {len(requests)} bs{BATCH} requests; "
        f"struct_towers launches={enc_struct}, 2 * s_rounds * requests={s_expected}; "
        f"level_scan launches={enc_launches} (one per request), levels walked={walked}, real "
        f"levels={expected}; level_lists launches={enc_lists}")
    if enc_launches != len(requests) or walked != expected or enc_lists != len(requests):
        raise RuntimeError(f"[main] level_scan launches {enc_launches} != requests "
                           f"{len(requests)}, or levels walked {walked} != real levels "
                           f"{expected}")
    if enc_struct != s_expected:
        raise RuntimeError(f"[main] struct kernel launches {enc_struct} != {s_expected}")
    if len(out) != len(graphs):
        raise RuntimeError(f"[main] {len(out)} outputs for {len(graphs)} circuits")
    for g, (hs, hf) in zip(graphs, out):
        want = (g.num_nodes, DIM)
        if hs.shape != want or hf.shape != want:
            raise RuntimeError(f"[main] shapes {hs.shape} {hf.shape}, want {want}")
        if not (np.isfinite(hs).all() and np.isfinite(hf).all()):
            raise RuntimeError("[main] non-finite embeddings")
    # the same model (same seed, so the same weights) on the CPU, where the
    # struct towers and the level scan run their plain versions, for the
    # first request
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

    clock("phase 5")
    # ---- 5. timing (informational) ----------------------------------------
    cfg, params = model.cfg, model.params
    batch = collate(requests[0])
    n_lv = dg_ae.num_levels(batch)

    def encode(plain: bool):
        b = dg_ae.batch_to_device(batch, dev)
        if plain:  # the plain struct towers and level scan
            st = struct_towers_reference(
                *struct_inputs(params["struct"], dg_ae.struct_input(b["gate"], cfg), b,
                               cfg.layernorm), struct_tables(b), cfg.s_rounds, cfg.layernorm)
            hs = linear_apply(params["hs_linear"], torch.cat([st[0], st[1]], dim=-1))
            scan = level_scan_reference
        else:
            hs, scan = dg_ae.struct_hs(params, b, cfg), level_scan
        return hs, scan(*dg_ae.level_scan_inputs(params, b, cfg, hs),
                        num_nodes=hs.shape[0], num_levels=n_lv)

    b = dg_ae.batch_to_device(batch, dev)
    hs = dg_ae.struct_hs(params, b, cfg)
    args = dg_ae.level_scan_inputs(params, b, cfg, hs)
    sargs = struct_inputs(params["struct"], dg_ae.struct_input(b["gate"], cfg), b, True)
    tables = struct_tables(b)
    with torch.inference_mode():
        for _ in range(3):  # warm-up
            encode(False)
            encode(True)
        reps = 20
        t = {"plain": [], "kernel": []}
        for order in (("plain", "kernel"), ("kernel", "plain")):
            for name in order:
                t[name].append(median_wall(lambda: encode(name == "plain"), reps, sync))
        enc_k, enc_p = statistics.mean(t["kernel"]), statistics.mean(t["plain"])
        collate_s = median_wall(lambda: collate(requests[0]), 5, lambda: None)
        h2d_s = median_wall(lambda: dg_ae.batch_to_device(batch, dev), reps, sync)
        struct_s = median_wall(lambda: dg_ae.struct_hs(params, b, cfg), reps, sync)
        statics_s = median_wall(lambda: dg_ae.level_scan_inputs(params, b, cfg, hs), reps, sync)
        build_lists = lambda: level_kernel.level_lists(args[1], args[2], args[3], args[5],
                                                       args[6], cfg.num_experts)
        plain_lists = lambda: level_kernel.level_lists_reference(
            args[1], args[2], args[3], args[5], args[6], cfg.num_experts)
        lists_s = median_wall(build_lists, reps, sync)
        lists_p1 = event_ms(torch, plain_lists, reps)
        lists_k1 = event_ms(torch, build_lists, reps)
        lists_k2 = event_ms(torch, build_lists, reps)
        lists_p2 = event_ms(torch, plain_lists, reps)
        lists_ms, lists_plain_ms = (lists_k1 + lists_k2) / 2, (lists_p1 + lists_p2) / 2
        scan = dict(num_nodes=hs.shape[0], num_levels=n_lv)
        ms_p1 = event_ms(torch, lambda: level_scan_reference(*args, **scan), reps)
        ms_k1 = event_ms(torch, lambda: level_scan(*args, **scan), reps)
        ms_k2 = event_ms(torch, lambda: level_scan(*args, **scan), reps)
        ms_p2 = event_ms(torch, lambda: level_scan_reference(*args, **scan), reps)
        skern = lambda: struct_kernel._forward_cuda(sargs, tables, ROUNDS, True, residuals=False)
        splain = lambda: struct_towers_reference(*sargs, tables, ROUNDS, True)
        sms_p1 = event_ms(torch, splain, reps)
        sms_k1 = event_ms(torch, skern, reps)
        sms_k2 = event_ms(torch, skern, reps)
        sms_p2 = event_ms(torch, splain, reps)
    ms_k, ms_p = (ms_k1 + ms_k2) / 2, (ms_p1 + ms_p2) / 2
    sms_k, sms_p = (sms_k1 + sms_k2) / 2, (sms_p1 + sms_p2) / 2
    n_edges = int(batch["n_edges"])
    lists_now = build_lists()
    bounds = {"struct_towers": struct_bound(sargs, tables, n_edges, False),
              "level_scan": level_bound(args, n_lv, hs.shape[0], False),
              # in: five int tables; out: five lists; no arithmetic to speak of
              "level_lists": bound(nbytes(args[1], args[2], args[3], args[5], args[6],
                                          *lists_now), 0.0)}
    log(f"[time] card: {card}")
    log(f"[time] MIG bs{BATCH} encode (host batch -> hs, hf on card), median of {reps}: "
        f"kernels {enc_k * 1e3:.3f} ms = {BATCH / enc_k:.1f} graphs/s; "
        f"plain versions {enc_p * 1e3:.3f} ms = {BATCH / enc_p:.1f} graphs/s "
        f"(runs {[round(x * 1e3, 3) for x in t['kernel']]} / "
        f"{[round(x * 1e3, 3) for x in t['plain']]} ms)")
    log(f"[time] stages: collate (host) {collate_s * 1e3:.3f} ms; to device {h2d_s * 1e3:.3f} ms; "
        f"struct towers + hs_linear {struct_s * 1e3:.3f} ms; level statics "
        f"{statics_s * 1e3:.3f} ms; level scan {ms_k:.3f} ms")
    log(f"[time] level lists (built once per batch), CUDA events over {reps} builds: kernel "
        f"{lists_k1:.4f}/{lists_k2:.4f} ms, plain (torch sorts) {lists_p1:.4f}/{lists_p2:.4f} ms; "
        f"kernel {lists_s * 1e3:.3f} ms median wall synchronised; counted in the level scan's "
        f"time, whose wrapper builds them here")
    log(f"[time] level scan alone ({n_lv} levels), CUDA events over {reps} calls: "
        f"kernel {ms_k1:.4f}/{ms_k2:.4f} ms, plain {ms_p1:.4f}/{ms_p2:.4f} ms")
    log(f"[time] struct towers alone ({2 * ROUNDS} half-rounds, no residuals), CUDA events over "
        f"{reps} calls: kernel {sms_k1:.4f}/{sms_k2:.4f} ms, plain {sms_p1:.4f}/{sms_p2:.4f} ms")

    clock("phase 6")
    # ---- 6. backward kernels vs plain, per modality -----------------------
    res_err = bwd_err = sres_err = sbwd_err = 0.0
    grad_names = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak")
    sgrad_names = ("dxi", "dwfold", "dwhh", "dbhh", "dlnw", "dlnb")

    def written_rows(dslot, evalid, upd, n_lv, res_e, res_n):
        """The residuals with every row that the kernels leave unwritten
        set to 0, as the plain versions have them: the tables are all
        levels', of which the first ``n_lv`` ran, or one level's."""
        e_live, s_live = level_kernel.live_rows(dslot, evalid, upd)
        if e_live.dim() == 2:
            e_live[n_lv:], s_live[n_lv:] = False, False
        return (torch.where(e_live[..., None], res_e, 0.0),
                torch.where(s_live[..., None], res_n, 0.0))

    def held(mod, names, grads_k, grads_r):
        """max |d| / scale of each output; raises past 1e-4 * max(scale, 1)."""
        report, worst = [], 0.0
        for name, k, r in zip(names, grads_k, grads_r):
            if not (torch.isfinite(k).all() and torch.isfinite(r).all()):
                raise RuntimeError(f"[bwd] {mod}: non-finite {name}")
            err, scale = (k - r).abs().max().item(), r.abs().max().item()
            report.append(f"{name} {err:.3e}/{scale:.3e}")
            if not err <= GRAD_TOL * max(scale, 1.0):
                raise RuntimeError(f"[bwd] {mod}: {name} kernel disagrees with plain version: "
                                   f"max|d|={err}, scale={scale}")
            worst = max(worst, err)
        return "; ".join(report), worst

    for mod, cfg, params, batch in phase3:
        b = dg_ae.batch_to_device(batch, dev)
        with torch.no_grad():
            sargs = struct_inputs(params["struct"], dg_ae.struct_input(b["gate"], cfg), b, True)
            tables = struct_tables(b)
            st_k, sres_k = struct_kernel._forward_cuda(sargs, tables, ROUNDS, True, residuals=True)
            st_r, sres_r = struct_towers_reference(*sargs, tables, ROUNDS, True,
                                                   with_residuals=True)
            sync()
            sfwd = [(st_k - st_r).abs().max().item(), (sres_k - sres_r).abs().max().item()]
            if not max(sfwd) <= KERNEL_TOL:
                raise RuntimeError(f"[bwd] {mod}: struct residual forward disagrees: max|d| "
                                   f"state, res = {sfwd} (tol {KERNEL_TOL})")
            # bitwise repeatable, and the serving launch gives the same state
            st_k2, sres_k2 = struct_kernel._forward_cuda(sargs, tables, ROUNDS, True,
                                                         residuals=True)
            st_n = struct_kernel._forward_cuda(sargs, tables, ROUNDS, True, residuals=False)
            if not (torch.equal(st_k2, st_k) and torch.equal(sres_k2, sres_k)
                    and torch.equal(st_n, st_k)):
                raise RuntimeError(f"[bwd] {mod}: struct forward not bitwise repeatable")
            del st_k2, sres_k2, st_n
            sres_err = max(sres_err, *sfwd)
            dstate = torch.randn(st_k.shape, device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(SEED + 4))
            struct_kernel.bwd_launches = 0
            sgrads_k = struct_kernel._backward_cuda(dstate, sres_k, sargs[1], sargs[2], sargs[4],
                                                    tables, ROUNDS, True)
            sync()
            n_sbwd = struct_kernel.bwd_launches
            sgrads_r = struct_towers_bwd_reference(dstate, sres_k, sargs[1], sargs[2], sargs[4],
                                                   tables, ROUNDS, True)
            sync()
        report, worst = held(mod, sgrad_names, sgrads_k, sgrads_r)
        sbwd_err = max(sbwd_err, worst)
        log(f"[bwd] {mod}: struct residual forward max|d| state/res = {sfwd[0]:.3e}/"
            f"{sfwd[1]:.3e} (bitwise repeatable); struct backward max|d|/scale: {report}; struct bwd launches="
            f"{n_sbwd}")
        if n_sbwd != SBWD_LAUNCHES:
            raise RuntimeError(f"[bwd] {mod}: struct backward launches {n_sbwd} != "
                               f"{SBWD_LAUNCHES}")
        with torch.no_grad():
            hs = dg_ae.struct_hs(params, b, cfg)
            args = dg_ae.level_scan_inputs(params, b, cfg, hs)
        n_lv, N = dg_ae.num_levels(batch), hs.shape[0]
        hf_k, re_k, rn_k = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
        hf_r, re_r, rn_r = level_scan_reference(*args, num_nodes=N, num_levels=n_lv,
                                                with_residuals=True)
        sync()
        re_k, rn_k = written_rows(args[2], args[3], args[5], n_lv, re_k, rn_k)
        fwd = [(k - r).abs().max().item() for k, r in ((hf_k, hf_r), (re_k, re_r), (rn_k, rn_r))]
        if not max(fwd) <= KERNEL_TOL:
            raise RuntimeError(f"[bwd] {mod}: residual forward disagrees: max|d| hf, res_e, "
                               f"res_n = {fwd} (tol {KERNEL_TOL})")
        res_err = max(res_err, *fwd)
        ghf = torch.randn(hf_k.shape, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        bargs = (*args[:9], args[10], args[11])
        level_kernel.bwd_launches = level_kernel.bwd_levels_walked = 0
        grads_k = level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv)
        sync()
        n_bwd, bwd_walked = level_kernel.bwd_launches, level_kernel.bwd_levels_walked
        grads_r = level_kernel.level_scan_bwd_reference(ghf, re_k, rn_k, *bargs, num_levels=n_lv)
        again = (level_kernel._forward_cuda(args, N, n_lv, residuals=True)[0],
                 *level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv))
        sync()
        report, worst = held(mod, grad_names, grads_k, grads_r)
        bwd_err = max(bwd_err, worst)
        log(f"[bwd] {mod}: level residual forward max|d| hf/res_e/res_n = "
            f"{fwd[0]:.3e}/{fwd[1]:.3e}/{fwd[2]:.3e}; level backward max|d|/scale: {report}; "
            f"level bwd launches={n_bwd}, levels walked={bwd_walked}, real levels={n_lv}")
        if n_bwd != 3 or bwd_walked != n_lv:
            raise RuntimeError(f"[bwd] {mod}: backward launches {n_bwd} != 3 (sweep, partials, "
                               f"sums), or levels walked {bwd_walked} != real levels {n_lv}")
        if not all(torch.equal(a, c) for a, c in zip(again, (hf_k, *grads_k))):
            raise RuntimeError(f"[bwd] {mod}: a second run of the level kernels differs")

    clock("phase 7")
    # ---- 7. training main path: MIG bs16 train steps ---------------------
    cfg = model.cfg
    params, state = dg_ae.init_params(cfg, seed=SEED, device=dev)
    optimizer = train_step_mod.make_optimizer(params, TRAIN_LR)
    train_step, eval_step = train_step_mod.make_train_step(cfg, optimizer)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    keys = train_step_mod.METRIC_KEYS + ("loss",)
    batches = [collate(r) for r in requests]
    levels = [dg_ae.num_levels(bt) for bt in batches]
    per_step, rows = [], []
    def main_counts():
        return (level_kernel.launches, level_kernel.bwd_launches, struct_kernel.launches,
                struct_kernel.bwd_launches, level_kernel.levels_walked,
                level_kernel.bwd_levels_walked)

    for m in (level_kernel, struct_kernel):
        m.launches = m.bwd_launches = 0
    level_kernel.levels_walked = level_kernel.bwd_levels_walked = 0
    for i in range(TRAIN_STEPS):
        before = main_counts()
        state, metrics = train_step(params, state, batches[i % len(batches)], gen, WEIGHTS)
        after = main_counts()
        per_step.append(tuple(a - z for a, z in zip(after, before)))
        rows.append(torch.stack([metrics[k] for k in keys]))
    sync()
    train_fwd, train_bwd = level_kernel.launches, level_kernel.bwd_launches
    train_walked = (level_kernel.levels_walked, level_kernel.bwd_levels_walked)
    train_sfwd, train_sbwd = struct_kernel.launches, struct_kernel.bwd_launches
    rows = torch.stack(rows).cpu()
    log(f"[train] {TRAIN_STEPS} train_steps over {len(batches)} bs{BATCH} MIG batches "
        f"(real levels {levels}), lr {TRAIN_LR}, weights {WEIGHTS}: struct_towers launches="
        f"{train_sfwd}, struct_towers_bwd launches={train_sbwd}, level_scan launches="
        f"{train_fwd} having walked {train_walked[0]} levels, level_scan_bwd launches="
        f"{train_bwd} having walked {train_walked[1]}")
    for i in (0, 1, TRAIN_STEPS - 1):
        log(f"[train] step {i}: " + ", ".join(
            f"{k}={v:.6g}" for k, v in zip(keys, rows[i].tolist())))
    if not torch.isfinite(rows).all():
        raise RuntimeError("[train] non-finite loss or metric")
    want = [(1, 3, 2 * ROUNDS, SBWD_LAUNCHES, n, n)
            for n in (levels[i % len(batches)] for i in range(TRAIN_STEPS))]
    if per_step != want or train_fwd == 0 or train_bwd == 0:
        raise RuntimeError(f"[train] per-step counts {per_step} != (1 level launch, 3 backward, "
                           f"2 * s_rounds, 4 * s_rounds + 1, real levels walked, and backward) "
                           f"{want}")
    for leaf in train_step_mod.param_leaves(params):
        if not torch.isfinite(leaf).all():
            raise RuntimeError("[train] non-finite parameter after training")

    def fixed_draws(batch, seed):
        """Negatives over the batch's valid rows and dropout keep masks, on
        the CPU, for runs that must see the same draws."""
        g = torch.Generator().manual_seed(seed)
        n_real, e_pad, n_pad = (int(batch["n_nodes"]), batch["edge_src"].shape[0],
                                batch["gate"].shape[0])
        neg = tuple(losses_mod.to_valid_runs(t.to(torch.int32), batch)
                    for t in torch.randint(0, n_real, (2, e_pad), generator=g))
        keep = [torch.rand(n_pad, cfg.dim_mlp, generator=g) < 0.8 for _ in range(2)]
        return neg, keep

    def vae_draws(batch, cfg_x, where):
        """DG_VAE's posterior noise (eps_s, eps_t) for the batch's rows, made
        on the CPU from a fixed seed, on ``where``; None for other models."""
        if not cfg_x.variational:
            return None
        g = torch.Generator().manual_seed(SEED + 4)
        return tuple(torch.randn(batch["gate"].shape[0], cfg_x.dim_hidden, generator=g).to(where)
                     for _ in range(2))

    def card_vs_cpu_step(tag, batch, weights, cfg_x=None):
        """One step's losses and gradients on the card and on the CPU: same
        params, batch, loss weights, negatives, dropout masks and (DG_VAE)
        posterior noise. ``cfg_x``: the model, phase 7's by default."""
        cfg_x = cfg_x or cfg
        neg, keep = fixed_draws(batch, SEED + 2)
        one = {}
        for where in ("cpu", DEVICE):
            p1, s1 = dg_ae.init_params(cfg_x, seed=SEED + 3, device=where)
            leaves = train_step_mod.param_leaves(p1)
            for t in leaves:
                t.requires_grad_(True)
            total, (_, m1) = train_step_mod.loss_and_metrics(
                p1, s1, batch, None, weights, cfg_x, True,
                neg_edges=tuple(t.to(where) for t in neg), drop_keep=[k.to(where) for k in keep],
                vae_eps=vae_draws(batch, cfg_x, where))
            total.backward()
            one[where] = ({k: float(m1[k]) for k in keys},
                          [torch.zeros(t.shape) if t.grad is None else t.grad.cpu()
                           for t in leaves])
        (m_c, g_c), (m_g, g_g) = one["cpu"], one[DEVICE]
        # the losses, not the counts: a logit within rounding of 0 may flip one
        loss_keys = ("recon_loss", "prob_loss", "func_loss", "kl_loss", "loss")
        loss_err = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1.0) for k in loss_keys)
        g_scale = max(g.abs().max().item() for g in g_c)
        # per leaf: (|d| / tol, |d|, leaf scale); the worst leaf is reported
        g_leaf = max(((a - c).abs().max().item() / (GRAD_TOL * max(c.abs().max().item(),
                                                                    GRAD_FLOOR * g_scale)),
                      (a - c).abs().max().item(), c.abs().max().item())
                     for a, c in zip(g_g, g_c))
        log(f"[{tag}] card vs CPU, one step, weights {weights}: losses (recon/prob/func/kl) "
            f"{m_g['recon_loss']:.6f}/{m_g['prob_loss']:.6f}/{m_g['func_loss']:.6f}/"
            f"{m_g['kl_loss']:.6f} vs {m_c['recon_loss']:.6f}/{m_c['prob_loss']:.6f}/"
            f"{m_c['func_loss']:.6f}/{m_c['kl_loss']:.6f}; max rel |d| of the losses "
            f"{loss_err:.3e}; tp/fp {m_g['tp']:.0f}/{m_g['fp']:.0f} vs {m_c['tp']:.0f}/"
            f"{m_c['fp']:.0f}; gradients, worst leaf against its own scale: max|d| "
            f"{g_leaf[1]:.3e} at scale {g_leaf[2]:.3e}, {g_leaf[0]:.3f} of its tolerance "
            f"(tol {GRAD_TOL} * max(leaf scale, {GRAD_FLOOR} * {g_scale:.3e}))")
        if not (loss_err <= CPU_TOL and g_leaf[0] <= 1.0):
            raise RuntimeError(f"[{tag}] card and CPU disagree on one training step")

    def card_vs_cpu_prob(tag, batch, near=1e-4, cfg_x=None):
        """The prob loss alone on the card and on the CPU at a size where
        some ReLU unit of its readout lies within rounding of 0 (see
        SMOOTH_WEIGHTS): the readout's pre-activations are compared as they
        are, and the loss's gradients with the units within ``near`` of a
        kink on either device masked on both: hidden units near 0, and
        nodes whose prediction is near 0, 1 or its target."""
        cfg_x = cfg_x or cfg
        _, keep = fixed_draws(batch, SEED + 2)
        side = {}
        for where in ("cpu", DEVICE):
            p1, s1 = dg_ae.init_params(cfg_x, seed=SEED + 3, device=where)
            leaves = train_step_mod.param_leaves(p1)
            for t in leaves:
                t.requires_grad_(True)
            b1 = dg_ae.batch_to_device(batch, where)
            _, hf, _ = dg_ae.forward_device(p1, b1, cfg_x, dg_ae.level_counts(batch),
                                            vae_eps=vae_draws(batch, cfg_x, where))
            side[where] = (p1["readout_prob"], s1["readout_prob"], b1, hf, leaves,
                           [k.to(where) for k in keep])

        def readout(where, masks, x=None):
            """(pre-activations so far, prediction or None): the readout as
            ``ops.mlp.mlp_apply`` in train mode, through ``len(masks)``
            hidden layers, a masked unit's output 0."""
            rp, rs, b1, hf, _, kp = side[where]
            x, pre = hf if x is None else x, []
            for i, m in enumerate(masks):
                x, _ = mlp_mod.batchnorm_apply(rp["bn"][i], rs["bn"][i],
                                               linear_apply(rp["layers"][i], x),
                                               valid=b1["node_valid"], train=True)
                pre.append(x)
                if m is None:
                    return pre, None
                x = mlp_mod.dropout(torch.where(m.to(x.device), 0.0, torch.relu(x)),
                                    mlp_mod.P_DROP, True, None, kp[i])
            return pre, linear_apply(rp["layers"][-1], x)[:, 0]

        masks, pre_err = [], []
        with torch.no_grad():
            for i in range(2):       # a layer's mask needs the masks of the layers before it
                z_c, z_g = (readout(w, masks + [None])[0][i] for w in ("cpu", DEVICE))
                rows = side["cpu"][2]["node_valid"]
                pre_err.append((z_g.cpu() - z_c)[rows].abs().max().item())
                masks.append((z_c.abs() < near) | (z_g.cpu().abs() < near))
            kinks = []
            for where in ("cpu", DEVICE):
                pred, prob = readout(where, masks)[1].cpu(), side["cpu"][2]["prob"]
                kinks.append((pred.abs() < near) | ((pred - 1).abs() < near)
                             | ((pred - prob).abs() < near))
            smooth = ~(kinks[0] | kinks[1])
        out = {}
        for where in ("cpu", DEVICE):
            _, _, b1, _, leaves, _ = side[where]
            pred = readout(where, masks)[1].clamp(0.0, 1.0)
            rows = b1["node_valid"] & smooth.to(pred.device)
            loss = losses_mod.masked_mean((pred - b1["prob"]).abs(), rows,
                                          b1["n_nodes"].to(pred.dtype))
            loss.backward()
            out[where] = (float(loss), [torch.zeros(t.shape) if t.grad is None else t.grad.cpu()
                                        for t in leaves])
        (l_c, g_c), (l_g, g_g) = out["cpu"], out[DEVICE]
        g_scale = max(g.abs().max().item() for g in g_c)
        g_leaf = max(((a - c).abs().max().item() / (GRAD_TOL * max(c.abs().max().item(),
                                                                    GRAD_FLOOR * g_scale)),
                      (a - c).abs().max().item(), c.abs().max().item())
                     for a, c in zip(g_g, g_c))
        hidden = sum(int(m.sum()) for m in masks)
        log(f"[{tag}] card vs CPU, the prob loss alone: readout pre-activations max|d| "
            f"{pre_err[0]:.3e}/{pre_err[1]:.3e} (tol {CPU_TOL}); masked within {near} of a kink "
            f"on either device: {hidden} of {sum(m.numel() for m in masks)} hidden units, "
            f"{int((~smooth).sum())} of {smooth.numel()} predictions; loss {l_g:.6f} vs "
            f"{l_c:.6f}; gradients, worst leaf against its own scale: max|d| {g_leaf[1]:.3e} at "
            f"scale {g_leaf[2]:.3e}, {g_leaf[0]:.3f} of its tolerance")
        if not (max(pre_err) <= CPU_TOL and abs(l_g - l_c) <= CPU_TOL * max(abs(l_c), 1.0)
                and g_leaf[0] <= 1.0 and g_scale > 0):
            raise RuntimeError(f"[{tag}] card and CPU disagree on the prob loss")

    card_vs_cpu_step("train", batches[0], WEIGHTS)

    clock("phase 8")
    # ---- 8. training timing (informational) -------------------------------
    batch = batches[0]
    n_lv = dg_ae.num_levels(batch)
    def staged_ms(params, state, optimizer, batch, weights, warm: int, reps: int) -> dict:
        """Median milliseconds of a train step's stages over ``reps`` steps
        (after ``warm`` more), with a synchronise after each stage."""
        stage = {"forward": [], "losses": [], "backward": [], "adam": []}
        for i in range(warm + reps):
            t = [time.perf_counter()]
            optimizer.zero_grad(set_to_none=True)
            b = dg_ae.batch_to_device(batch, dev)
            hs, hf, _ = dg_ae.forward_device(params, b, cfg, dg_ae.level_counts(batch))
            sync(); t.append(time.perf_counter())
            total, _ = train_step_mod.losses_from_forward(params, state, b, hs, hf, gen, weights,
                                                          cfg, True)
            sync(); t.append(time.perf_counter())
            total.backward()
            sync(); t.append(time.perf_counter())
            optimizer.step()
            sync(); t.append(time.perf_counter())
            if i >= warm:
                for name, a, z in zip(stage, t, t[1:]):
                    stage[name].append(z - a)
        return {k: statistics.median(v) * 1e3 for k, v in stage.items()}

    for _ in range(3):  # warm-up
        train_step(params, state, batch, gen, WEIGHTS)
    reps = 20
    step_s = median_wall(lambda: train_step(params, state, batch, gen, WEIGHTS), reps, sync)
    stage_ms = staged_ms(params, state, optimizer, batch, WEIGHTS, 3, reps)
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
    # as on the training path: the lists and the expert-major weights come from the forward
    prepared = level_kernel._prepared(args, backward=True)
    kern = lambda: level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv, *prepared)
    plain = lambda: torch.autograd.grad(hf_plain, diff, ghf, retain_graph=True)
    for _ in range(3):
        kern()
        plain()
    bms_p1 = event_ms(torch, plain, reps)
    bms_k1 = event_ms(torch, kern, reps)
    bms_k2 = event_ms(torch, kern, reps)
    bms_p2 = event_ms(torch, plain, reps)
    bms_k, bms_p = (bms_k1 + bms_k2) / 2, (bms_p1 + bms_p2) / 2
    # the struct towers, likewise: the forward with residuals, and the
    # backward alone against autograd through the plain version
    with torch.no_grad():
        sargs = [a.detach().clone() for a in struct_inputs(
            params["struct"], dg_ae.struct_input(b["gate"], cfg), b, cfg.layernorm)]
        tables = struct_tables(b)
        skern = lambda: struct_kernel._forward_cuda(sargs, tables, ROUNDS, True, residuals=True)
        splain = lambda: struct_towers_reference(*sargs, tables, ROUNDS, True, with_residuals=True)
        for _ in range(3):
            skern()
            splain()
        srms_p1 = event_ms(torch, splain, reps)
        srms_k1 = event_ms(torch, skern, reps)
        srms_k2 = event_ms(torch, skern, reps)
        srms_p2 = event_ms(torch, splain, reps)
        _, sres = skern()
    srms_k, srms_p = (srms_k1 + srms_k2) / 2, (srms_p1 + srms_p2) / 2
    dstate = torch.randn((2, N, DIM), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
    for a in sargs:
        a.requires_grad_(True)
    st_plain = struct_towers_reference(*sargs, tables, ROUNDS, True)
    skern = lambda: struct_kernel._backward_cuda(dstate, sres, sargs[1], sargs[2], sargs[4],
                                                 tables, ROUNDS, True)
    splain = lambda: torch.autograd.grad(st_plain, sargs, dstate, retain_graph=True)
    for _ in range(3):
        skern()
        splain()
    sbms_p1 = event_ms(torch, splain, reps)
    sbms_k1 = event_ms(torch, skern, reps)
    sbms_k2 = event_ms(torch, skern, reps)
    sbms_p2 = event_ms(torch, splain, reps)
    sbms_k, sbms_p = (sbms_k1 + sbms_k2) / 2, (sbms_p1 + sbms_p2) / 2
    # the struct backward by kernel name (device time per call under torch.profiler)
    sb_names = by_name(skern, reps)
    bounds.update(
        struct_towers_residuals=struct_bound(sargs, tables, n_edges, True),
        struct_towers_bwd=struct_bound(sargs, tables, n_edges, True, backward=True),
        level_scan_residuals=level_bound(args, n_lv, N, True),
        level_scan_bwd=level_bound(args, n_lv, N, True, backward=True))
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
    log(f"[time] struct towers forward with residuals ({2 * ROUNDS} half-rounds), CUDA events "
        f"over {reps} calls: kernel {srms_k1:.4f}/{srms_k2:.4f} ms, plain "
        f"{srms_p1:.4f}/{srms_p2:.4f} ms")
    log(f"[time] struct towers backward alone, CUDA events over {reps} calls: kernel "
        f"{sbms_k1:.4f}/{sbms_k2:.4f} ms, autograd through the plain version "
        f"{sbms_p1:.4f}/{sbms_p2:.4f} ms")
    for name, (us, n) in sorted(sb_names.items(), key=lambda kv: -kv[1][0]):
        log(f"[time] struct towers backward by kernel name: {us:10.2f} us in {n:5.1f} launches "
            f"per call  {name[:90]}")

    clock("phase 9")
    # ---- 9. train-step profile (informational) ----------------------------
    profile_train(torch, lambda: train_step(params, state, batch, gen, WEIGHTS), card,
                  f"MIG bs{BATCH} train step")

    clock("[trainer]")
    # ---- [trainer]: the 3-stage CLI on the card -----------------------------
    trainer_phase(torch, dev, card)

    clock("[variants]")
    # ---- [variants]: DG_VAE, AE and num_rounds = 2 ------------------------------
    variants = {"DG_AE": cfg, "DG_VAE": dataclasses.replace(cfg, variational=True),
                "AE": dataclasses.replace(cfg, struct_encoder="gcn"),
                "num_rounds=2": dataclasses.replace(cfg, num_rounds=2)}
    var_names = "(struct, struct bwd, level, level bwd, lists, step and giant)"

    def var_zero():
        for m in (level_kernel, struct_kernel):
            m.launches = m.bwd_launches = 0
        level_kernel.lists_launches = level_kernel.step_launches = 0
        level_kernel.step_bwd_launches = level_kernel.giant_launches = 0
        level_kernel.giant_bwd_launches = 0

    def var_read():
        return (struct_kernel.launches, struct_kernel.bwd_launches, level_kernel.launches,
                level_kernel.bwd_launches, level_kernel.lists_launches,
                level_kernel.step_launches + level_kernel.step_bwd_launches
                + level_kernel.giant_launches + level_kernel.giant_bwd_launches)

    # (a)-(c) the main path of each variant: VARIANT_STEPS train steps on the
    # card, the launches of each read with the counts set to 0 before it
    b16 = batches[0]
    var_steps, var_ms = {}, {}
    for name, cfg_v in variants.items():
        p_v, s_v = dg_ae.init_params(cfg_v, seed=SEED, device=dev)
        ts_v, _ = train_step_mod.make_train_step(
            cfg_v, train_step_mod.make_optimizer(p_v, TRAIN_LR))
        gen_v = torch.Generator(device=dev).manual_seed(SEED)
        per, kl = [], []
        for i in range(VARIANT_STEPS):
            var_zero()
            s_v, m_v = ts_v(p_v, s_v, batches[i % len(batches)], gen_v, VARIANT_WEIGHTS)
            sync()
            per.append(var_read())
            vals = torch.stack([m_v[k] for k in keys]).cpu()
            if not torch.isfinite(vals).all():
                raise RuntimeError(f"[variants] {name}: non-finite loss or metric")
            kl.append(float(m_v["kl_loss"]))
        var_steps[name] = sorted(set(per))
        # (d) the bs16 train step's median wall time (informational)
        reps = 3 if cfg_v.num_rounds > 1 else 5
        var_ms[name] = median_wall(lambda: ts_v(p_v, s_v, b16, gen_v, VARIANT_WEIGHTS), reps,
                                   sync) * 1e3
        if name in ("AE", "num_rounds=2"):   # where the plain torch of the variant goes
            profile_train(torch, lambda: ts_v(p_v, s_v, b16, gen_v, VARIANT_WEIGHTS), card,
                          f"{name} MIG bs{BATCH} train step", steps=1, rows=12, warm=0)
        log(f"[variants] {name}: {VARIANT_STEPS} train steps, weights {VARIANT_WEIGHTS}, "
            f"launches per step {var_names} {var_steps[name]}; kl_loss {kl}")
        if (kl[0] != 0.0) != cfg_v.variational:
            raise RuntimeError(f"[variants] {name}: kl_loss {kl} (nonzero exactly for DG_VAE)")
    want_steps = {"DG_AE": [(2 * ROUNDS, SBWD_LAUNCHES, 1, 3, 1, 0)],
                  "DG_VAE": var_steps["DG_AE"], "AE": [(0, 0, 1, 3, 1, 0)],
                  "num_rounds=2": [(2 * ROUNDS, SBWD_LAUNCHES, 0, 0, 0, 0)]}
    if var_steps != want_steps:
        raise RuntimeError(f"[variants] launches per train step {var_steps} != {want_steps}")

    clock("[variants] encode and one step card vs CPU")
    # encode and one train step of each, card vs CPU
    want_enc = {"DG_VAE": (2 * ROUNDS, 0, 1, 0, 1, 0), "AE": (0, 0, 1, 0, 1, 0),
                "num_rounds=2": (2 * ROUNDS, 0, 0, 0, 0, 0)}
    for name, want in want_enc.items():
        cfg_v = variants[name]
        enc = {}
        for where in ("cpu", DEVICE):
            p_v, _ = dg_ae.init_params(cfg_v, seed=SEED, device=where)
            var_zero()
            with torch.inference_mode():
                hs_v, hf_v, aux_v = dg_ae.forward(p_v, b16, cfg_v,
                                                  vae_eps=vae_draws(b16, cfg_v, where))
            sync()
            enc[where] = (hs_v.cpu(), hf_v.cpu(), {k: v.cpu() for k, v in aux_v.items()},
                          var_read())
        (hs_c, hf_c, aux_c, _), (hs_g, hf_g, aux_g, got) = enc["cpu"], enc[DEVICE]
        rows = torch.as_tensor(b16["node_valid"])
        d = {k: (a[rows] - c[rows]).abs().max().item()
             for k, a, c in [("hs", hs_g, hs_c), ("hf", hf_g, hf_c)]
             + [(k, aux_g[k], aux_c[k]) for k in sorted(aux_c)]}
        log(f"[variants] {name} encode (bs{BATCH} MIG): launches {var_names} {got}; card vs CPU "
            f"max|d| " + ", ".join(f"{k} {v:.3e}" for k, v in d.items()) + f" (tol {CPU_TOL})")
        if got != want or sorted(aux_g) != sorted(aux_c) or not all(
                v <= CPU_TOL for v in d.values()) or not torch.isfinite(hf_g).all():
            raise RuntimeError(f"[variants] {name} encode: launches {got} (want {want}) or card "
                               f"and CPU disagree")
        card_vs_cpu_step(f"variants {name}", b16, VARIANT_SMOOTH_WEIGHTS, cfg_x=cfg_v)
        card_vs_cpu_prob(f"variants {name}", b16, cfg_x=cfg_v)

    clock("[variants] Model(variational=True) and the CLI")
    # DG_VAE through api.Model: its noise from its own device generator,
    # repeatable from the seed and fresh on every request
    vae_models = [Model(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                        layernorm=True, variational=True, seed=SEED, device=DEVICE)
                  for _ in range(2)]
    var_zero()
    first = vae_models[0].encode_many(requests[0], batch_size=BATCH)
    sync()
    got = var_read()
    again = vae_models[0].encode_many(requests[0], batch_size=BATCH)
    twin = vae_models[1].encode_many(requests[0], batch_size=BATCH)
    d_twin = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(first, twin))
    d_again = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(first, again))
    log(f"[variants] Model(variational=True).encode_many, one bs{BATCH} request: launches "
        f"{var_names} {got}; hf of a second model of the same seed max|d| {d_twin:.3e}, of the "
        f"next request of the same model {d_again:.3e}")
    if got != want_enc["DG_VAE"] or not d_twin <= 1e-6 or not d_again > 1e-3 or not all(
            np.isfinite(h).all() for pair in first for h in pair):
        raise RuntimeError("[variants] Model(variational=True): launches, or draws not "
                           "repeatable from the seed and fresh per request")

    # (a) the CLI with the parser's default model (DG_VAE), KL in the loss
    from mgvae_tpu_torch import cli
    var_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "exp", "chip_smoke_vae")
    shutil.rmtree(var_root, ignore_errors=True)
    t0 = time.perf_counter()
    vae_trainer = cli.main(VAE_ARGV + ["--save_dir", var_root])
    sync()
    wall = time.perf_counter() - t0
    run_dir = os.path.join(var_root, "vae")
    files = ("stage_1.pth", "stage_2.pth", "stage_3.pth", "model_0.pth", "model_last.pth")
    missing = [f for f in files if not os.path.isfile(os.path.join(run_dir, f))]
    (log_file,) = [f for f in os.listdir(run_dir) if f.startswith("log-")]
    with open(os.path.join(run_dir, log_file)) as f:
        lines = [ln.rstrip("\n") for ln in f if "| Epoch:" in ln]
    for ln in lines:
        log(f"[variants] DG_VAE CLI log: {ln}")
    log(f"[variants] python -m mgvae_tpu_torch.train {' '.join(VAE_ARGV)} in-process on {dev}: "
        f"{wall:.1f} s; model variational={vae_trainer.model_cfg.variational}, weights "
        f"{vae_trainer.weights}; files missing {missing}")
    if missing or not vae_trainer.model_cfg.variational or len(lines) != 6 or not all(
            re.match(VAE_EPOCH_LINE, ln) for ln in lines):
        raise RuntimeError("[variants] the DG_VAE CLI: files missing, or not 6 epoch lines with "
                           "the KL field")
    shutil.rmtree(var_root, ignore_errors=True)

    # (d) the bs16 train step of each variant, in this call (informational)
    log(f"[variants] card: {card}")
    log(f"[variants] MIG bs{BATCH} train step (host batch -> Adam update, synchronised), "
        f"median ms: " + ", ".join(f"{k} {v:.3f}" for k, v in var_ms.items()))

    clock("[precision]")
    # ---- [precision]: bf16 values and the TF32 mode -------------------------------
    t_precision = time.perf_counter()
    # (b) the main path in bf16: BF16_STEPS train steps of phase 7's model
    # (MIG bs16, D=64, "highest") with compute_dtype="bfloat16", counts zeroed
    # just before and read just after: the bf16 kernels' launches
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    p16, s16 = dg_ae.init_params(cfg16, seed=SEED, device=dev)
    ts16, _ = train_step_mod.make_train_step(cfg16, train_step_mod.make_optimizer(p16, TRAIN_LR))
    gen16 = torch.Generator(device=dev).manual_seed(SEED)
    var_zero()
    rows16 = []
    for i in range(BF16_STEPS):
        s16, m16 = ts16(p16, s16, batches[i % len(batches)], gen16, WEIGHTS)
        rows16.append(torch.stack([m16[k].float() for k in keys]))
    sync()
    bf16_counts = var_read()
    rows16 = torch.stack(rows16).cpu()
    want16 = (BF16_STEPS * 2 * ROUNDS, BF16_STEPS * SBWD_LAUNCHES, BF16_STEPS, 3 * BF16_STEPS,
              BF16_STEPS, 0)
    log(f"[precision] bf16 main path: {BF16_STEPS} train steps (MIG bs{BATCH}, D={DIM}, "
        f"weights {WEIGHTS}): launches {var_names} {bf16_counts}; losses "
        + "; ".join(", ".join(f"{k}={v:.5g}" for k, v in zip(keys, r.tolist())) for r in rows16))
    if bf16_counts != want16 or not torch.isfinite(rows16).all() or not all(
            t.dtype == torch.float32 and torch.isfinite(t).all()
            for t in train_step_mod.param_leaves(p16)):
        raise RuntimeError(f"[precision] bf16 train steps: launches {bf16_counts} != {want16}, "
                           f"or non-finite losses or fp32 master params")

    def bf16_close(tag, got, want, atol, same_rounding=True):
        """Values within atol + BF16_RTOL |want|, and with ``same_rounding``
        within BF16_ULPS of max |want|; returns max |d|."""
        got, want = got.float(), want.float()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        if not torch.isfinite(got).all() or not bool(
                ((got - want).abs() <= atol + BF16_RTOL * want.abs()).all()):
            raise RuntimeError(f"[precision] {tag}: max|d| {err} past atol {atol} / rtol "
                               f"{BF16_RTOL}")
        if same_rounding and not err <= BF16_ULPS * scale:
            raise RuntimeError(f"[precision] {tag}: max|d| {err} past {BF16_ULPS} * {scale}")
        return err

    def bf16_grads(tag, names, got, want):
        """Each output within BF16_ULPS of its own max |want| (no floor);
        returns (report, worst |d|)."""
        report, worst = [], 0.0
        for name, k, r in zip(names, got, want):
            k, r = k.float(), r.float()
            err, scale = (k - r).abs().max().item(), r.abs().max().item()
            report.append(f"{name} {err:.3e}/{scale:.3e}")
            if not torch.isfinite(k).all() or not err <= BF16_ULPS * scale:
                raise RuntimeError(f"[precision] {tag}: {name} max|d| {err} past "
                                   f"{BF16_ULPS} * {scale}")
            worst = max(worst, err)
        return "; ".join(report), worst

    # (a) the four bf16 kernels against their plain bf16 versions, on phase
    # 3's MIG batch at D=64, with CUDA-event times (plain, kernel, kernel, plain)
    _, cfg3, params3, batch3 = phase3[MODALITIES.index("mig")]
    c16 = dataclasses.replace(cfg3, compute_dtype="bfloat16")
    b3 = dg_ae.batch_to_device(batch3, dev)
    n_lv3, reps = dg_ae.num_levels(batch3), 20
    with torch.no_grad():
        p3 = dg_ae.cast_params(params3, c16)
        sa16 = struct_inputs(p3["struct"], dg_ae.struct_input(b3["gate"], c16), b3, True)
        tab3 = struct_tables(b3)
        st_k, sres_k = struct_kernel._forward_cuda(sa16, tab3, ROUNDS, True, residuals=True)
        st_r, sres_r = struct_towers_reference(*sa16, tab3, ROUNDS, True, with_residuals=True)
        b16_sfwd = max(bf16_close("struct towers state", st_k, st_r, BF16_ATOL),
                       bf16_close("struct towers residuals", sres_k, sres_r, BF16_ATOL))
        ds16 = torch.randn(st_k.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED + 4)).to(torch.bfloat16)
        sbw = (ds16, sres_k, sa16[1], sa16[2], sa16[4], tab3, ROUNDS, True)
        srep, b16_sbwd = bf16_grads("struct towers backward", sgrad_names,
                                    struct_kernel._backward_cuda(*sbw),
                                    struct_towers_bwd_reference(*sbw))
        hs3 = dg_ae.struct_hs(p3, b3, c16)
        a16 = dg_ae.level_scan_inputs(p3, b3, c16, hs3)
        N3 = hs3.shape[0]
        hf_k, re_k, rn_k = level_kernel._forward_cuda(a16, N3, n_lv3, residuals=True)
        hf_r, re_r, rn_r = level_scan_reference(*a16, num_nodes=N3, num_levels=n_lv3,
                                                with_residuals=True)
        re_k, rn_k = written_rows(a16[2], a16[3], a16[5], n_lv3, re_k, rn_k)
        b16_fwd = max(bf16_close(f"level scan {name}", k, r, BF16_ATOL)
                      for name, k, r in (("hf", hf_k, hf_r), ("res_e", re_k, re_r),
                                         ("res_n", rn_k, rn_r)))
        ghf16 = torch.randn(hf_k.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED + 1)).to(torch.bfloat16)
        lbw = (ghf16, re_k, rn_k)
        lrep, b16_bwd = bf16_grads("level scan backward", grad_names,
                                   level_kernel._backward_cuda(*lbw, a16, n_lv3),
                                   level_kernel.level_scan_bwd_reference(
                                       *lbw, *a16[:9], a16[10], a16[11], num_levels=n_lv3))
        sync()
        timed = {
            "struct_towers_bf16": (
                lambda: struct_kernel._forward_cuda(sa16, tab3, ROUNDS, True, residuals=True),
                lambda: struct_towers_reference(*sa16, tab3, ROUNDS, True, with_residuals=True)),
            "struct_towers_bwd_bf16": (lambda: struct_kernel._backward_cuda(*sbw),
                                       lambda: struct_towers_bwd_reference(*sbw)),
            "level_scan_bf16": (
                lambda: level_kernel._forward_cuda(a16, N3, n_lv3, residuals=True),
                lambda: level_scan_reference(*a16, num_nodes=N3, num_levels=n_lv3,
                                             with_residuals=True)),
            "level_scan_bwd_bf16": (
                lambda: level_kernel._backward_cuda(*lbw, a16, n_lv3),
                lambda: level_kernel.level_scan_bwd_reference(*lbw, *a16[:9], a16[10], a16[11],
                                                              num_levels=n_lv3)),
        }
        b16_ms = {}
        for name, (kern, plain) in timed.items():
            pr = 3 if "level" in name else reps
            p1, k1, k2, p2 = (event_ms(torch, f, n) for f, n in
                              ((plain, pr), (kern, reps), (kern, reps), (plain, pr)))
            b16_ms[name] = ((k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2))
    n_e3 = int(batch3["n_edges"])
    bounds.update(struct_towers_bf16=struct_bound(sa16, tab3, n_e3, True),
                  struct_towers_bwd_bf16=struct_bound(sa16, tab3, n_e3, True, backward=True),
                  level_scan_bf16=level_bound(a16, n_lv3, N3, True),
                  level_scan_bwd_bf16=level_bound(a16, n_lv3, N3, True, backward=True))
    log(f"[precision] card: {card}")
    log(f"[precision] bf16 kernels vs plain (MIG bs{BATCH}, D={DIM}, N={N3}, {n_lv3} levels): "
        f"struct towers max|d| state/residuals {b16_sfwd:.3e}; struct backward max|d|/scale "
        f"{srep}; level scan max|d| hf/res_e/res_n {b16_fwd:.3e}; level backward max|d|/scale "
        f"{lrep} (bounds: values atol {BF16_ATOL} rtol {BF16_RTOL}, and each output "
        f"{BF16_ULPS} * its scale)")
    for name, (k, pl, runs) in b16_ms.items():
        log(f"[precision] {name}: kernel {runs[0]:.4f}/{runs[1]:.4f} ms, plain {runs[2]:.4f}/"
            f"{runs[3]:.4f} ms (CUDA events); bound {bounds[name]['bound_ms']:.5f} ms by "
            f"{bounds[name]['bound_by']}")

    # (b) bs16 encode and one train step in bf16: card vs CPU, and card bf16 vs card fp32
    b16 = batches[0]
    rows_v = torch.as_tensor(b16["node_valid"])
    enc16 = {}
    for where, c in (("cpu", cfg16), (DEVICE, cfg16), ("fp32", cfg)):
        p_e, _ = dg_ae.init_params(c, seed=SEED, device="cpu" if where == "cpu" else dev)
        with torch.inference_mode():
            hs_e, hf_e, _ = dg_ae.forward(p_e, b16, c)
        enc16[where] = (hs_e.cpu()[rows_v], hf_e.cpu()[rows_v])
    if not all(t.dtype == torch.bfloat16 for t in (*enc16["cpu"], *enc16[DEVICE])):
        raise RuntimeError("[precision] the bf16 forward's hs / hf are not bf16")
    e_cpu = [bf16_close(f"bf16 encode card vs CPU {n}", g, c, BF16_ATOL)
             for n, g, c in zip(("hs", "hf"), enc16[DEVICE], enc16["cpu"])]
    e_f32 = [bf16_close(f"bf16 encode vs fp32 {n}", g, c, BF16_F32_ATOL, same_rounding=False)
             for n, g, c in zip(("hs", "hf"), enc16[DEVICE], enc16["fp32"])]

    def step_grads(c, batch, where, weights):
        """One step's losses and master gradients, fixed draws (phase 7's)."""
        neg, keep = fixed_draws(batch, SEED + 2)
        p1, s1 = dg_ae.init_params(c, seed=SEED + 3, device=where)
        leaves = train_step_mod.param_leaves(p1)
        for t in leaves:
            t.requires_grad_(True)
        with precision_scope(c.matmul_precision):
            total, (_, m1) = train_step_mod.loss_and_metrics(
                p1, s1, batch, None, weights, c, True, neg_edges=tuple(t.to(where) for t in neg),
                drop_keep=[k.to(where) for k in keep])
            total.backward()
        if not all(t.grad is None or t.grad.dtype == torch.float32 for t in leaves):
            raise RuntimeError("[precision] a master gradient is not fp32")
        return ([float(m1[k]) for k in ("recon_loss", "prob_loss", "func_loss", "loss")],
                [torch.zeros(t.shape) if t.grad is None else t.grad.cpu() for t in leaves])

    leaf_ids, leaf_faults = named_leaves(p16), []

    def step_held(tag, got, want, atol, same_rounding=True):
        """The losses within atol + BF16_RTOL |want| and the gradients within
        BF16_GRAD * max(scale, 1) over all leaves; with ``same_rounding``
        each leaf within BF16_LEAF of its own scale floored at GRAD_FLOOR of
        the largest entry (a fault is kept in leaf_faults and raised at the
        end of (c)); the three worst leaves are reported either way."""
        (l_g, g_g), (l_c, g_c) = got, want
        l_err = max(abs(a - c) for a, c in zip(l_g, l_c))
        if not all(abs(a - c) <= atol + BF16_RTOL * abs(c) for a, c in zip(l_g, l_c)):
            raise RuntimeError(f"[precision] {tag}: losses {l_g} vs {l_c}")
        flat = lambda g: torch.cat([x.reshape(-1) for x in g])
        scale, err = flat(g_c).abs().max().item(), (flat(g_g) - flat(g_c)).abs().max().item()
        if not err <= BF16_GRAD * max(scale, 1.0):
            raise RuntimeError(f"[precision] {tag}: gradients max|d| {err} at scale {scale}")
        leaves = sorted(((a - c).abs().max().item() / (BF16_LEAF * max(
            c.abs().max().item(), GRAD_FLOOR * scale)), name, (a - c).abs().max().item(),
                          c.abs().max().item()) for name, a, c in zip(leaf_ids, g_g, g_c,
                                                                      strict=True))[::-1]
        if same_rounding and not leaves[0][0] <= 1.0:
            leaf_faults.append(f"{tag}: gradient leaf {leaves[0][1]} max|d| {leaves[0][2]} at "
                               f"its scale {leaves[0][3]}")
        return (f"losses max|d| {l_err:.3e}, gradients max|d| {err:.3e} at scale {scale:.3e}; "
                f"worst leaves (share of {BF16_LEAF} * max(its scale, {GRAD_FLOOR} * "
                f"{scale:.3e}): name, max|d|, its scale) " + ", ".join(
                    f"{r:.3f} {n} {d:.3e} {sc:.3e}" for r, n, d, sc in leaves[:3]))

    s_card = step_grads(cfg16, b16, DEVICE, WEIGHTS)
    vs_cpu = step_held("bf16 step card vs CPU", s_card, step_grads(cfg16, b16, "cpu", WEIGHTS),
                       BF16_ATOL)
    vs_f32 = step_held("bf16 step vs fp32", s_card, step_grads(cfg, b16, DEVICE, WEIGHTS),
                       BF16_F32_ATOL, same_rounding=False)
    log(f"[precision] bf16 MIG bs{BATCH}: encode card vs CPU max|d| hs/hf {e_cpu[0]:.3e}/"
        f"{e_cpu[1]:.3e}, vs the card's fp32 {e_f32[0]:.3e}/{e_f32[1]:.3e}; one train step "
        f"(weights {WEIGHTS}) card vs CPU: {vs_cpu}; card bf16 vs card fp32: {vs_f32}")

    # (c) bs64 in bf16: one step on the collate_fit and the collate_split
    # layout, card vs CPU, with their launches
    for layout, batch64 in (("fit", collate_fit(graphs)), ("split", collate_split(graphs, GROUPS))):
        var_zero()
        s_card = step_grads(cfg16, batch64, DEVICE, WEIGHTS)
        sync()
        got = var_read()
        units = len(batch64["groups"]) if layout == "split" else batch64["lv_nodes"].shape[0]
        groups = units if layout == "split" else 1
        want = (2 * ROUNDS * groups, SBWD_LAUNCHES * groups, units, 3 * units, groups, 0)
        held64 = step_held(f"bf16 bs64 {layout} card vs CPU", s_card,
                           step_grads(cfg16, batch64, "cpu", WEIGHTS), BF16_ATOL)
        log(f"[precision] bf16 bs{N_CIRCUITS} {layout} ({units} "
            f"{'groups' if layout == 'split' else 'chunks'}): launches {var_names} {got}; card "
            f"vs CPU: {held64}")
        if got != want:
            raise RuntimeError(f"[precision] bf16 bs64 {layout}: launches {got} != {want}")
    if leaf_faults:
        raise RuntimeError(f"[precision] gradient leaves past their bounds: {leaf_faults}")

    clock("[precision] (d)")
    # (d) TF32: the bs16 train step under "default" and under "highest" (and
    # for information the bf16 step), in turns, and the drift of hs, hf and
    # the losses between the two modes
    modes = {m: dataclasses.replace(cfg, matmul_precision=m) for m in ("highest", "default")}
    steps_tf, tf_ms = {}, {m: [] for m in (*modes, "bf16")}
    for m, c in (*modes.items(), ("bf16", cfg16)):
        p_t, s_t = dg_ae.init_params(c, seed=SEED, device=dev)
        ts_t, _ = train_step_mod.make_train_step(c, train_step_mod.make_optimizer(p_t, TRAIN_LR))
        for _ in range(3):
            ts_t(p_t, s_t, b16, gen, WEIGHTS)
        steps_tf[m] = (ts_t, p_t, s_t)
    for m in ("highest", "default", "bf16", "bf16", "default", "highest"):
        ts_t, p_t, s_t = steps_tf[m]
        tf_ms[m].append(median_wall(lambda: ts_t(p_t, s_t, b16, gen, WEIGHTS), 10, sync) * 1e3)
    med = {m: statistics.median(v) for m, v in tf_ms.items()}
    drift = {}
    fwd_t = {}
    for m, c in modes.items():
        p_t, _ = dg_ae.init_params(c, seed=SEED, device=dev)
        with torch.inference_mode():
            fwd_t[m] = dg_ae.forward(p_t, b16, c)[:2]
    for i, name in enumerate(("hs", "hf")):
        a, h = fwd_t["default"][i][rows_v.to(dev)], fwd_t["highest"][i][rows_v.to(dev)]
        drift[name] = ((a - h).abs().max().item(), h.abs().max().item())
    l_def, l_hi = step_grads(modes["default"], b16, DEVICE, WEIGHTS), step_grads(
        modes["highest"], b16, DEVICE, WEIGHTS)
    for name, a, h in zip(("recon", "prob", "func", "loss"), l_def[0], l_hi[0]):
        drift[name] = (abs(a - h), abs(h))
    log(f"[precision] TF32 (MIG bs{BATCH} train step, host batch -> Adam update, synchronised; "
        f"medians of 10 in turns highest/default/bf16/bf16/default/highest): highest "
        f"{[round(x, 3) for x in tf_ms['highest']]} ms, default "
        f"{[round(x, 3) for x in tf_ms['default']]} ms, bf16 (highest) "
        f"{[round(x, 3) for x in tf_ms['bf16']]} ms; highest / default = "
        f"{med['highest'] / med['default']:.4f}, bf16 / highest = "
        f"{med['bf16'] / med['highest']:.4f}; drift default vs "
        f"highest, max|d| / scale: " + ", ".join(f"{k} {d:.3e}/{sc:.3e}"
                                                for k, (d, sc) in drift.items()))
    if not all(d <= TF32_DRIFT * max(sc, 1.0) for d, sc in drift.values()):
        raise RuntimeError(f"[precision] TF32 drifts past {TF32_DRIFT} * max(scale, 1): {drift}")
    # for information: where the bf16 step's extra time goes, against the
    # fp32 step ("highest"): the conversions (the master params cast to bf16
    # and their gradients back, the wrappers' fp32 weight copies) beside the
    # rest
    clock("[precision] (d) the bf16 step's casts")
    casts = []
    for m in ("highest", "bf16"):
        ts_t, p_t, s_t = steps_tf[m]
        c = step_casts(torch, lambda: ts_t(p_t, s_t, b16, gen, WEIGHTS))
        casts.append(f"{m} " + ", ".join(f"{k} {v:.3f}" for k, v in c.items()))
    log(f"[precision] bf16 step vs fp32 (highest) under torch.profiler (5 steps a run; "
        f"per step: wall, device time, kernels, aten::_to_copy calls and host ms, copy "
        f"kernels' device ms): " + "; ".join(casts))
    ts_t, p_t, s_t = steps_tf["bf16"]
    profile_train(torch, lambda: ts_t(p_t, s_t, b16, gen, WEIGHTS), card,
                  f"bf16 MIG bs{BATCH} train step", steps=5, rows=15, warm=0)

    log(f"[precision] phase (a)-(d): {time.perf_counter() - t_precision:.1f} s; (e), bf16 on "
        f"the step and giant routes, follows phase 17 on their batches")

    clock("phase 10")
    # ---- 10. step kernels vs plain, per modality, bs64 in two chunks -------
    step_names = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak", "d_hf")
    step_err = step_bwd_err = route_err = route_bwd_err = 0.0
    for i, mod in enumerate(MODALITIES):
        cfg_m = dg_ae.DGConfig(modality=mod, dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                               layernorm=True, matmul_precision="highest")
        params_m, _ = dg_ae.init_params(cfg_m, seed=SEED, device=dev)
        batch = collate_chunked(dataset(random_circuit, mod, 200 + i, N_CIRCUITS), CHUNKS)
        b = dg_ae.batch_to_device(batch, dev)
        counts = dg_ae.level_counts(batch)
        with torch.no_grad():
            hs = dg_ae.struct_hs(params_m, b, cfg_m)
            args = dg_ae.level_scan_inputs(params_m, b, cfg_m, hs)
            n_sub, L = hs.shape[0] // CHUNKS, args[0].shape[0] // CHUNKS
            hf = dg_ae.level_scan_step(args, counts, n_sub)      # the route's serving launch
            g = torch.randn((args[4].shape[1], DIM), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 7))
            fwd_w, bwd_w, bwd_rep = [0.0, 0.0, 0.0], 0.0, ""
            # the single-level kernels, level by level on the route's hf
            for k in range(CHUNKS):
                hf_c = hf.narrow(0, k * n_sub, n_sub)
                for lv in range(counts[k]):
                    row = k * L + lv
                    sa = (hf_c, *(args[j][row] for j in (0, 1, 2, 3, 5, 6)), *args[7:])
                    out_k = level_kernel._step_forward_cuda(sa, residuals=True)
                    out_k = (out_k[0], *written_rows(sa[3], sa[4], sa[5], 1, out_k[1], out_k[2]))
                    out_r = level_kernel.level_step_reference(*sa, with_residuals=True)
                    for j, (x, r) in enumerate(zip(out_k, out_r)):
                        if not torch.isfinite(x).all():
                            raise RuntimeError(f"[step] {mod}: non-finite output, level {lv}")
                        fwd_w[j] = max(fwd_w[j], (x - r).abs().max().item())
                    grads_k = level_kernel._step_backward_cuda(g, out_k[1], out_k[2], sa[1:], n_sub)
                    grads_r = level_kernel.level_step_bwd_reference(
                        g, out_k[1], out_k[2], *sa[1:9], sa[10], sa[11], num_nodes=n_sub)
                    report, worst = held(mod, step_names, grads_k, grads_r)
                    if worst >= bwd_w:
                        bwd_w, bwd_rep = worst, report
            # the whole route, forward with residuals and backward (K level
            # indices a block, step_chunk_levels), twice, against the plain route
            prep = level_kernel._prepared(args, backward=True)
            runs = [level_kernel._step_route_forward_cuda(args, counts, n_sub, True, *prep)
                    for _ in range(2)]
            hf_k, re_k, rn_k = runs[0]
            written = [written_rows(args[2], args[3], args[5], 2 * L, r[1], r[2]) for r in runs]
            out_r = level_kernel.level_scan_step_reference(*args, counts, n_sub,
                                                           with_residuals=True)
            hf_loop = dg_ae.level_step_loop(args, counts, n_sub)
            ghf = torch.randn(hf_k.shape, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(SEED + 8))
            K = min(level_kernel.step_chunk_levels(args[0].shape[1], args[4].shape[1], DIM, L,
                                                   CHUNKS, hs.shape[0], cfg_m.num_experts),
                    max(counts))
            graw = [level_kernel._step_route_backward_cuda(ghf, re_k, rn_k, args, counts, n_sub,
                                                           *prep) for _ in range(2)]
            grads_r = level_kernel.level_scan_step_bwd_reference(
                ghf, *written[0], *args[:9], args[10], args[11], counts, n_sub, chunk_levels=K)
        sync()
        route_w = [(x - r).abs().max().item()
                   for x, r in zip((hf_k, *written[0]), out_r)]
        route_rep, route_worst = held(mod, step_names[:6], graw[0], grads_r)
        same = (torch.equal(runs[0][0], runs[1][0]) and torch.equal(written[0][0], written[1][0])
                and torch.equal(written[0][1], written[1][1])
                and all(torch.equal(a, c) for a, c in zip(*graw)))
        unwalked_zero = all((graw[0][0].view(CHUNKS, L, -1)[k, n:] == 0).all()
                            for k, n in enumerate(counts))
        n_rows = sum(counts)
        log(f"[step] {mod}: {N_CIRCUITS} circuits in {CHUNKS} chunks, N_sub={n_sub} L={L} "
            f"real levels {counts} Np={args[4].shape[1]} Ep={args[0].shape[1]}; over {n_rows} "
            f"levels: step forward max|d| h_new/res_e/res_n = {fwd_w[0]:.3e}/{fwd_w[1]:.3e}/"
            f"{fwd_w[2]:.3e}; step backward, worst level, max|d|/scale: {bwd_rep}")
        log(f"[step] {mod}: the route (one launch per level index for both chunks, K = {K} "
            f"level indices a backward block) against the plain route: forward max|d| "
            f"hf/res_e/res_n = {route_w[0]:.3e}/{route_w[1]:.3e}/{route_w[2]:.3e}; backward "
            f"max|d|/scale: {route_rep}; two runs bit for bit the same: {same}; hf equal to "
            f"its serving launch's and to the per-row loop's (single-level kernels) bit for "
            f"bit: {torch.equal(hf_k, hf)}/{torch.equal(hf_k, hf_loop)}")
        if not max(fwd_w) <= KERNEL_TOL:
            raise RuntimeError(f"[step] {mod}: step kernel disagrees with plain version: "
                               f"{fwd_w} (tol {KERNEL_TOL})")
        if not (max(route_w) <= KERNEL_TOL and same and unwalked_zero and torch.equal(hf_k, hf)
                and torch.equal(hf_k, hf_loop)):
            raise RuntimeError(f"[step] {mod}: the route disagrees with its plain version "
                               f"({route_w}, tol {KERNEL_TOL}), is not repeatable ({same}), "
                               f"wrote d_pack rows it does not walk ({not unwalked_zero}) or "
                               f"differs from its serving launch or the per-row loop")
        step_err, step_bwd_err = max(step_err, *fwd_w), max(step_bwd_err, bwd_w)
        route_err, route_bwd_err = max(route_err, *route_w), max(route_bwd_err, route_worst)

    clock("phase 11")
    # ---- 11. bs64 encode: Model.forward(list) through collate_fit ----------
    cfg = model.cfg
    level_mods = (level_kernel, struct_kernel)

    def zero_counts():
        for m in level_mods:
            m.launches = m.bwd_launches = 0
        level_kernel.step_launches = level_kernel.step_bwd_launches = 0
        level_kernel.giant_launches = level_kernel.giant_bwd_launches = 0
        level_kernel.levels_walked = level_kernel.bwd_levels_walked = 0

    COUNT_NAMES = ("(struct, struct bwd, level, level bwd, step, step bwd, giant, giant bwd, "
                   "levels walked by level, by level bwd)")

    def read_counts():
        """The launch counts in COUNT_NAMES' order."""
        return (struct_kernel.launches, struct_kernel.bwd_launches, level_kernel.launches,
                level_kernel.bwd_launches, level_kernel.step_launches,
                level_kernel.step_bwd_launches, level_kernel.giant_launches,
                level_kernel.giant_bwd_launches, level_kernel.levels_walked,
                level_kernel.bwd_levels_walked)

    fit = collate_fit(graphs)
    C_fit = fit["lv_nodes"].shape[0] if fit["lv_nodes"].ndim == 3 else 1
    fit_levels = dg_ae.level_counts(fit)
    zero_counts()
    hs_g, hf_g = model(graphs)
    sync()
    got = read_counts()
    log(f"[encode64] Model.forward(list of {len(graphs)}): collate_fit gives C={C_fit}, per chunk "
        f"N_sub={fit['gate'].shape[0] // C_fit} L={fit['lv_nodes'].shape[-2]} "
        f"Ep={fit['lv_edge_src'].shape[-1]} Np={fit['lv_nodes'].shape[-1]}, real levels "
        f"{fit_levels}; launches {COUNT_NAMES} = {got}")
    if got != (2 * ROUNDS, 0, C_fit, 0, 0, 0, 0, 0, sum(fit_levels), 0) or C_fit < 2:
        raise RuntimeError(f"[encode64] launches {got} != (2 * s_rounds, 0, one per chunk, 0, "
                           f"..., real (chunk, level) rows {sum(fit_levels)} walked, 0), or the "
                           f"list was not chunked")
    hs_c, hf_c = cpu_model(graphs)
    total_nodes = sum(g.num_nodes for g in graphs)
    d_hs, d_hf = (hs_g.cpu() - hs_c).abs().max().item(), (hf_g.cpu() - hf_c).abs().max().item()
    log(f"[encode64] card vs CPU (the plain versions), {total_nodes} rows in input order: "
        f"max|dhs|={d_hs:.3e} max|dhf|={d_hf:.3e} (tol {CPU_TOL})")
    if hs_g.shape != (total_nodes, DIM) or not (d_hs <= CPU_TOL and d_hf <= CPU_TOL):
        raise RuntimeError("[encode64] card and CPU disagree")

    clock("phase 12 and 13")
    # ---- 12 and 13. bs64 train steps: the step route, and a split batch ----
    def train_large(tag, batch, want, steps=LARGE_STEPS, lr=LARGE_LR, weights=WEIGHTS,
                    prob_check=True):
        """``steps`` train steps from fresh params with fixed draws; the
        per-step launch counts must equal ``want`` (COUNT_NAMES' order) and,
        over more than one step, the loss must fall; then one step card vs
        CPU without the prob loss and, with ``prob_check``, the prob loss
        alone. Returns the counts' sums."""
        p2, s2 = dg_ae.init_params(cfg, seed=SEED, device=dev)
        step2, _ = train_step_mod.make_train_step(cfg, train_step_mod.make_optimizer(p2, lr))
        neg, keep = fixed_draws(batch, SEED + 8)
        neg, keep = tuple(t.to(dev) for t in neg), [k.to(dev) for k in keep]
        rows, totals = [], [0] * len(want)
        for _ in range(steps):
            zero_counts()
            s2, met = step2(p2, s2, batch, None, weights, neg_edges=neg, drop_keep=keep)
            got = read_counts()
            if got != want:
                raise RuntimeError(f"[{tag}] per-step launches {COUNT_NAMES} {got} != {want}")
            totals = [a + z for a, z in zip(totals, got)]
            rows.append(torch.stack([met[k] for k in keys]))
        sync()
        rows = torch.stack(rows).cpu()
        losses = rows[:, keys.index("loss")].tolist()
        log(f"[{tag}] {steps} train_steps, lr {lr}, weights {weights}, fixed draws: "
            f"per-step launches {COUNT_NAMES} = {want}; loss {[round(x, 6) for x in losses]}")
        if not torch.isfinite(rows).all():
            raise RuntimeError(f"[{tag}] non-finite loss or metric")
        if steps > 1 and not losses[-1] < losses[0]:
            raise RuntimeError(f"[{tag}] the loss did not fall: {losses}")
        clock(f"[{tag}] card vs CPU")
        card_vs_cpu_step(tag, batch, SMOOTH_WEIGHTS)
        if prob_check:
            clock(f"[{tag}] card vs CPU, the prob loss")
            card_vs_cpu_prob(tag, batch)
        return totals

    chunked = collate_chunked(graphs, CHUNKS)
    ch_levels = dg_ae.level_counts(chunked)
    n_sub = chunked["gate"].shape[0] // CHUNKS
    ep, np_ = chunked["lv_edge_src"].shape[2], chunked["lv_nodes"].shape[2]
    failed = [name for name, v, lim in (
        ("N_sub", n_sub, level_kernel.KERNEL_MAX_NODES), ("Ep", ep, level_kernel.KERNEL_MAX_EP),
        ("Np", np_, level_kernel.KERNEL_MAX_NP)) if v > lim]
    log(f"[step64] collate_chunked(graphs, {CHUNKS}): N_sub={n_sub} Ep={ep} Np={np_}, real "
        f"levels {ch_levels}; kernel_fits fails on {failed}, step_kernel_fits "
        f"{dg_ae.step_kernel_fits(n_sub, ep, np_, DIM)}")
    if not failed:
        raise RuntimeError("[step64] the chunks pass kernel_fits: the step route is not taken")
    zero_counts()
    with torch.inference_mode():
        _, hf_s, _ = dg_ae.forward(model.params, chunked, cfg)
    sync()
    got = read_counts()
    inv = torch.as_tensor(chunked["node_inv"]).long()
    d_hf = (hf_s[inv.to(dev)][:total_nodes] - hf_g).abs().max().item()
    log(f"[step64] forward: launches {got}; max|dhf| against the bs64 encode (fused route, "
        f"C={C_fit}) = {d_hf:.3e}")
    if got != (2 * ROUNDS, 0, 0, 0, max(ch_levels), 0, 0, 0, 0, 0) or not d_hf <= KERNEL_TOL:
        raise RuntimeError(f"[step64] forward: launches {got} != step launches "
                           f"{max(ch_levels)} (one per level index) alone, or the routes "
                           f"disagree ({d_hf})")
    L64 = chunked["lv_nodes"].shape[1]
    step_K = min(level_kernel.step_chunk_levels(ep, np_, DIM, L64, CHUNKS, CHUNKS * n_sub,
                                                cfg.num_experts), max(ch_levels))
    step_fwd_want = max(ch_levels)
    step_bwd_want = level_kernel.step_route_launch_count(ch_levels, step_K)
    log(f"[step64] per pass the route launches {step_fwd_want} forward (one per level index) "
        f"and {step_bwd_want} backward (K = {step_K} level indices a block: "
        f"step_route_launch_count), against {sum(ch_levels)} and {3 * sum(ch_levels)} by a call "
        f"per (chunk, level)")
    step_totals = train_large(
        "step64", chunked, (2 * ROUNDS, SBWD_LAUNCHES, 0, 0, step_fwd_want, step_bwd_want, 0, 0,
                            0, 0))

    # the level recurrence alone on the step route: forward and backward
    # through its autograd Function, and by the per-row loop of single-level
    # calls (the route's earlier structure), peak above what is held before
    b = dg_ae.batch_to_device(chunked, dev)
    with torch.no_grad():
        hs = dg_ae.struct_hs(model.params, b, cfg)
        step_args = [a.detach().clone()
                     for a in dg_ae.level_scan_inputs(model.params, b, cfg, hs)]
    route_ghf = torch.randn(hs.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 10))

    def route_alone_peak(route):
        t = [a.clone().requires_grad_(i in level_kernel.FLOAT_ARGS)
             for i, a in enumerate(step_args)]
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hf = route(tuple(t), ch_levels, n_sub, *dg_ae.kernel_inputs(tuple(t)))
        torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], route_ghf)
        sync()
        return torch.cuda.max_memory_allocated() - base

    peak_route = route_alone_peak(dg_ae.level_scan_step)
    peak_loop = route_alone_peak(dg_ae.level_step_loop)
    # the stacked residuals, hf, ghf's working copy and d_pack_lv
    rows64 = step_args[0].shape[0]
    route_law = (4 * rows64 * (ep * (3 * DIM + 1) + np_ * 4 * DIM) + 2 * hs.numel() * 4
                 + nbytes(step_args[0]))
    log(f"[step64] level recurrence alone (forward and backward), peak above what is held "
        f"before: the route {peak_route / 2**20:.2f} MiB, the per-row loop of single-level "
        f"calls {peak_loop / 2**20:.2f} MiB; stacked residuals + hf + ghf's copy + d_pack_lv = "
        f"{route_law / 2**20:.2f} MiB (the route's ratio {peak_route / route_law:.3f}, limit "
        f"1.25); {card}")
    if not peak_route <= 1.25 * route_law:
        raise RuntimeError("[step64] the route's working memory passes 1.25 x what it holds")

    split = collate_split(graphs, GROUPS)
    sp_levels = [c[0] for c in dg_ae.level_counts(split)]
    dims = [(g["gate"].shape[0], g["lv_nodes"].shape[0], g["lv_edge_src"].shape[1],
             g["lv_nodes"].shape[1]) for g in split["groups"]]
    log(f"[split64] collate_split(graphs, {GROUPS}): per group (N, L, Ep, Np) = {dims}, real "
        f"levels {sp_levels}")
    train_large("split64", split, (
        2 * ROUNDS * GROUPS, SBWD_LAUNCHES * GROUPS, GROUPS, 3 * GROUPS, 0, 0, 0, 0,
        sum(sp_levels), sum(sp_levels)), prob_check=False)

    clock("phase 14")
    # ---- 14. timing (informational) ----------------------------------------
    args = step_args
    with torch.no_grad():
        hf = dg_ae.level_scan_step(args, ch_levels, n_sub)
    L = args[0].shape[0] // CHUNKS
    wide = max(range(ch_levels[0]), key=lambda lv: int(args[3][lv].sum()))   # chunk 0's widest
    sa = [hf[:n_sub].clone(), *(args[j][wide].clone() for j in (0, 1, 2, 3, 5, 6)), *args[7:]]
    reps = 50
    with torch.no_grad():
        # as on the route: the lists and the weights' copies are built once per batch
        prep = level_kernel._prepared(sa[1:], backward=True)
        kern = lambda: level_kernel._step_forward_cuda(sa, False, *prep)
        rkern = lambda: level_kernel._step_forward_cuda(sa, True, *prep)
        plain = lambda: level_kernel.level_step_reference(*sa)
        rplain = lambda: level_kernel.level_step_reference(*sa, with_residuals=True)
        for f in (kern, rkern, plain, rplain):
            for _ in range(3):
                f()
        st_p1, st_k1 = event_ms(torch, plain, reps), event_ms(torch, kern, reps)
        st_k2, st_p2 = event_ms(torch, kern, reps), event_ms(torch, plain, reps)
        sr_p1, sr_k1 = event_ms(torch, rplain, reps), event_ms(torch, rkern, reps)
        sr_k2, sr_p2 = event_ms(torch, rkern, reps), event_ms(torch, rplain, reps)
        _, re_k, rn_k = rkern()
    g = torch.randn((sa[5].shape[0], DIM), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 9))
    for j in level_kernel.STEP_FLOAT_ARGS:
        sa[j].requires_grad_(True)
    h_plain = level_kernel.level_step_reference(*sa)
    diff = [sa[j] for j in level_kernel.STEP_FLOAT_ARGS]
    bkern = lambda: level_kernel._step_backward_cuda(g, re_k, rn_k, sa[1:], n_sub, *prep)
    bplain = lambda: torch.autograd.grad(h_plain, diff, g, retain_graph=True)
    for _ in range(3):
        bkern()
        bplain()
    sb_p1, sb_k1 = event_ms(torch, bplain, reps), event_ms(torch, bkern, reps)
    sb_k2, sb_p2 = event_ms(torch, bkern, reps), event_ms(torch, bplain, reps)
    log(f"[time] card: {card}")
    log(f"[time] level step alone, level {wide} of chunk 0 ({int(sa[4].sum())} edges, "
        f"{int(sa[5].sum())} slots of Ep={sa[1].shape[0]} Np={sa[5].shape[0]}, N_sub={n_sub}), "
        f"CUDA events over {reps} calls: kernel {st_k1:.4f}/{st_k2:.4f} ms, plain "
        f"{st_p1:.4f}/{st_p2:.4f} ms; with residuals: kernel {sr_k1:.4f}/{sr_k2:.4f} ms, plain "
        f"{sr_p1:.4f}/{sr_p2:.4f} ms; bound {step_bound(sa, True)['bound_ms']:.5f} ms")
    log(f"[time] level step backward alone, the same level: kernel {sb_k1:.4f}/{sb_k2:.4f} ms, "
        f"autograd through the plain version {sb_p1:.4f}/{sb_p2:.4f} ms; bound "
        f"{step_bound(sa, True, True)['bound_ms']:.5f} ms")
    # the route's passes on the whole two-chunk batch, lists and weight copies
    # built before (as level_recurrence hands them over), kernel vs plain in turns
    with torch.no_grad():
        prep = level_kernel._prepared(args, backward=True)
        rfwd = lambda: level_kernel._step_route_forward_cuda(args, ch_levels, n_sub, True, *prep)
        rplain = lambda: level_kernel.level_scan_step_reference(*args, ch_levels, n_sub,
                                                                with_residuals=True)
        _, re_r, rn_r = rfwd()
        rbwd = lambda: level_kernel._step_route_backward_cuda(route_ghf, re_r, rn_r, args,
                                                              ch_levels, n_sub, *prep)
        rbplain = lambda: level_kernel.level_scan_step_bwd_reference(
            route_ghf, re_r, rn_r, *args[:9], args[10], args[11], ch_levels, n_sub,
            chunk_levels=step_K)
        for f in (rfwd, rplain, rbwd, rbplain):
            f()
        rr, pr = 20, 2
        rf_p1, rf_k1 = event_ms(torch, rplain, pr), event_ms(torch, rfwd, rr)
        rf_k2, rf_p2 = event_ms(torch, rfwd, rr), event_ms(torch, rplain, pr)
        rb_p1, rb_k1 = event_ms(torch, rbplain, pr), event_ms(torch, rbwd, rr)
        rb_k2, rb_p2 = event_ms(torch, rbwd, rr), event_ms(torch, rbplain, pr)
    sr_k, sr_p = (rf_k1 + rf_k2) / 2, (rf_p1 + rf_p2) / 2
    sb_k, sb_p = (rb_k1 + rb_k2) / 2, (rb_p1 + rb_p2) / 2
    # each input read once and each output written once over the real rows;
    # the operations of every real (chunk, level) row
    real = [k * L + lv for k, n in enumerate(ch_levels) for lv in range(n)]
    real_args = [a[real] for a in args[:7]] + list(args[7:])
    bounds.update(level_step=level_bound(real_args, len(real), hs.shape[0], True),
                  level_step_bwd=level_bound(real_args, len(real), hs.shape[0], True, True))
    per_level = [step_bound((hf.narrow(0, (r // L) * n_sub, n_sub),
                             *(args[j][r] for j in (0, 1, 2, 3, 5, 6)), *args[7:]), True, bwd)
                 for bwd in (False, True) for r in real]
    half = len(real)
    log(f"[time] the route on the two-chunk batch ({len(real)} real (chunk, level) rows, "
        f"{step_fwd_want} forward launches, {step_bwd_want} backward, K = {step_K}), CUDA "
        f"events over {rr} calls (plain: {pr}): forward with residuals {rf_k1:.4f}/{rf_k2:.4f} "
        f"ms, plain {rf_p1:.4f}/{rf_p2:.4f} ms; backward {rb_k1:.4f}/{rb_k2:.4f} ms, plain "
        f"{rb_p1:.4f}/{rb_p2:.4f} ms; bounds (each input read once) "
        f"{bounds['level_step']['bound_ms']:.5f} / {bounds['level_step_bwd']['bound_ms']:.5f} "
        f"ms; the per-level step bounds summed "
        f"{sum(x['bound_ms'] for x in per_level[:half]):.5f} / "
        f"{sum(x['bound_ms'] for x in per_level[half:]):.5f} ms")
    layouts = {f"fit C={C_fit} (fused)": fit, f"chunked C={CHUNKS} (step)": chunked,
               f"split G={GROUPS} (fused)": split}
    p3, s3 = dg_ae.init_params(cfg, seed=SEED, device=dev)
    step3, _ = train_step_mod.make_train_step(cfg, train_step_mod.make_optimizer(p3, TRAIN_LR))
    wall = {name: [] for name in layouts}
    for name, bt in layouts.items():
        for _ in range(2):  # warm-up
            step3(p3, s3, bt, gen, WEIGHTS)
    for order in (list(layouts), list(layouts)[::-1]):
        for name in order:
            wall[name].append(median_wall(
                lambda: step3(p3, s3, layouts[name], gen, WEIGHTS), 10, sync))
    log(f"[time] MIG bs{N_CIRCUITS} train step (host batch -> Adam update, synchronised), median "
        f"of 10, two turns: " + "; ".join(
            f"{name} {w[0] * 1e3:.3f}/{w[1] * 1e3:.3f} ms" for name, w in wall.items()))

    clock("phase 15")
    # ---- 15. giant kernels vs plain, per modality ---------------------------
    giant_names = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak")
    giant_err = giant_bwd_err = 0.0
    t0 = time.perf_counter()
    giant_graph = layered_circuit(np.random.default_rng(0), "mig", width=GIANT_WIDTH,
                                  depth=GIANT_DEPTH, num_tt_pairs=512)
    t1 = time.perf_counter()
    giant_batch = collate([giant_graph])
    log(f"[giant] layered MIG circuit width {GIANT_WIDTH} x depth {GIANT_DEPTH}: "
        f"{giant_graph.num_nodes} nodes, {giant_graph.num_edges} edges, "
        f"{giant_graph.num_levels} levels; generated in {t1 - t0:.2f} s, collated in "
        f"{time.perf_counter() - t1:.2f} s (host)")
    giant_args = None     # the MIG circuit's scan arguments, for phase 18
    for i, mod in enumerate(MODALITIES):
        cfg_m = dg_ae.DGConfig(modality=mod, dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                               layernorm=True, matmul_precision="highest")
        params_m, _ = dg_ae.init_params(cfg_m, seed=SEED, device=dev)
        batch = giant_batch if mod == "mig" else collate([layered_circuit(
            np.random.default_rng(300 + i), mod, width=GIANT_WIDTH, depth=GIANT_SMALL_DEPTH,
            num_tt_pairs=64)])
        b = dg_ae.batch_to_device(batch, dev)
        n_lv = dg_ae.num_levels(batch)
        with torch.no_grad():
            hs = dg_ae.struct_hs(params_m, b, cfg_m)
            args = tuple(a.detach().clone()
                         for a in dg_ae.level_scan_inputs(params_m, b, cfg_m, hs))
        N, (L, ep, _), np_ = hs.shape[0], args[0].shape, args[4].shape[1]
        if level_kernel.kernel_fits(N, ep, np_, DIM):
            raise RuntimeError(f"[giant] {mod}: the batch passes kernel_fits and would not take "
                               f"the giant route")
        k_lv = min(level_kernel.giant_chunk_levels(ep, np_, DIM, L, N, cfg_m.num_experts), n_lv)
        bwd_count = level_kernel.giant_bwd_launch_count(n_lv, k_lv)
        zero_counts()
        hf_k = level_kernel._giant_forward_cuda(args, N, n_lv)
        ghf = torch.randn(hf_k.shape, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED + 10))
        grads_k = level_kernel._giant_backward_cuda(ghf, hf_k, args, n_lv)
        sync()
        got = read_counts()
        if got != (0, 0, 0, 0, 0, 0, 1, bwd_count, 0, 0):
            raise RuntimeError(f"[giant] {mod}: launches {COUNT_NAMES} {got} != giant 1 forward "
                               f"and {bwd_count} backward ({n_lv} levels in chunks of {k_lv}) "
                               f"alone")
        repeat = (torch.equal(level_kernel._giant_forward_cuda(args, N, n_lv), hf_k)
                  and all(torch.equal(a, c) for a, c in zip(
                      level_kernel._giant_backward_cuda(ghf, hf_k, args, n_lv), grads_k)))
        hf_r = level_kernel.level_scan_giant_reference(*args, num_nodes=N, num_levels=n_lv)
        grads_r = level_kernel.level_scan_giant_bwd_reference(ghf, hf_k, *args, num_levels=n_lv,
                                                              chunk_levels=k_lv)
        # the fused kernels on the same inputs: residuals saved against recomputed
        hf_1, re_1, rn_1 = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
        grads_2 = level_kernel._backward_cuda(ghf, re_1, rn_1, args, n_lv)
        sync()
        if not (torch.isfinite(hf_k).all() and torch.isfinite(hf_r).all()):
            raise RuntimeError(f"[giant] {mod}: non-finite hf")
        valid = torch.as_tensor(batch["node_valid"], device=dev)
        err = (hf_k - hf_r)[valid].abs().max().item()
        pad = hf_k[~valid].abs().max().item()
        same_fused = torch.equal(hf_k, hf_1)
        pad_levels = grads_k[0][n_lv:].abs().max().item() if n_lv < L else 0.0
        report, worst = held(mod, giant_names, grads_k, grads_r)
        d_saved = max((k - f).abs().max().item() / max(f.abs().max().item(), 1.0)
                      for k, f in zip(grads_k, grads_2))
        log(f"[giant] {mod}: N={N} n={int(batch['n_nodes'])} E={batch['edge_src'].shape[0]} L={L} "
            f"real_levels={n_lv} Np={np_} Ep={ep} T={cfg_m.num_experts}: giant forward "
            f"max|dhf| valid rows={err:.3e}, padding rows {pad:.3e}, equal to the fused kernel's "
            f"hf: {same_fused}; giant backward in chunks of {k_lv} levels ({bwd_count} "
            f"launches), against the plain version in that order, max|d|/scale: {report}; "
            f"d_pack of padding levels {pad_levels:.3e}; against the fused backward from saved "
            f"residuals, worst output {d_saved:.3e} of max(scale, 1); both giant kernels "
            f"repeatable bit for bit: {repeat}")
        if not (err <= KERNEL_TOL and same_fused and repeat) or pad != 0.0 or pad_levels != 0.0:
            raise RuntimeError(f"[giant] {mod}: the giant forward disagrees with its plain "
                               f"version or the fused kernel, wrote a padding row, or a giant "
                               f"kernel did not repeat bit for bit")
        if not d_saved <= RECOMPUTE_TOL:
            raise RuntimeError(f"[giant] {mod}: the giant backward disagrees with the fused "
                               f"backward: {d_saved} of scale (tol {RECOMPUTE_TOL})")
        giant_err, giant_bwd_err = max(giant_err, err), max(giant_bwd_err, worst)
        if mod == "mig":
            giant_args, giant_ghf = args, ghf
        del hf_1, re_1, rn_1, grads_2, grads_r, grads_k

    clock("phase 16")
    # ---- 16. giant encode: Model.forward(g) ----------------------------------
    giant_levels = dg_ae.num_levels(giant_batch)
    zero_counts()
    hs_gi, hf_gi = model(giant_graph)
    sync()
    got = read_counts()
    log(f"[giant-encode] Model.forward(g), {giant_graph.num_nodes} nodes: launches "
        f"{COUNT_NAMES} = {got}, real levels {giant_levels}")
    if got != (2 * ROUNDS, 0, 0, 0, 0, 0, 1, 0, 0, 0):
        raise RuntimeError(f"[giant-encode] launches {got} != struct {2 * ROUNDS} and one giant "
                           f"launch alone")
    want = (giant_graph.num_nodes, DIM)
    if hs_gi.shape != want or hf_gi.shape != want or not (
            torch.isfinite(hs_gi).all() and torch.isfinite(hf_gi).all()):
        raise RuntimeError(f"[giant-encode] shapes {tuple(hs_gi.shape)} {tuple(hf_gi.shape)}, "
                           f"want {want}, or non-finite rows")
    hs_c, hf_c = cpu_model(giant_graph)
    d_hs, d_hf = (hs_gi.cpu() - hs_c).abs().max().item(), (hf_gi.cpu() - hf_c).abs().max().item()
    nz = int((hf_gi.abs() > 0).any(dim=1).sum())
    log(f"[giant-encode] card vs CPU (the plain versions): max|dhs|={d_hs:.3e} "
        f"max|dhf|={d_hf:.3e} (tol {CPU_TOL}); rows with nonzero hf: {nz}")
    if not (d_hs <= CPU_TOL and d_hf <= CPU_TOL):
        raise RuntimeError("[giant-encode] card and CPU disagree")
    del hs_c, hf_c

    clock("phase 17")
    # ---- 17. giant training ----------------------------------------------------
    def giant_bwd_count(batch):
        """The giant backward's launches per call on a host batch: its real
        levels in chunks of the K its shapes give."""
        n_lv, (L, ep) = dg_ae.num_levels(batch), batch["lv_edge_src"].shape
        k_lv = level_kernel.giant_chunk_levels(ep, batch["lv_nodes"].shape[-1], DIM, L,
                                               batch["gate"].shape[0], cfg.num_experts)
        return level_kernel.giant_bwd_launch_count(n_lv, min(k_lv, n_lv))

    giant_want = (2 * ROUNDS, SBWD_LAUNCHES, 0, 0, 0, 0, 1, giant_bwd_count(giant_batch), 0, 0)
    giant_totals = train_large("giant-train", giant_batch, giant_want, steps=GIANT_STEPS,
                               lr=GIANT_LR, weights=GIANT_WEIGHTS)

    clock("[giant-train] one step by route, peaks")

    def one_giant_step(tag, remat=None, force_fused=False):
        """Forward, losses and backward of the giant batch from fresh params
        with fixed draws: the gradients, the launch counts and the peak
        device memory, in all and above what was allocated before."""
        cfg_x = dataclasses.replace(cfg, remat_struct=remat)
        p4, s4 = dg_ae.init_params(cfg_x, seed=SEED, device=dev)
        leaves = train_step_mod.param_leaves(p4)
        for t in leaves:
            t.requires_grad_(True)
        neg, keep = fixed_draws(giant_batch, SEED + 11)
        neg, keep = tuple(t.to(dev) for t in neg), [k.to(dev) for k in keep]
        fits = dg_ae.kernel_fits
        if force_fused:   # the route of kernels 1 and 2, whatever the size
            dg_ae.kernel_fits = lambda *a: True
        try:
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            total, _ = train_step_mod.loss_and_metrics(
                p4, s4, giant_batch, None, GIANT_WEIGHTS, cfg_x, True, neg_edges=neg,
                drop_keep=keep)
            total.backward()
            sync()
        finally:
            dg_ae.kernel_fits = fits
        peak, got = torch.cuda.max_memory_allocated(), read_counts()
        log(f"[giant-train] one step, {tag}: launches {COUNT_NAMES} = {got}; peak device memory "
            f"{peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} "
            f"GiB held before the step")
        return [None if t.grad is None else t.grad for t in leaves], got, peak - base, peak

    peak_total = {}
    g_plain, got_plain, peak_giant, peak_total["giant"] = one_giant_step(
        "giant route, remat_struct=False", remat=False)
    g_remat, got_remat, peak_remat, peak_total["remat"] = one_giant_step(
        "giant route, remat_struct=True", remat=True)
    _, got_fused, peak_fused, _ = one_giant_step("forced to the fused kernels (1 and 2)",
                                                 force_fused=True)
    if got_plain != giant_want or got_remat != (4 * ROUNDS, *giant_want[1:]):
        raise RuntimeError(f"[giant-train] launches {got_plain} / with remat {got_remat}: want "
                           f"{giant_want} and the struct forward doubled")
    if got_fused != (2 * ROUNDS, SBWD_LAUNCHES, 1, 3, 0, 0, 0, 0, giant_levels, giant_levels):
        raise RuntimeError(f"[giant-train] forced fused route: launches {got_fused}")
    d_remat = max(0.0 if a is None else (a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
                  for a, c in zip(g_remat, g_plain))
    log(f"[giant-train] remat_struct=True against False: worst gradient leaf differs by "
        f"{d_remat:.3e} of its scale; peak above baseline: giant {peak_giant / 2**30:.3f} GiB, "
        f"giant with remat {peak_remat / 2**30:.3f} GiB, fused kernels {peak_fused / 2**30:.3f} "
        f"GiB")
    if not d_remat <= 1e-6:
        raise RuntimeError(f"[giant-train] remat changes the gradients: {d_remat}")
    del g_plain, g_remat
    # the struct backward's scratch (one half-round's, whatever the rounds) and its outputs
    n_g = giant_batch["gate"].shape[0]
    scratch = {k: math.prod(s) for k, s in struct_kernel.bwd_scratch_shapes(n_g, DIM).items()}
    scratch.update({"cotangent copy": 2 * n_g * DIM, "weights transposed": 8 * DIM * 3 * DIM,
                    "dxi (output)": 4 * n_g * 3 * DIM})
    log(f"[giant-train] struct backward at N={n_g}: " + ", ".join(
        f"{k} {v * 4 / 2**20:.1f} MiB" for k, v in scratch.items()) + f"; residuals (input) "
        f"{2 * ROUNDS * 2 * n_g * 7 * DIM * 4 / 2**20:.1f} MiB")
    log(f"[giant-train] giant step's own peak device memory (above what the script held "
        f"before it): {peak_giant / 2**30:.3f} GiB without the struct remat, "
        f"{peak_remat / 2**30:.3f} GiB with it (limit {GIANT_PEAK_GIB} GiB); the process's "
        f"peak {peak_total['giant'] / 2**30:.3f} / {peak_total['remat'] / 2**30:.3f} GiB; {card}")
    if not max(peak_giant, peak_remat) <= GIANT_PEAK_GIB * 2**30:
        raise RuntimeError(f"[giant-train] the giant step's peak exceeds {GIANT_PEAK_GIB} GiB")

    def scan_alone_peak(scan, args=giant_args, ghf=giant_ghf):
        """Peak device memory, above what is held before, of the level
        recurrence alone on the giant batch: forward and backward through
        ``scan``'s autograd Function."""
        t = [a.clone().requires_grad_(i in level_kernel.FLOAT_ARGS) for i, a in enumerate(args)]
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hf = scan(*t, num_nodes=giant_batch["gate"].shape[0], num_levels=giant_levels)
        torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], ghf)
        sync()
        return torch.cuda.max_memory_allocated() - base

    scan_giant = scan_alone_peak(level_kernel.level_scan_giant)
    scan_fused = scan_alone_peak(level_scan)
    # hf, ghf's working copy and d_pack_lv, beside one level's scratch and the weight gradients
    law = 2 * giant_batch["gate"].shape[0] * DIM * 4 + nbytes(giant_args[0])
    log(f"[giant-train] level recurrence alone (forward and backward through the autograd "
        f"Function), peak above what is held before: giant route {scan_giant / 2**20:.1f} MiB "
        f"(hf + ghf's copy + d_pack_lv = {law / 2**20:.1f} MiB), fused route with residuals "
        f"{scan_fused / 2**20:.1f} MiB")
    if not (scan_giant <= 1.25 * law and scan_giant < scan_fused):
        raise RuntimeError("[giant-train] the giant route's working memory is not O(N D + Ep D)")

    clock("[plain64]")
    # a plain (unchunked) collate of the 64 circuits fails the fused route's
    # size gate on N and takes the giant route too
    plain64 = collate(graphs)
    p64_levels = dg_ae.num_levels(plain64)
    zero_counts()
    _, hf_p64 = model(plain64)
    sync()
    got = read_counts()
    d_hf = (hf_p64[:total_nodes] - hf_g).abs().max().item()
    log(f"[plain64] collate(graphs): N={plain64['gate'].shape[0]} "
        f"Ep={plain64['lv_edge_src'].shape[1]} Np={plain64['lv_nodes'].shape[1]}, real levels "
        f"{p64_levels}; forward launches {COUNT_NAMES} = {got}; max|dhf| against the bs64 encode "
        f"(fused route, C={C_fit}) = {d_hf:.3e}")
    if got != (2 * ROUNDS, 0, 0, 0, 0, 0, 1, 0, 0, 0) or not d_hf <= KERNEL_TOL:
        raise RuntimeError(f"[plain64] launches {got} != one giant launch alone, or the routes "
                           f"disagree ({d_hf})")
    train_large("plain64", plain64, (2 * ROUNDS, SBWD_LAUNCHES, 0, 0, 0, 0, 1,
                                     giant_bwd_count(plain64), 0, 0), steps=1, prob_check=False)

    clock("[precision] (e)")
    # ---- [precision] (e): bf16 on the step and giant routes ----------------------
    # on phase 12's two-chunk bs64 batch (the step route, kernels 5 and 6) and
    # phase 15's giant batch (kernels 3 and 4), the model cast to bf16 as
    # compute_dtype="bfloat16" casts it
    t_e = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    to16 = lambda args: tuple(a.to(torch.bfloat16) if i in level_kernel.FLOAT_ARGS else a
                              for i, a in enumerate(args))
    N_g = giant_batch["gate"].shape[0]
    s16, rghf16 = to16(step_args), route_ghf.to(torch.bfloat16)
    g16, gghf16 = to16(giant_args), giant_ghf.to(torch.bfloat16)
    ms16 = {}
    # (e1) kernels 3-6 in bf16 against their plain bf16 versions (each output
    # within BF16_ULPS of its own scale), kernel 3 = kernel 1 in bf16 bit for
    # bit; CUDA events, plain / bf16 kernel / fp32 kernel in turns
    with torch.no_grad():
        hf3 = level_kernel._giant_forward_cuda(g16, N_g, giant_levels)
        same31 = torch.equal(hf3, level_kernel._forward_cuda(g16, N_g, giant_levels,
                                                             residuals=False))
        e16_giant = bf16_close("giant forward (kernel 3) hf", hf3,
                               level_kernel.level_scan_giant_reference(
                                   *g16, num_nodes=N_g, num_levels=giant_levels), BF16_ATOL)
        k_g = min(level_kernel.giant_chunk_levels(g16[0].shape[1], g16[4].shape[1], DIM,
                                                  g16[0].shape[0], N_g, cfg.num_experts),
                  giant_levels)
        grep4, e16_giant_bwd = bf16_grads(
            "giant backward (kernel 4)", grad_names,
            level_kernel._giant_backward_cuda(gghf16, hf3, g16, giant_levels),
            level_kernel.level_scan_giant_bwd_reference(gghf16, hf3, *g16,
                                                        num_levels=giant_levels,
                                                        chunk_levels=k_g))
        prep16 = level_kernel._prepared(s16, backward=True)
        hf5, re5, rn5 = level_kernel._step_route_forward_cuda(s16, ch_levels, n_sub, True,
                                                              *prep16)
        re5, rn5 = written_rows(s16[2], s16[3], s16[5], s16[0].shape[0], re5, rn5)
        e16_step = max(bf16_close(f"step route forward (kernel 5) {name}", k, r, BF16_ATOL)
                       for name, k, r in zip(("hf", "res_e", "res_n"), (hf5, re5, rn5),
                                             level_kernel.level_scan_step_reference(
                                                 *s16, ch_levels, n_sub, with_residuals=True)))
        srep6, e16_step_bwd = bf16_grads(
            "step route backward (kernel 6)", grad_names,
            level_kernel._step_route_backward_cuda(rghf16, re5, rn5, s16, ch_levels, n_sub,
                                                   *prep16),
            level_kernel.level_scan_step_bwd_reference(rghf16, re5, rn5, *s16[:9], s16[10],
                                                       s16[11], ch_levels, n_sub,
                                                       chunk_levels=step_K))
        prep32 = level_kernel._prepared(step_args, backward=True)
        _, re32, rn32 = level_kernel._step_route_forward_cuda(step_args, ch_levels, n_sub, True,
                                                              *prep32)
        hf3_32 = level_kernel._giant_forward_cuda(giant_args, N_g, giant_levels)
        timed16 = {   # name: (plain bf16, kernel bf16, kernel fp32)
            "level_scan_giant_bf16": (
                lambda: level_kernel.level_scan_giant_reference(*g16, num_nodes=N_g,
                                                                num_levels=giant_levels),
                lambda: level_kernel._giant_forward_cuda(g16, N_g, giant_levels),
                lambda: level_kernel._giant_forward_cuda(giant_args, N_g, giant_levels)),
            "level_scan_giant_bwd_bf16": (
                lambda: level_kernel.level_scan_giant_bwd_reference(
                    gghf16, hf3, *g16, num_levels=giant_levels, chunk_levels=k_g),
                lambda: level_kernel._giant_backward_cuda(gghf16, hf3, g16, giant_levels),
                lambda: level_kernel._giant_backward_cuda(giant_ghf, hf3_32, giant_args,
                                                          giant_levels)),
            "level_step_bf16": (
                lambda: level_kernel.level_scan_step_reference(*s16, ch_levels, n_sub,
                                                               with_residuals=True),
                lambda: level_kernel._step_route_forward_cuda(s16, ch_levels, n_sub, True,
                                                              *prep16),
                lambda: level_kernel._step_route_forward_cuda(step_args, ch_levels, n_sub, True,
                                                              *prep32)),
            "level_step_bwd_bf16": (
                lambda: level_kernel.level_scan_step_bwd_reference(
                    rghf16, re5, rn5, *s16[:9], s16[10], s16[11], ch_levels, n_sub,
                    chunk_levels=step_K),
                lambda: level_kernel._step_route_backward_cuda(rghf16, re5, rn5, s16, ch_levels,
                                                               n_sub, *prep16),
                lambda: level_kernel._step_route_backward_cuda(route_ghf, re32, rn32, step_args,
                                                               ch_levels, n_sub, *prep32)),
        }
        for name, (plain, k16, k32) in timed16.items():
            for f in (k16, k32):
                f()
            reps = 5 if "giant_bwd" in name else 10
            runs = [event_ms(torch, f, n) for f, n in ((plain, 1), (k16, reps), (k32, reps),
                                                       (k32, reps), (k16, reps), (plain, 1))]
            ms16[name] = ((runs[1] + runs[4]) / 2, (runs[0] + runs[5]) / 2, runs)
        del re32, rn32, hf3_32
    real16 = [k * L64 + lv for k, n in enumerate(ch_levels) for lv in range(n)]
    rows16 = [a[real16] for a in s16[:7]] + list(s16[7:])
    bounds.update(level_scan_giant_bf16=level_bound(g16, giant_levels, N_g, False),
                  level_scan_giant_bwd_bf16=giant_bwd_bound(g16, giant_levels, N_g),
                  level_step_bf16=level_bound(rows16, len(real16), CHUNKS * n_sub, True),
                  level_step_bwd_bf16=level_bound(rows16, len(real16), CHUNKS * n_sub, True,
                                                  True))
    log(f"[precision] (e1) card: {card}")
    log(f"[precision] (e1) bf16 kernels 3-6 vs plain: giant forward (N={N_g}, {giant_levels} "
        f"levels) max|d| {e16_giant:.3e}, equal bit for bit to kernel 1's bf16 launch without "
        f"residuals: {same31}; giant backward (K = {k_g}) max|d|/scale {grep4}; step route "
        f"forward (bs{N_CIRCUITS} C={CHUNKS}) max|d| hf/res_e/res_n {e16_step:.3e}; step route "
        f"backward (K = {step_K}) max|d|/scale {srep6} (each output within {BF16_ULPS} * its "
        f"scale)")
    for name, (k, pl, runs) in ms16.items():
        log(f"[precision] (e1) {name}: bf16 kernel {runs[1]:.4f}/{runs[4]:.4f} ms, fp32 kernel "
            f"{runs[2]:.4f}/{runs[3]:.4f} ms, plain bf16 {runs[0]:.4f}/{runs[5]:.4f} ms (CUDA "
            f"events, in turns); bound {bounds[name]['bound_ms']:.5f} ms by "
            f"{bounds[name]['bound_by']}")
    if not same31:
        raise RuntimeError("[precision] (e1) kernel 3 in bf16 differs from kernel 1 in bf16")

    clock("[precision] (e2)")
    # (e2) one bf16 train step on the two-chunk step-route batch, card vs CPU,
    # with its launches
    zero_counts()
    s_card = step_grads(cfg16, chunked, DEVICE, WEIGHTS)
    sync()
    route16 = read_counts()
    want = (2 * ROUNDS, SBWD_LAUNCHES, 0, 0, step_fwd_want, step_bwd_want, 0, 0, 0, 0)
    held_step = step_held(f"bf16 step route (bs{N_CIRCUITS} C={CHUNKS}) card vs CPU", s_card,
                          step_grads(cfg16, chunked, "cpu", WEIGHTS), BF16_ATOL)
    log(f"[precision] (e2) bf16 train step on the step route (bs{N_CIRCUITS} C={CHUNKS}): "
        f"launches {COUNT_NAMES} {route16}; card vs CPU: {held_step}")
    if route16 != want:
        raise RuntimeError(f"[precision] (e2) launches {route16} != {want}")

    clock("[precision] (e3)")
    # (e3) the giant batch in bf16: encode and one train step card vs CPU; the
    # step's median wall time and peak device memory beside fp32's, and the
    # level recurrence's peak against phase 17's law
    valid_g = torch.as_tensor(giant_batch["node_valid"])
    enc_g = {}
    for where in ("cpu", DEVICE):
        p_e, _ = dg_ae.init_params(cfg16, seed=SEED, device=where)
        with torch.inference_mode():
            hs_e, hf_e, _ = dg_ae.forward(p_e, giant_batch, cfg16)
        enc_g[where] = (hs_e.cpu()[valid_g], hf_e.cpu()[valid_g])
    e_giant = [bf16_close(f"bf16 giant encode card vs CPU {n}", g, c, BF16_ATOL)
               for n, g, c in zip(("hs", "hf"), enc_g[DEVICE], enc_g["cpu"])]
    del enc_g
    zero_counts()
    s_card = step_grads(cfg16, giant_batch, DEVICE, GIANT_WEIGHTS)
    sync()
    giant16 = read_counts()
    want = (2 * ROUNDS, SBWD_LAUNCHES, 0, 0, 0, 0, 1, giant_bwd_count(giant_batch), 0, 0)
    held_giant = step_held("bf16 giant card vs CPU", s_card,
                           step_grads(cfg16, giant_batch, "cpu", GIANT_WEIGHTS), BF16_ATOL)
    log(f"[precision] (e3) bf16 giant (N={N_g}): encode card vs CPU max|d| hs/hf "
        f"{e_giant[0]:.3e}/{e_giant[1]:.3e}; one train step (weights {GIANT_WEIGHTS}): launches "
        f"{COUNT_NAMES} {giant16}; card vs CPU: {held_giant}")
    if giant16 != want:
        raise RuntimeError(f"[precision] (e3) launches {giant16} != {want}")
    if leaf_faults:
        raise RuntimeError(f"[precision] gradient leaves past their bounds: {leaf_faults}")

    def giant_step_peak(c):
        """Peak device memory of one giant train step (forward, losses,
        backward) above what is held before it."""
        p4, s4 = dg_ae.init_params(c, seed=SEED, device=dev)
        for t in train_step_mod.param_leaves(p4):
            t.requires_grad_(True)
        neg, keep = fixed_draws(giant_batch, SEED + 11)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        total, _ = train_step_mod.loss_and_metrics(
            p4, s4, giant_batch, None, GIANT_WEIGHTS, c, True,
            neg_edges=tuple(t.to(dev) for t in neg), drop_keep=[k.to(dev) for k in keep])
        total.backward()
        sync()
        return torch.cuda.max_memory_allocated() - base

    # fp32's: phase 17's step without the struct remat, measured the same way
    peak16 = {"fp32": peak_giant, "bf16": giant_step_peak(cfg16)}
    wall_g = {}
    for name, c in (("fp32", cfg), ("bf16", cfg16)):
        p_t, s_t = dg_ae.init_params(c, seed=SEED, device=dev)
        ts_t, _ = train_step_mod.make_train_step(c, train_step_mod.make_optimizer(p_t, GIANT_LR))
        ts_t(p_t, s_t, giant_batch, gen, GIANT_WEIGHTS)
        wall_g[name] = median_wall(lambda: ts_t(p_t, s_t, giant_batch, gen, GIANT_WEIGHTS), 3,
                                   sync) * 1e3
    scan16 = scan_alone_peak(level_kernel.level_scan_giant, g16, gghf16)
    law16 = N_g * DIM * (2 + 4) + nbytes(g16[0])    # hf (bf16) + ghf's copy (fp32) + d_pack_lv
    log(f"[precision] (e3) card: {card}")
    log(f"[precision] (e3) giant MIG train step (host batch -> Adam update, synchronised), "
        f"median of 3 after one: fp32 {wall_g['fp32']:.3f} ms, bf16 {wall_g['bf16']:.3f} ms; "
        f"one step's own peak device memory: fp32 {peak16['fp32'] / 2**30:.3f} GiB (phase 17), "
        f"bf16 "
        f"{peak16['bf16'] / 2**30:.3f} GiB; the level recurrence alone in bf16: "
        f"{scan16 / 2**20:.1f} MiB, against its hf (bf16) + ghf's copy (fp32) + d_pack_lv "
        f"(bf16) = {law16 / 2**20:.1f} MiB ({scan16 / law16:.3f} x) and fp32's law "
        f"{law / 2**20:.1f} MiB ({scan16 / law:.3f} x; K = {k_g}, fp32's, its scratch fp32) "
        f"beside fp32's {scan_giant / 2**20:.1f} MiB")
    if not (scan16 <= 1.25 * law and scan16 < scan_giant
            and peak16["bf16"] <= GIANT_PEAK_GIB * 2**30):
        raise RuntimeError("[precision] (e3) the bf16 giant route's working memory exceeds "
                           "fp32's law or fp32's own, or the step's peak its limit")
    del s16, g16, rghf16, gghf16, hf3, hf5, re5, rn5, prep16, prep32
    log(f"[precision] (e): {time.perf_counter() - t_e:.1f} s")

    clock("phase 18")
    # ---- 18. timing (informational) ----------------------------------------------
    args, ghf, n_lv = giant_args, giant_ghf, giant_levels
    N = giant_batch["gate"].shape[0]
    with torch.no_grad():
        g3 = lambda: level_kernel._giant_forward_cuda(args, N, n_lv)
        p3 = lambda: level_kernel.level_scan_giant_reference(*args, num_nodes=N, num_levels=n_lv)
        k1 = lambda: level_kernel._forward_cuda(args, N, n_lv, residuals=False)
        k1r = lambda: level_kernel._forward_cuda(args, N, n_lv, residuals=True)
        hf_k, re_1, rn_1 = k1r()
        g4 = lambda: level_kernel._giant_backward_cuda(ghf, hf_k, args, n_lv)
        p4 = lambda: level_kernel.level_scan_giant_bwd_reference(ghf, hf_k, *args,
                                                                 num_levels=n_lv)
        k2 = lambda: level_kernel._backward_cuda(ghf, re_1, rn_1, args, n_lv)
        for f in (g3, p3, k1, g4, p4, k2):
            f()
        kr, pr = 10, 2
        g3_p1, g3_k1, g3_f1 = event_ms(torch, p3, pr), event_ms(torch, g3, kr), event_ms(torch, k1, kr)
        g3_r1 = event_ms(torch, k1r, kr)
        g3_r2 = event_ms(torch, k1r, kr)
        g3_f2, g3_k2, g3_p2 = event_ms(torch, k1, kr), event_ms(torch, g3, kr), event_ms(torch, p3, pr)
        g4_p1, g4_k1, g4_f1 = event_ms(torch, p4, pr), event_ms(torch, g4, kr), event_ms(torch, k2, kr)
        g4_f2, g4_k2, g4_p2 = event_ms(torch, k2, kr), event_ms(torch, g4, kr), event_ms(torch, p4, pr)
    g3_k, g3_p = (g3_k1 + g3_k2) / 2, (g3_p1 + g3_p2) / 2
    g4_k, g4_p = (g4_k1 + g4_k2) / 2, (g4_p1 + g4_p2) / 2
    # kernel 7 on the giant batch, without and with residuals, in turns
    gb = dg_ae.batch_to_device(giant_batch, dev)
    with torch.no_grad():
        gsargs = struct_inputs(model.params["struct"], dg_ae.struct_input(gb["gate"], cfg), gb,
                               True)
        gtables = struct_tables(gb)
        g7 = lambda: struct_kernel._forward_cuda(gsargs, gtables, ROUNDS, True, residuals=False)
        g7r = lambda: struct_kernel._forward_cuda(gsargs, gtables, ROUNDS, True, residuals=True)
        g7()
        g7r()
        g7_1, g7r_1 = event_ms(torch, g7, kr), event_ms(torch, g7r, kr)
        g7r_2, g7_2 = event_ms(torch, g7r, kr), event_ms(torch, g7, kr)
    g7_bound = struct_bound(gsargs, gtables, int(giant_batch["n_edges"]), False)
    g7r_bound = struct_bound(gsargs, gtables, int(giant_batch["n_edges"]), True)
    del gb, gsargs, gtables
    bounds.update(level_scan_giant=level_bound(args, n_lv, N, False),
                  level_scan_giant_bwd=giant_bwd_bound(args, n_lv, N))
    del re_1, rn_1
    with torch.inference_mode():
        enc = lambda: dg_ae.forward(model.params, giant_batch, cfg)
        for _ in range(2):
            enc()
        genc_s = median_wall(enc, 5, sync)
    p5, s5 = dg_ae.init_params(cfg, seed=SEED, device=dev)
    opt5 = train_step_mod.make_optimizer(p5, GIANT_LR)
    step5, _ = train_step_mod.make_train_step(cfg, opt5)
    for _ in range(2):
        step5(p5, s5, giant_batch, gen, GIANT_WEIGHTS)
    gstep_s = median_wall(lambda: step5(p5, s5, giant_batch, gen, GIANT_WEIGHTS), 5, sync)
    gstage_ms = staged_ms(p5, s5, opt5, giant_batch, GIANT_WEIGHTS, 1, 5)
    log(f"[time] card: {card}")
    log(f"[time] giant level scan alone ({n_lv} levels, N={N} Ep={args[0].shape[1]} "
        f"Np={args[4].shape[1]}), CUDA events over {kr} calls (plain: {pr}): giant kernel "
        f"{g3_k1:.4f}/{g3_k2:.4f} ms, plain {g3_p1:.4f}/{g3_p2:.4f} ms, fused kernel without "
        f"residuals {g3_f1:.4f}/{g3_f2:.4f} ms, with residuals {g3_r1:.4f}/{g3_r2:.4f} ms")
    log(f"[time] giant struct towers alone ({2 * ROUNDS} half-rounds, N={N}), CUDA events over "
        f"{kr} calls: without residuals {g7_1:.4f}/{g7_2:.4f} ms, with residuals "
        f"{g7r_1:.4f}/{g7r_2:.4f} ms; bounds by bytes {g7_bound['bytes_ms']:.4f} / "
        f"{g7r_bound['bytes_ms']:.4f} ms, by operations {g7_bound['operations_ms']:.4f} ms")
    log(f"[time] giant level scan backward alone: giant kernel (recomputes) {g4_k1:.4f}/"
        f"{g4_k2:.4f} ms, plain (recomputes) {g4_p1:.4f}/{g4_p2:.4f} ms, fused backward from "
        f"saved residuals {g4_f1:.4f}/{g4_f2:.4f} ms")
    profile_train(torch, lambda: step5(p5, s5, giant_batch, gen, GIANT_WEIGHTS), card,
                  f"giant MIG train step (N={N})", steps=3, rows=16, warm=0)
    log(f"[time] giant MIG encode (host batch -> hs, hf on card), median of 5: "
        f"{genc_s * 1e3:.3f} ms; giant MIG train step (host batch -> Adam update, synchronised), "
        f"median of 5: {gstep_s * 1e3:.3f} ms; stages: " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in gstage_ms.items()))

    def entry(name, source, replaces, launches, err, ms, plain_ms, **more):
        # library_ms: no single PyTorch call computes any of these functions
        return {"name": name, "route": "cuda", "source": f"mgvae_tpu_torch/csrc/{source}",
                "replaces": f"mgvae_tpu/ops/pallas/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bounds[name],
                "library_ms": None, **more}

    clock("the kernels line")
    print(json.dumps({"kernels": [
        # encode path (phases 3-5)
        entry("struct_towers", "struct_towers.cu", "struct_kernel.py:175", enc_struct,
              struct_err, sms_k, sms_p),
        # training path's forward (phases 6-8)
        entry("struct_towers_residuals", "struct_towers.cu", "struct_kernel.py:175", train_sfwd,
              sres_err, srms_k, srms_p),
        entry("struct_towers_bwd", "struct_towers_bwd.cu", "struct_kernel.py:338", train_sbwd,
              sbwd_err, sbms_k, sbms_p),
        entry("level_lists", "level_lists.cu", "level_kernel.py:404", enc_lists, lists_err,
              lists_ms, lists_plain_ms),
        entry("level_scan", "level_scan.cu", "level_kernel.py:173", enc_launches, enc_err,
              ms_k, ms_p, levels_walked=walked, lists_ms=lists_ms),
        entry("level_scan_residuals", "level_scan.cu", "level_kernel.py:173", train_fwd,
              res_err, rms_k, rms_p, levels_walked=train_walked[0], lists_ms=lists_ms),
        entry("level_scan_bwd", "level_scan_bwd.cu", "level_kernel.py:487", train_bwd, bwd_err,
              bms_k, bms_p, levels_walked=train_walked[1]),
        # the step route's training path (phases 10, 12, 14)
        # (the route: the script's numbers for its passes over the two-chunk
        # batch; the single-level kernels' errors on their own keys)
        entry("level_step", "level_step.cu", "level_kernel.py:1636", step_totals[4], route_err,
              sr_k, sr_p, launches_per_pass=step_fwd_want, single_level_max_abs_err=step_err),
        entry("level_step_bwd", "level_step_bwd.cu", "level_kernel.py:1706", step_totals[5],
              route_bwd_err, sb_k, sb_p, launches_per_pass=step_bwd_want,
              single_level_max_abs_err=step_bwd_err),
        # the giant route's training path (phases 15, 17, 18)
        entry("level_scan_giant", "level_scan.cu", "level_kernel.py:911", giant_totals[6],
              giant_err, g3_k, g3_p),
        entry("level_scan_giant_bwd", "level_scan_giant_bwd.cu", "level_kernel.py:1195",
              giant_totals[7], giant_bwd_err, g4_k, g4_p),
        # the bf16 main path ([precision]): launches over its BF16_STEPS train steps
        entry("struct_towers_bf16", "struct_towers.cu", "struct_kernel.py:175", bf16_counts[0],
              b16_sfwd, *b16_ms["struct_towers_bf16"][:2]),
        entry("struct_towers_bwd_bf16", "struct_towers_bwd.cu", "struct_kernel.py:338",
              bf16_counts[1], b16_sbwd, *b16_ms["struct_towers_bwd_bf16"][:2]),
        entry("level_scan_bf16", "level_scan.cu", "level_kernel.py:173", bf16_counts[2], b16_fwd,
              *b16_ms["level_scan_bf16"][:2]),
        entry("level_scan_bwd_bf16", "level_scan_bwd.cu", "level_kernel.py:487", bf16_counts[3],
              b16_bwd, *b16_ms["level_scan_bwd_bf16"][:2]),
        # bf16 on the step and giant routes ([precision] (e)): launches of
        # (e2)'s and (e3)'s train steps; the fp32 kernel's time in the same call
        # beside; the step route's numbers for its passes, as above
        entry("level_scan_giant_bf16", "level_scan.cu", "level_kernel.py:911", giant16[6],
              e16_giant, *ms16["level_scan_giant_bf16"][:2],
              fp32_ms=sum(ms16["level_scan_giant_bf16"][2][2:4]) / 2),
        entry("level_scan_giant_bwd_bf16", "level_scan_giant_bwd.cu", "level_kernel.py:1195",
              giant16[7], e16_giant_bwd, *ms16["level_scan_giant_bwd_bf16"][:2],
              fp32_ms=sum(ms16["level_scan_giant_bwd_bf16"][2][2:4]) / 2),
        entry("level_step_bf16", "level_step.cu", "level_kernel.py:1636", route16[4], e16_step,
              *ms16["level_step_bf16"][:2], launches_per_pass=step_fwd_want,
              fp32_ms=sum(ms16["level_step_bf16"][2][2:4]) / 2),
        entry("level_step_bwd_bf16", "level_step_bwd.cu", "level_kernel.py:1706", route16[5],
              e16_step_bwd, *ms16["level_step_bwd_bf16"][:2], launches_per_pass=step_bwd_want,
              fp32_ms=sum(ms16["level_step_bwd_bf16"][2][2:4]) / 2),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
