"""Smoke run of the PyTorch + CUDA port (mgvae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises and the script exits nonzero):
  1. device: require CUDA; print the card's name and power limit.
  2. build: compile csrc/*.cu with nvcc for sm_90a; print the seconds and
     ptxas' report; build the native host library (native/mgvae_native.cpp,
     g++) and fail unless it loads: every collate from phase 3 on runs on it.
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
  [wide] models past the kernels' width, which take the plain route (the
     eager struct towers and dg_ae.level_scan_fast, as the JAX package takes
     its XLA paths past its gates): round 5's configuration, MIG bs16,
     D = 256, s/t_rounds 4, layernorm, in fp32 ("highest") and bf16, each
     with every kernel's launch count 0: one encode (fp32 through
     Model.encode_many) and one train step (weights [1, 4, 2, 0]) card vs
     CPU (fp32: hs, hf within 1e-4 of their scale, each gradient leaf as
     phase 7 holds its step; bf16: hs, hf within 2^-6 of their scale, the
     step as [precision] (c)); one step at D = 160 on phase 12's two-chunk
     bs64 batch card vs CPU as phase 12 holds it, no launch; for
     information the bs16 step's medians at D = 256 in fp32 and bf16
     beside D = 64's, in turns, a D = 256 step's own peak memory, and
     torch.profiler over one fp32 D = 256 step.
  [pretrained] a reference state dict (benchmarks/torch_reference's
     ReferenceModel, torch only; MIG, D = 64, layernorm) saved as
     {"epoch": 3, "state_dict": ...} and read by Model.load: one bs16
     encode_many request on the card launches the struct kernel 8 times, the
     level scan and the level lists once each, and agrees with the same file
     on the CPU and with ReferenceModel's own forward within 1e-4;
     load_pretrained() without weights raises FileNotFoundError.

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

  [parallel] data and model parallelism (ROADMAP 1.7; ``parallel_phase``),
     after phase 18: (a) the [trainer] configuration's epoch with
     distributed=True under a one-rank NCCL process group (the launch
     variables set in this process), twice, bit for bit against the
     single-device epoch, twice (per-step losses and metrics, params,
     BN and Adam state), with the launches of each step (the
     single-device step's and one all-reduce) and the ms per step in
     turns (single, dp, dp, single: the first of each kind warms cuBLAS
     and NCCL up); (b) the within-level sharded train step at mp = 1 by the
     dst-complete kernel route on phase 7's bs16 batch (collated with the
     mp = 2 hint) and on the giant batch, through shard_levels_by_dst(batch,
     1): kernel 5 once and kernel 6's three launches per real level as
     their C entries count them, the lists once, the collectives 2 (4 *
     s_rounds + L) + 1; each gradient leaf within 1e-4 * max(scale, 1) of the
     single-device step's (kernels 1/2 at bs16, 3/4 on the giant batch),
     without the prob term (SMOOTH_WEIGHTS); the ms per step of both in
     turns and a torch.profiler table of the sharded giant step; the same
     step at D = 256, past the kernels' width, where the route is the
     edge-split one (plain torch, no kernel launched) against the
     single-device step (its plain route there); kernels 5 and 6
     on member tables (bs16 at mp = 1 and 2, the giant batch at mp = 1,
     every real level) against level_step_reference /
     level_step_bwd_reference (KERNEL_TOL; 1e-4 * max(scale, 1)), and a
     pass of each over the giant member tables' levels by CUDA events
     beside its plain version; (c) two processes sharing the card over
     gloo (``--parallel-worker`` under ``torchrun --standalone``): dp = 2,
     whose averaged gradients equal
     one process averaging both shards' own, and dp = 1 x mp = 2 on the
     bs16 batch (each member's launches; gradients against (b)'s), each
     with its ms per step; whether this torch's gloo takes CUDA tensors;
     and [multistep] (f)'s gloo check (``ms_gloo_check``): the K-step call
     refuses the gloo group, the trainer at steps_per_call 8 steps singly.

  [balancer] the multi-task trainers and the rest of ROADMAP 1.9
     (``balancer_phase``), after [parallel]: (a) one epoch each of
     BalancerTrainer, GradNormTrainer and EarlyTrainer(patience=1) in
     [trainer]'s configuration (weights [1, 4, 4], lr 1e-4): launches per
     Balancer / GradNorm train step (8, 51, 1, 6, 1, 0, ...): one forward and
     three backwards from its residuals, the struct backward per task and
     the level backward for prob and func; EarlyTrainer's as the plain
     trainer's; finite meters, the epoch lines, GradNorm's weights summing
     to 3, model_best.pth; the ms per train step beside the plain trainer's
     in turns and each epoch's peak memory; (b) the three per-task gradients
     of one forward bit for bit against three separate forward + backward
     passes with the same draws on phase 7's bs16 batch, phase 12's
     two-chunk batch (step route) and the giant batch, launches (the
     route's backward twice, the struct backward three times) and peak
     memory beside one step's; one Balancer step on bs16 card vs CPU (each
     task's gradient leaf, each scale and the weighted sum within 1e-4 *
     max(scale, 1)) and phase 7's masked prob check; (c) the Balancer epoch
     over a one-rank NCCL group bit for bit against the single-device epoch
     (one all-reduce a step); (d) Trainer(trace_dir=...) over one [trainer]
     epoch: one trace file naming the kernels of rows 1, 2, 7, 8 and the
     lists kernel (a table of calls and device ms), the epoch's numbers bit
     for bit an untraced epoch's; (e) the large-batch example on the card;
     (f) the struct backward re-entered three times and the level backward
     twice from one forward's residuals on the bs16 batch: every saved
     tensor unchanged, a cotangent's gradients again bit for bit, each
     within 1e-4 * max(scale, 1) of its plain version, time per backward
     by CUDA events; (g) the [trainer] epoch's host collation with and
     without the allocator tuning (two ``--collate-probe`` subprocesses).

  [native] the native host library (ROADMAP 1.10; ``native_phase``), after
     [balancer]: (a) the library phase 2 built with g++ from the port's copy
     of the C++ source (its seconds, ABI 3; a library that does not load
     fails the run there); (b) its batches against the numpy branch's, byte
     for byte on every key, dtype and shape: bs16 per modality,
     collate(mp=2), the 64 circuits by collate_fit, collate_chunked(2) and
     collate_split(4), collate_shards and collate_split_step at dp = 2, and
     the giant batch; (c) host ms, medians of 21 calls, native against
     numpy in turns: a bs16 collate, the trainer's epoch plan (the stats
     cache against trial collates), collate_shards of 8 bs16 shards at 1
     and 8 threads, the giant collate; (d) [trainer]'s epoch in ms per step
     over three epochs, native in this process against numpy in a process
     under MGVAE_NO_NATIVE=1 (``--native-probe``), beside the bare loop,
     every step's metrics bit for bit.

  [multistep] the K-step calls (ROADMAP 1.14; ``multistep_phase``), last:
     (a) MIG bs16 at K = 8 in full fp32, TF32 and bf16: two K-step train and
     eval calls (``make_multi_step`` / ``make_multi_eval``: the first step
     eager, one capture each, then replays) against the same steps as
     ``train_step`` / ``eval_step`` calls, metric rows, params, Adam's state,
     BN state and the generator's state bit for bit, launches per step, and
     under torch.profiler the replayed kernels' device time; (b) the same on
     bs64 C=2 (the step route, K = 4), split G=4 (K = 4) and the giant batch
     (K = 2): graph against the same calls run eagerly bit for bit, and
     against ``train_step``'s real-level walk (bit for bit on the split
     layout's fused route; the step and giant backwards' blocks of levels
     shift with the padded walk, so there the weight gradients' sums
     reassociate), and fault 3.10's check: ONE bs64 C=2 step on the step
     route as the K-step call's replayed graph against ``train_step``'s
     real-level walk, from the same params and draws, each gradient leaf
     within 1e-4 of its own scale (floored as phase 7 floors it); (c)
     [trainer]'s epoch at steps_per_call 8 against 1, in
     turns: rows and tensors bit for bit, ms per train step (medians),
     captures, launches per step, and one epoch of each under
     torch.profiler (wall, device busy share, host time); (d) the 3-stage
     CLI at 8 against 1 with an lr decay every epoch: the six epoch lines
     equal but for their time; (e) a step that reads a loss back on the
     host raises from its capture; (f) the K-step calls under data
     parallelism (ROADMAP 1.15; ``multistep_dp``) over a one-rank NCCL group
     (the launch variables set in-process): [trainer]'s epoch grouped at
     steps_per_call 8 under the group, the single-device grouped epoch and
     the group's per-step epoch, twice each in turns, everything bit for
     bit, one capture for train and none for val, launches per step (8,
     17, 1, 3, 1) and one all-reduce (the counts set to 0 before each epoch
     and read after: every kernel of the path and the all-reduce launched),
     ms per train step of each; one grouped data-parallel epoch under
     torch.profiler (busy share) beside the single-device grouped one, and
     the device events per step that the group's mean adds, by name (the
     one-rank all-reduce's NCCL kernel or copy among them); one K = 4 call
     of the bs64 C=2 layout on the step route (kernels 5 and 6) under the
     group bit for bit against the same steps run eagerly under it and
     against the single-device call; and the gloo check made in [parallel]
     (c)'s two processes sharing the card (``ms_gloo_check``):
     ``make_multi_step(group=)`` raises a ValueError naming NCCL before any
     step, and a Trainer at steps_per_call 8 steps singly. [trainer],
     [balancer] (a), (d) and [native] (d) run the grouped trainer
     (steps_per_call 8) and count a K-step call's launches and rows per
     step.

  [multichip] the four-card dry run at one rank (ROADMAP 1.12, 1.13;
     ``multichip_phase``): ``python -m mgvae_tpu_torch.examples.dryrun_multichip
     --nproc 1 --phases kbde`` in a subprocess (its launcher, torchrun and one
     NCCL rank on this card), which must exit 0 with every phase's lines:
     (k) kernels 7, 8, 1, 2, 5, 6 against their plain versions on the rank's
     card on the main thread, in autograd's device thread and replayed from
     a CUDA graph; (b) the K-step calls under the group (the data-parallel
     step's body and its all-reduce), graph against eager bit for bit, and
     the step route; (d) a Balancer epoch; (e) the sharded step at (1, 1)
     by both routes against the single-card step. The dry run's own lines
     are printed. Phase (a), which the card tests' one-rank DP test covers,
     is left to the dry run's own runs: with it the phase took 63 s.
  [gather] the backward of the model's row gathers (``gather_phase``),
     last: at the seven gather sites of a bs16 MIG and of the giant XMG
     train step (the benchmark cells' batches), ``csrc/gather_rows_bwd.cu``
     twice bit for bit and against its plain version on the CPU
     (``index_add_`` in index order) within each row's entries x 2^-24 x
     the sum of its terms' |values|; by CUDA events the op's backward, the
     plain version on the card and PyTorch's index backward of the same
     gathers; ``gather.bwd_launches`` over a K = 8 train and eval call on
     the bs16 circuits and one eager giant train step (14 a train step,
     none in eval).

Prints a {"kernels": [...]} JSON line (one entry per kernel and path: the
encode path's struct towers, level lists and level scan, the training path's struct
towers and level scan with residuals, the two backwards, the step route's
forward and backward (its passes over the bs64 two-chunk batch, with the
launches of one pass beside), the giant forward and backward, the four
bf16 kernels of the fused route ([precision]; bounds with the values' bytes
halved) and the four of the step and giant routes ([precision] (e), their
launches from (e2) and (e3), the fp32 kernel's time in the same call as
fp32_ms; and [parallel]'s two, kernels 5 and 6 on model-parallel member
tables: level_step_mp, level_step_bwd_mp, their launches from (b)'s two
sharded steps, their times and bounds over one pass of the giant member
tables' levels; and [balancer]'s two, kernels 8 and 2 re-entered from one
forward's residuals on the Balancer step: struct_towers_bwd_reentered,
level_scan_bwd_reentered, their launches from (a)'s Balancer epoch with
launches_per_step, their time per backward and bounds on the bs16 batch;
and [multistep]'s four, kernels 7, 8, 1 and 2 replayed from (a)'s fp32
graph: struct_towers_graph, struct_towers_bwd_graph, level_scan_graph,
level_scan_bwd_graph, their launches in (a)'s graph run, max |d| of the
run against its eager steps, device ms per train step under
torch.profiler, the plain versions' times and bounds of the eager entries;
and [gather]'s two, the row gathers' backward at the seven sites of the
bs16 and the giant train step: gather_rows_bwd, gather_rows_bwd_giant,
their launches on the main path with launches_per_step, max |d| against
the CPU's plain version and its share of the rounding bound, the times
summed over the sites, with PyTorch's index backward as library_ms);
each with its launches on its main path, its
time, its plain version's, and its bound: the larger of its bytes over
3.35 TB/s and its operations at their type's peak (67 TFLOP/s in fp32; the
bf16 entries' products, bf16 operands with fp32 accumulation, at 989
TFLOP/s on the tensor cores), computed from this run's inputs, with both
terms as bytes_ms and operations_ms), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
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
import types

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
# floors them. The CPU side's row gathers sum a bf16 gradient in fp32 and
# round once, as the card's kernel does (``gathers_as_on_card``). A leaf's gradient is a sum over every edge or node whose
# terms cancel, and each term differs between the two by about a bf16 ulp
# (the card's and the CPU's fp32 sums round to bf16 apart): the error
# follows the terms, not the sum (the expert value bias, a sum over ~8k
# edges, moved 6.8% of its own scale on a bs64 step). TF32 against full
# fp32: each tensor within 1e-2 * max(its scale, 1).
BF16_ATOL, BF16_F32_ATOL, BF16_RTOL, BF16_GRAD = 2e-2, 3e-2, 1e-1, 0.05
BF16_ULPS, BF16_LEAF = 2.0 ** -6, 2.0 ** -3
TF32_DRIFT = 1e-2
BF16_STEPS = 3
# [wide]: round 5's D = 256 configuration (bench.py:350-366) and its weights;
# the chunked layout at D = 160
WIDE_DIM, WIDE_CHUNKED_DIM = 256, 160
WIDE_WEIGHTS = [1.0, 4.0, 2.0, 0.0]
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


@contextlib.contextmanager
def gathers_as_on_card(where):
    """On the CPU, the row gathers' backward at the card kernels' rounding
    points (``ops/gather.gather_rows_bwd_fp32``: a bf16 sum in fp32, rounded
    once; fp32 bit for bit the CPU's own), for the CPU side of a step held
    against the card's: the CPU's autograd rounds a bf16 sum at every add."""
    from mgvae_tpu_torch.ops import gather

    if str(where) != "cpu":
        yield
        return
    plain = gather.gather_rows_bwd_reference
    gather.gather_rows_bwd_reference = gather.gather_rows_bwd_fp32
    try:
        yield
    finally:
        gather.gather_rows_bwd_reference = plain


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

    def counting_make(cfg, optimizer, **kw):
        """make_train_step whose steps record their launches and metrics."""
        train_step, eval_step = make(cfg, optimizer, **kw)

        def recorded(phase, fn):
            def call(*a, **kw):
                before = counts()
                out = fn(*a, **kw)
                per_step[phase].append(tuple(x - y for x, y in zip(counts(), before)))
                metrics[phase].append(out[1] if phase == "train" else out)
                return out
            return call

        return recorded("train", train_step), recorded("val", eval_step)

    makes_multi = (trainer_mod.make_multi_step, trainer_mod.make_multi_eval)

    def counting_multi(phase, make_multi):
        """make_multi_step / make_multi_eval whose K-step calls record each
        step's launches (the call's over K: its eager steps and replays
        enqueue alike) and metric row."""
        def made(*a, **kw):
            multi = make_multi(*a, **kw)

            def call(*ca, **ckw):
                before = counts()
                out = multi(*ca, **ckw)
                rows = out if phase == "val" else out[1]
                k = rows.shape[0]
                delta = [x - y for x, y in zip(counts(), before)]
                per_step[phase] += [tuple(x // k if x % k == 0 else -1 for x in delta)] * k
                metrics[phase] += [dict(zip(step_mod.METRIC_KEYS, r)) for r in rows]
                return out
            return call
        return made

    def run(argv):
        trainer_mod.make_train_step = counting_make
        trainer_mod.make_multi_step = counting_multi("train", makes_multi[0])
        trainer_mod.make_multi_eval = counting_multi("val", makes_multi[1])
        try:
            return cli.main(argv)
        finally:
            trainer_mod.make_train_step = make
            trainer_mod.make_multi_step, trainer_mod.make_multi_eval = makes_multi

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
        f"{dev} (steps_per_call {trainer.steps_per_call}: a group of 8 and a single step an "
        f"epoch, the val step singly): {wall:.1f} s for 3 stages; "
        f"{len(per_step['train'])} train steps and "
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


# [parallel]: data and model parallelism (ROADMAP 1.7) on the card
PAR_TIMED = 3                  # timed steps per variant and turn; medians
PAR_WORKER_TIMEOUT = 300       # seconds for (c)'s two processes, their start included
PAR_DIR = os.path.join("exp", "chip_smoke_parallel")
PAR_WIDE_DIM = 256             # (b)'s width past the kernels' (level_kernel.MAX_DIM, 128)
PAR_KEYS = ("recon_loss", "prob_loss", "func_loss", "kl_loss", "tp", "fp", "tn", "fn",
            "n_pred", "loss")
PAR_CFG = dict(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
               layernorm=True, matmul_precision="highest")


# [multistep]: the K-step calls and the grouped trainer (ROADMAP 1.14)
MS_K, MS_ROUTE_K, MS_GIANT_K = 8, 4, 2   # steps per call: bs16; the bs64 layouts; giant
MS_GROUPS = 2                  # calls per run: the first warms up and captures
MS_TURNS = 4                   # (c): epochs of each variant in turns; the first of each warms up
MS_DIR = os.path.join("exp", "chip_smoke_multistep")
# the kernels of rows 7, 8, 1 and 2 as the profiler names them, by entry
MS_KERNELS = {
    "struct_towers_graph": ("struct_fwd_kernel",),
    "struct_towers_bwd_graph": ("struct_bwd_row_kernel", "struct_grad_partial_kernel",
                                "struct_grad_sum_kernel"),
    "level_scan_graph": ("level_scan_kernel",),
    "level_scan_bwd_graph": ("level_scan_bwd_kernel", "expert_gemm_kernel",
                             "weight_reduce_kernel"),
}


def ms_run(torch, cfg, sb, mode: str, groups: int = MS_GROUPS, group=None) -> dict:
    """``groups`` K-step train calls, each followed by a K-step eval call, on
    the stacked batch ``sb`` from fixed params: ``mode`` "graph"
    (``make_multi_step`` / ``make_multi_eval``: the first step eager, then
    the capture and replays), "padded" (the same calls, every step eager:
    ``CAPTURE_WARMUP`` raised) or "eager" (K ``train_step`` / ``eval_step``
    calls a call: the real levels); ``group``: a data-parallel process
    group for every call. Returns the metric rows, the params, Adam's state
    and the BN state after, the generator's state, ms per step (train and
    eval alike, capture included) and launches per step."""
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.train import step as step_mod

    params, state = dg_ae.init_params(cfg, seed=SEED + 9, device=DEVICE)
    opt = step_mod.make_optimizer(params, TRAIN_LR)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    multi = step_mod.make_multi_step(cfg, opt, group=group)
    multi_eval = step_mod.make_multi_eval(cfg, group=group)
    train_step, eval_step = step_mod.make_train_step(cfg, opt, group=group)
    K = int(sb["gate"].shape[0])

    def row(m):
        return torch.stack([m[x] for x in step_mod.METRIC_KEYS])

    warm = step_mod.CAPTURE_WARMUP
    step_mod.CAPTURE_WARMUP = 10 ** 9 if mode == "padded" else warm
    rows = []
    try:
        torch.cuda.synchronize()
        before = step_mod.launch_counts()
        t0 = time.perf_counter()
        for _ in range(groups):
            if mode == "eager":
                tr = []
                for k in range(K):
                    state, m = train_step(params, state, step_mod.step_of(sb, k), gen, WEIGHTS)
                    tr.append(row(m))
                rows += [torch.stack(tr), torch.stack(
                    [row(eval_step(params, state, step_mod.step_of(sb, k), gen, WEIGHTS))
                     for k in range(K)])]
            else:
                state, r = multi(params, state, sb, gen, WEIGHTS)
                rows += [r, multi_eval(params, state, sb, gen, WEIGHTS)]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        after = step_mod.launch_counts()
    finally:
        step_mod.CAPTURE_WARMUP = warm
    adam = [t for p in step_mod.param_leaves(params) for t in opt.state[p].values()]
    return {"rows": torch.cat(rows), "gen": gen.get_state(), "ms": sec / (2 * groups * K) * 1e3,
            "tensors": [t.detach() for t in step_mod.param_leaves(params) + adam
                        + step_mod.param_leaves(state)],
            "launches": {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": after[(m, n)] - before[(m, n)]
                         for m, n in after if after[(m, n)] != before[(m, n)]},
            "steps": 2 * groups * K, "captures": multi.captures + multi_eval.captures,
            "call": (multi, params, state, gen, sb)}


def ms_differ(torch, a: dict, b: dict) -> tuple:
    """(bit for bit, max |d|) over two runs' rows, tensors and generator."""
    pairs = [(a["rows"], b["rows"])] + list(zip(a["tensors"], b["tensors"], strict=True))
    same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)
    worst = max(float((x.float() - y.float()).abs().max()) for x, y in pairs if x.numel())
    return same and torch.equal(a["gen"], b["gen"]), worst


def ms_one_step_grads(torch, cfg, sb) -> dict:
    """Fault 3.10: the gradients of ONE step, the second of the stacked
    batch ``sb`` (K = 2), as the K-step call's replayed graph (its first
    step eager, then the capture) and as ``train_step``'s real-level walk
    (two calls), from the same params (Adam at lr 0 keeps them) and the
    same draws. Returns the worst leaf's max |d| over 1e-4 of its own scale
    (floored at GRAD_FLOOR of the largest entry over all leaves, as phase 7
    floors it), that leaf's name, the worst unfloored ratio, and the step
    route's backward launches of each side."""
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import level_kernel
    from mgvae_tpu_torch.train import step as step_mod

    grads, launches, names = {}, {}, None
    for mode in ("graph", "real"):
        params, state = dg_ae.init_params(cfg, seed=SEED + 9, device=DEVICE)
        names = named_leaves(params)
        opt = step_mod.make_optimizer(params, 0.0)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
        before = level_kernel.step_bwd_launches
        if mode == "graph":
            multi = step_mod.make_multi_step(cfg, opt)
            multi(params, state, sb, gen, WEIGHTS)
            if multi.captures != 1:
                raise RuntimeError(f"[multistep] (b) 3.10: {multi.captures} captures, not 1")
        else:
            train_step, _ = step_mod.make_train_step(cfg, opt)
            for k in range(2):
                state, _ = train_step(params, state, step_mod.step_of(sb, k), gen, WEIGHTS)
        torch.cuda.synchronize()
        launches[mode] = level_kernel.step_bwd_launches - before
        grads[mode] = [None if p.grad is None else p.grad.detach().float()
                       for p in step_mod.param_leaves(params)]
    scale = max(g.abs().max().item() for g in grads["real"] if g is not None)
    worst, leaf, raw = 0.0, None, 0.0
    for name, a, c in zip(names, grads["graph"], grads["real"], strict=True):
        if (a is None) != (c is None):
            raise RuntimeError(f"[multistep] (b) 3.10: {name} has a gradient on one side only")
        if c is None:
            continue
        d = (a - c).abs().max().item()
        own = c.abs().max().item()
        ratio = d / (GRAD_TOL * max(own, GRAD_FLOOR * scale))
        raw = max(raw, d / own if own else (0.0 if d == 0 else math.inf))
        if not ratio <= worst:
            worst, leaf = ratio, name
    return {"worst": worst, "leaf": leaf, "raw": raw, "launches": launches}


def ms_profiled(torch, t, train_ds) -> dict:
    """One train epoch of the trainer ``t`` under torch.profiler: wall ms,
    device busy ms, host self ms of its operators, device events, and the
    device events by name (their counts)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t.train(1, train_ds, [])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [x for x in prof.events() if x.device_type == torch.autograd.DeviceType.CUDA]
    names: dict = {}
    for x in on_card:   # the profiler names one memset "(Device)" or "(Unknown)"
        name = re.sub(r"^Memset \(.*\)$", "Memset", x.name)
        names[name] = names.get(name, 0) + 1
    return {"wall": wall * 1e3, "busy": sum(x.time_range.elapsed_us() for x in on_card) / 1e3,
            "host": sum(x.self_cpu_time_total for x in prof.key_averages()) / 1e3,
            "events": len(on_card), "names": names}


def multistep_phase(torch, dev, card: str, env) -> dict:
    """[multistep] (ROADMAP 1.14): the K-step calls on the card. (a) bs16 at
    K = 8, graph against eager bit for bit in full fp32, TF32 and bf16,
    train and eval, with the replayed kernels' times; (b) the same on bs64
    C=2 (the step route, K = 4), split G=4 (K = 4) and the giant batch
    (K = 2): graph against the same steps run eagerly bit for bit, and
    against ``train_step``'s real-level walk; (c) the [trainer] epoch at
    steps_per_call 8 against 1 in turns: rows and tensors bit for bit, ms
    per train step, captures, launches, torch.profiler's busy share; (d)
    the 3-stage CLI at 8 against 1 through an lr decay each epoch; (e) a
    captured step made to fail raises. Returns the kernels line's entries'
    numbers."""
    from mgvae_tpu_torch import cli, random_circuit
    from mgvae_tpu_torch.data import batching
    from mgvae_tpu_torch.examples.level_scan_profile import by_name
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.train import step as step_mod
    from mgvae_tpu_torch.train import trainer as trainer_mod

    def cfg_of(**kw):
        return dg_ae.DGConfig(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                              layernorm=True, **kw)

    # ---- (a) bs16 at K = 8 ------------------------------------------------------
    env.clock("[multistep] (a)")
    graphs = dataset(random_circuit, "mig", SEED + 11, MS_K * BATCH)
    shards = [graphs[i * BATCH:(i + 1) * BATCH] for i in range(MS_K)]
    dims: dict = {}
    for sh in shards:
        for k, v in batching.natural_dims(sh).items():
            dims[k] = max(dims.get(k, 0), v)
    sb16 = batching.collate_shards(shards, dims=dims)
    out = {}
    ok = True
    for label, extra in (("fp32 highest", dict(matmul_precision="highest")),
                         ("TF32 default", dict(matmul_precision="default")),
                         ("bf16", dict(compute_dtype="bfloat16", matmul_precision="default"))):
        cfg = cfg_of(**extra)
        g, e = ms_run(torch, cfg, sb16, "graph"), ms_run(torch, cfg, sb16, "eager")
        same, worst = ms_differ(torch, g, e)
        per = {k: v / g["steps"] for k, v in g["launches"].items()}
        log(f"[multistep] (a) bs16 MIG (L = {sb16['lv_nodes'].shape[1]} padded levels), "
            f"K = {MS_K}, {label}: {MS_GROUPS} K-step train and eval calls (graph: "
            f"{g['captures']} captures) against {MS_GROUPS * MS_K} train_step and eval_step "
            f"calls each: metric rows, params, Adam's state, BN state and the generator bit for "
            f"bit {same} (max |d| {worst:.3e}); launches per step (train and eval alike) graph "
            f"{per}, eager {({k: v / e['steps'] for k, v in e['launches'].items()})}; ms per "
            f"step, the capture included, graph {g['ms']:.3f}, eager {e['ms']:.3f}")
        ok &= same and g["captures"] == 2
        if label == "fp32 highest":
            multi, params, state, gen, sbx = g["call"]
            names = by_name(lambda: multi(params, state, sbx, gen, WEIGHTS), 3)
            for entry, kernels in MS_KERNELS.items():
                hits = [(t, n) for name, (t, n) in names.items()
                        if any(re.search(rf"\b{k}\b", name) for k in kernels)]
                out[entry] = {"ms": sum(t for t, _ in hits) / MS_K / 1e3,
                              "per_step": sum(n for _, n in hits) / MS_K, "err": worst}
            log(f"[multistep] (a) card: {card}")
            log(f"[multistep] (a) one K = {MS_K} train call of replays under torch.profiler, "
                f"device ms per step and launches per step: "
                + "; ".join(f"{k} {v['ms']:.4f} ms in {v['per_step']:.1f}"
                            for k, v in out.items()))
            out["launches"] = g["launches"]
        del g, e
    torch.cuda.empty_cache()

    # ---- (b) the bs64 layouts and the giant batch --------------------------------
    env.clock("[multistep] (b)")
    big = dataset(random_circuit, "mig", SEED + 12, MS_ROUTE_K * N_CIRCUITS)
    shards64 = [big[i * N_CIRCUITS:(i + 1) * N_CIRCUITS] for i in range(MS_ROUTE_K)]
    layouts = (
        ("bs64 C=2, the step route", "level_kernel.step_launches",
         lambda: batching.collate_shards(shards64, num_chunks=CHUNKS)),
        ("bs64 split G=4", "level_kernel.launches",
         lambda: batching.collate_split_step(shards64, batching.split_dims(shards64, GROUPS))),
        (f"giant ({GIANT_WIDTH} x {GIANT_DEPTH})", "level_kernel.giant_launches",
         lambda: batching.collate_shards([[env.giant_graph]] * MS_GIANT_K)))
    cfg = cfg_of(matmul_precision="highest")
    for label, route, make in layouts:
        sb = make()
        g, p, e = (ms_run(torch, cfg, sb, mode) for mode in ("graph", "padded", "eager"))
        same_p, worst_p = ms_differ(torch, g, p)
        same_e, worst_e = ms_differ(torch, g, e)
        K = int(sb["gate"].shape[0])
        finite = bool(torch.isfinite(g["rows"]).all())
        log(f"[multistep] (b) {label}, K = {K}: graph ({g['captures']} captures) against the "
            f"same calls run eagerly bit for bit {same_p} (max |d| {worst_p:.3e}); against "
            f"train_step's real-level walk bit for bit {same_e} (max |d| {worst_e:.3e}); "
            f"{route} per step {g['launches'].get(route, 0) / g['steps']:.1f} graph, "
            f"{e['launches'].get(route, 0) / e['steps']:.1f} eager; ms per step, the capture "
            f"included, graph {g['ms']:.3f}, eager {e['ms']:.3f}; rows finite {finite}")
        ok &= same_p and finite and g["captures"] == 2 and g["launches"].get(route, 0) > 0
        if "split" in label:
            ok &= same_e
        del g, p, e, sb
        torch.cuda.empty_cache()
    # fault 3.10: ONE bs64 C=2 step on the step route, graph against the real walk
    sb = batching.collate_shards(shards64[:2], num_chunks=CHUNKS)
    real = [dg_ae.level_counts(step_mod.step_of(sb, k)) for k in range(2)]
    f310 = ms_one_step_grads(torch, cfg, sb)
    log(f"[multistep] (b) fault 3.10: ONE bs64 C=2 step on the step route (the second of a "
        f"K = 2 call; real levels per chunk {real}, tables "
        f"{dg_ae.table_levels(step_mod.step_of(sb, 1))} rows), "
        f"the K-step call's replayed graph against train_step's real-level walk from the same "
        f"params and draws: worst gradient leaf {f310['leaf']} at {f310['worst']:.4f} of "
        f"{GRAD_TOL} x its own scale (floored at {GRAD_FLOOR} of the largest entry), worst "
        f"unfloored max |d| / scale {f310['raw']:.3e}; step backward launches graph / real "
        f"{f310['launches']['graph']} / {f310['launches']['real']}")
    if not f310["worst"] <= 1.0 or not min(f310["launches"].values()) > 0:
        raise RuntimeError("[multistep] (b) fault 3.10: a gradient leaf of the K-step call's "
                           "step-route graph is past 1e-4 of its own scale against the real "
                           "walk, or a side did not take the step route")
    del sb

    # ---- (c) the [trainer] epoch at steps_per_call 8 against 1 -------------------
    env.clock("[multistep] (c)")
    shutil.rmtree(MS_DIR, ignore_errors=True)
    args = cli.get_parse_args(TRAINER_ARGV + ["--save_dir", MS_DIR])
    tcfg = cli.model_config(args)
    train_ds, val_ds = cli.load_dataset(args)
    runs = {}
    for spc in (MS_K, 1):
        p0, s0 = dg_ae.init_params(tcfg, seed=SEED + 5, device=DEVICE)
        t = trainer_mod.Trainer(args, tcfg, params=p0, state=s0, training_id=f"k{spc}",
                                save_dir=MS_DIR, batch_size=BATCH, distributed=False, seed=SEED,
                                steps_per_call=spc, device=DEVICE)
        t.set_training_args(rc_prob_func_weight=WEIGHTS[:3], lr=TRAIN_LR)
        rec: dict = {}
        runners = (t.multi_step, t.multi_eval)
        for name, ph in (("train_step", "train"), ("eval_step", "val"),
                         ("multi_step", "train"), ("multi_eval", "val")):
            bal_instrument(torch, t, name, ph, rec)
        runs[spc] = (t, rec, [], runners)
    for turn in range(MS_TURNS):
        for spc in ((MS_K, 1) if turn % 2 == 0 else (1, MS_K)):
            t, _, ms, _ = runs[spc]
            ms.append(t.train(1, train_ds, val_ds)["train"]["time"] * 1e3)
    torch.cuda.synchronize()
    side = {}
    for spc, (t, rec, ms, _) in runs.items():
        rows = torch.stack([torch.stack([x[k] for k in step_mod.METRIC_KEYS])
                            for x in rec["metrics"]]).cpu()
        adam = [v for p in step_mod.param_leaves(t.params) for v in t.optimizer.state[p].values()]
        side[spc] = {"rows": rows, "gen": t._gen.get_state(),
                     "tensors": [x.detach() for x in step_mod.param_leaves(t.params) + adam
                                 + step_mod.param_leaves(t.state)]}
    same_c, worst_c = ms_differ(torch, side[MS_K], side[1])
    (_, _, msg, (g_train, g_val)), (_, _, mss, _) = runs[MS_K], runs[1]
    launches = {spc: {ph: sorted(set(r[1].get(ph, []))) for ph in ("train", "val")}
                for spc, r in runs.items()}

    prof = {spc: ms_profiled(torch, runs[spc][0], train_ds) for spc in (MS_K, 1)}
    n_train = 9
    log(f"[multistep] (c) card: {card}")
    log(f"[multistep] (c) [trainer]'s epoch (MIG bs{BATCH}, D={DIM}, rounds {ROUNDS}, highest, "
        f"{n_train} train and 1 val step, weights {WEIGHTS[:3]}) at steps_per_call {MS_K} "
        f"against 1, {MS_TURNS} epochs each in turns: {len(side[1]['rows'])} metric rows, "
        f"params, Adam's state, BN state and the generator bit for bit {same_c} (max |d| "
        f"{worst_c:.3e}); launches per step {PAR_NAMES} {launches}; captures train "
        f"{g_train.captures} over {len(g_train.layouts)} key(s), val {g_val.captures}")
    log(f"[multistep] (c) ms per train step (the trainer's Net time: plan, prefetch collate, "
        f"steps and the epoch's read-back) at steps_per_call {MS_K}: "
        f"{[round(x, 3) for x in msg]}, median after the first {statistics.median(msg[1:]):.3f}; "
        f"at 1: {[round(x, 3) for x in mss]}, median after the first "
        f"{statistics.median(mss[1:]):.3f}")
    for spc, pr in prof.items():
        log(f"[multistep] (c) one train epoch at steps_per_call {spc} under torch.profiler: "
            f"wall {pr['wall'] / n_train:.3f} ms per step, device busy {pr['busy'] / n_train:.3f} "
            f"ms per step (share {pr['busy'] / pr['wall']:.3f}), host self time of its "
            f"operators {pr['host'] / n_train:.3f} ms per step, "
            f"{pr['events'] / n_train:.1f} device events per step")
    ok &= same_c and g_train.captures == 1 and launches[MS_K] == launches[1]
    out["trainer_ms"] = (statistics.median(msg[1:]), statistics.median(mss[1:]))
    del runs, side

    # ---- (d) the 3-stage CLI at 8 against 1, an lr decay each epoch -------------
    env.clock("[multistep] (d)")
    lines = {}
    lr_step = cli.LR_STEP
    cli.LR_STEP = 1
    try:
        for spc in (str(MS_K), "1"):
            save = os.path.join(MS_DIR, f"cli{spc}")
            tr = cli.main(TRAINER_ARGV + ["--steps_per_call", spc, "--save_dir", save])
            logs = [f for f in os.listdir(tr.log_dir) if f.startswith("log-")]
            with open(os.path.join(tr.log_dir, logs[0])) as f:
                lines[spc] = [re.sub(r"\|Net: .*", "", ln.rstrip("\n")) for ln in f
                              if "| Epoch:" in ln]
    finally:
        cli.LR_STEP = lr_step
    same_d = lines[str(MS_K)] == lines["1"] and len(lines["1"]) == 6
    for ln in lines[str(MS_K)]:
        log(f"[multistep] (d) steps_per_call {MS_K} log: {ln}")
    log(f"[multistep] (d) the 3-stage CLI (lr_step 1: a decay after every epoch, reset by each "
        f"stage; the weights changed twice) at steps_per_call {MS_K} against 1: six epoch "
        f"lines equal but for their time: {same_d}")
    ok &= same_d
    shutil.rmtree(MS_DIR, ignore_errors=True)

    # ---- (e) a captured step made to fail raises ---------------------------------
    # last: a capture that failed may leave its stream's allocations routed to
    # the dead graph's pool; this call's runner and stream are its own
    env.clock("[multistep] (e)")
    cfg = cfg_of(matmul_precision="highest")
    params, state = dg_ae.init_params(cfg, seed=SEED, device=DEVICE)
    opt = step_mod.make_optimizer(params, TRAIN_LR)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    multi = step_mod.make_multi_step(cfg, opt)
    real = step_mod.func_loss

    def read_back(hf, b):   # a host read, which a capture does not allow
        loss = real(hf, b)
        float(loss)
        return loss

    step_mod.func_loss = read_back
    before = step_mod.launch_counts()
    err = None
    try:
        multi(params, state, sb16, gen, WEIGHTS)
    except RuntimeError as e:
        err = e
    finally:
        step_mod.func_loss = real
    after = step_mod.launch_counts()
    # the first step ran eagerly; the failed capture's counts were taken back
    struct = after[(step_mod.struct_kernel, "launches")] - before[(step_mod.struct_kernel,
                                                                   "launches")]
    log(f"[multistep] (e) a step that reads a loss back on the host, in a K = {MS_K} call: "
        f"raised {type(err).__name__ if err else None}: {str(err)[:200]!r}; graphs captured "
        f"{multi.captures}; struct launches {struct} (one eager step's: {2 * ROUNDS})")
    ok &= (err is not None and "capturing" in str(err) and multi.captures == 0
           and struct == 2 * ROUNDS)
    if not ok:
        raise RuntimeError("[multistep]: a graph differs from its eager steps, a grouped epoch "
                           "from the per-step one, or a failed capture did not raise")
    del multi, params, state, opt

    multistep_dp(torch, card, env, args, tcfg, train_ds, val_ds, shards64)
    return out


def multistep_dp(torch, card: str, env, args, tcfg, train_ds, val_ds, shards64) -> None:
    """[multistep] (f) (ROADMAP 1.15): the K-step calls under data
    parallelism on the card, over a one-rank NCCL group (the launch
    variables set in-process, as [parallel] (a)). The [trainer] epoch
    grouped (steps_per_call 8) under the group, the single-device grouped
    epoch and the per-step epoch under the group, a new trainer of each
    kind twice in turns, two epochs each (the first captures):
    everything bit for bit, one capture for train and none for val,
    launches per step; ms per train step; one grouped data-parallel epoch
    under torch.profiler (busy share, and what the all-reduce adds by name
    against the single-device grouped epoch); one K = 4 call of the bs64
    C=2 layout on the step route under the group against the same steps run
    eagerly under it and against the single-device call. [parallel] (c)'s
    gloo processes checked the gloo refusal (``env.gloo``). Raises on any
    failure."""
    import torch.distributed as dist

    from mgvae_tpu_torch.data import batching
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import level_kernel, struct_kernel
    from mgvae_tpu_torch.parallel import collectives
    from mgvae_tpu_torch.parallel import mesh as mesh_mod
    from mgvae_tpu_torch.train import step as step_mod
    from mgvae_tpu_torch.train import trainer as trainer_mod

    log = env.log
    env.clock("[multistep] (f)")
    t_f = time.perf_counter()
    shutil.rmtree(MS_DIR, ignore_errors=True)
    launch_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                  "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    os.environ.update(launch_env)
    try:
        mesh_mod.maybe_initialize_distributed(DEVICE, timeout=120)
        group = dist.group.WORLD
        if dist.get_backend(group) != "nccl":
            raise RuntimeError(f"[multistep] (f): a {dist.get_backend(group)} group, not NCCL")

        def epoch(kind: str, n: int):
            distributed, spc = {"dp8": (True, MS_K), "single8": (False, MS_K),
                                "dp1": (True, 1)}[kind]
            p0, s0 = dg_ae.init_params(tcfg, seed=SEED + 5, device=DEVICE)
            t = trainer_mod.Trainer(args, tcfg, params=p0, state=s0, training_id=f"{kind}_{n}",
                                    save_dir=MS_DIR, batch_size=BATCH, distributed=distributed,
                                    seed=SEED, steps_per_call=spc, device=DEVICE)
            t.set_training_args(rc_prob_func_weight=WEIGHTS[:3], lr=TRAIN_LR)
            if (t.group is not None) != distributed or t.grouped != (spc > 1):
                raise RuntimeError(f"[multistep] (f) {kind}: group {t.group}, {t.step_mode}")
            runners = (t.multi_step, t.multi_eval)
            rec: dict = {}
            for name, ph in (("train_step", "train"), ("eval_step", "val"),
                             ("multi_step", "train"), ("multi_eval", "val")):
                bal_instrument(torch, t, name, ph, rec)
            # the counts from 0 just before the path, read just after; two
            # epochs, the first with the capture, the second replaying
            for m in (level_kernel, struct_kernel):
                m.launches = m.bwd_launches = 0
            level_kernel.lists_launches = level_kernel.step_launches = 0
            level_kernel.step_bwd_launches = level_kernel.giant_launches = 0
            level_kernel.giant_bwd_launches = collectives.launches = 0
            ms = [t.train(1, train_ds, val_ds)["train"]["time"] * 1e3 for _ in range(2)]
            torch.cuda.synchronize()
            totals = par_counts()
            adam = [v for p in step_mod.param_leaves(t.params)
                    for v in t.optimizer.state[p].values()]
            rows = torch.stack([torch.stack([x[k] for k in step_mod.METRIC_KEYS])
                                for x in rec["metrics"]]).cpu()
            return {"t": t, "ms": ms, "totals": totals, "rows": rows, "gen": t._gen.get_state(),
                    "captures": (runners[0].captures, runners[1].captures),
                    "per_step": {ph: sorted(set(rec.get(ph, []))) for ph in ("train", "val")},
                    "tensors": [x.detach() for x in step_mod.param_leaves(t.params) + adam
                                + step_mod.param_leaves(t.state)]}

        order = ("dp8", "single8", "dp1", "dp1", "single8", "dp8")
        seen: dict = {}
        runs = []
        for kind in order:
            seen[kind] = seen.get(kind, 0) + 1
            runs.append((kind, epoch(kind, seen[kind])))
        base = runs[0][1]
        diffs = [ms_differ(torch, base, r) for _, r in runs[1:]]
        same = all(d[0] for d in diffs)
        worst = max(d[1] for d in diffs)
        want = {"train": [(2 * ROUNDS, SBWD_LAUNCHES, 1, 3, 1, 0, 0, 0, 0)],
                "val": [(2 * ROUNDS, 0, 1, 0, 1, 0, 0, 0, 0)]}
        ok_counts, ok_captures, ok_totals = True, True, True
        for kind, r in runs:
            coll = 0 if kind == "single8" else 1
            ok_counts &= r["per_step"] == {ph: [w[0] + (coll,)] for ph, w in want.items()}
            ok_captures &= r["captures"] == ((1, 0) if kind != "dp1" else (0, 0))
            # every kernel of the path (rows 7, 8, 1, 2, the lists) and the
            # all-reduce launched in the run
            ok_totals &= min(r["totals"][:5]) > 0 and (r["totals"][9] > 0) == bool(coll)
        dp8 = [r for kind, r in runs if kind == "dp8"]
        log(f"[multistep] (f) card: {card}")
        log(f"[multistep] (f) [trainer]'s epoch (MIG bs{BATCH}, D={DIM}, rounds {ROUNDS}, "
            f"highest, 9 train and 1 val step, weights {WEIGHTS[:3]}; two epochs a trainer) "
            f"over a one-rank "
            f"{dist.get_backend(group)} group at steps_per_call {MS_K} (grouped), the "
            f"single-device epoch at {MS_K} and the group's per-step epoch, in turns {order}: "
            f"metric rows, params, Adam's state, BN state and the generator bit for bit {same} "
            f"(max |d| {worst:.3e}); captures (train, val) "
            f"{[(k, r['captures']) for k, r in runs]}; launches per step {PAR_NAMES} "
            f"{dp8[0]['per_step']} (the single-device grouped step's and one all-reduce): as "
            f"wanted {ok_counts}; counts of the grouped data-parallel epoch from 0: "
            f"{dp8[0]['totals']}, every kernel of the path and the all-reduce launched "
            f"{ok_totals}")
        log(f"[multistep] (f) ms per train step (the trainer's Net time; a new trainer's "
            f"first epoch with its capture / its second) in turns: "
            + ", ".join(f"{k} {r['ms'][0]:.3f} / {r['ms'][1]:.3f}" for k, r in runs))
        if not (same and ok_counts and ok_captures and ok_totals):
            raise RuntimeError("[multistep] (f): the grouped data-parallel epoch differs from "
                               "the single-device grouped or the per-step data-parallel epoch, "
                               "or its captures or launches do")

        # one grouped data-parallel epoch under torch.profiler, beside the
        # single-device grouped epoch: the busy share, and what the mean adds
        prof = {kind: ms_profiled(torch, r["t"], train_ds) for kind, r in runs[-2:]}
        pd, ps = prof["dp8"], prof["single8"]
        added = {k: (pd["names"].get(k, 0) - ps["names"].get(k, 0)) / 9
                 for k in set(pd["names"]) | set(ps["names"])
                 if pd["names"].get(k, 0) != ps["names"].get(k, 0)}
        comm = {k: v for k, v in added.items() if re.search(r"nccl|memcpy", k, re.I)}
        log(f"[multistep] (f) one grouped data-parallel train epoch under torch.profiler: wall "
            f"{pd['wall'] / 9:.3f} ms per step, device busy {pd['busy'] / 9:.3f} ms per step "
            f"(share {pd['busy'] / pd['wall']:.3f}), host self time {pd['host'] / 9:.3f} ms per "
            f"step, {pd['events'] / 9:.1f} device events per step; the single-device grouped "
            f"epoch: wall {ps['wall'] / 9:.3f}, busy {ps['busy'] / 9:.3f} (share "
            f"{ps['busy'] / ps['wall']:.3f}), {ps['events'] / 9:.1f} events per step")
        log(f"[multistep] (f) device events per train step that the group's mean adds (data "
            f"parallel minus single device, by name): "
            + "; ".join(f"{k[:90]} {v:+.2f}" for k, v in sorted(added.items()))
            + f"; of them the one-rank all-reduce's (an NCCL kernel or a copy): "
            f"{comm or 'none'}")
        del runs, base, dp8, prof

        # the step route under the group: one K = 4 call of the bs64 C=2 layout
        cfg = dg_ae.DGConfig(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS,
                             t_rounds=ROUNDS, layernorm=True, matmul_precision="highest")
        sb = batching.collate_shards(shards64, num_chunks=CHUNKS)
        g = ms_run(torch, cfg, sb, "graph", groups=1, group=group)
        p = ms_run(torch, cfg, sb, "padded", groups=1, group=group)
        one = ms_run(torch, cfg, sb, "graph", groups=1)
        same_p, worst_p = ms_differ(torch, g, p)
        same_1, worst_1 = ms_differ(torch, g, one)
        per = {k: v / g["steps"] for k, v in g["launches"].items()}
        log(f"[multistep] (f) bs64 C=2 on the step route, one K = {MS_ROUTE_K} train and eval "
            f"call under the group (graph: {g['captures']} captures) against the same steps "
            f"run eagerly under it (train_step(group=)'s body over the padded walk): bit for "
            f"bit {same_p} (max |d| {worst_p:.3e}); against the single-device call bit for bit "
            f"{same_1} (max |d| {worst_1:.3e}); launches per step {per}; ms per step, the "
            f"capture included, {g['ms']:.3f} under the group, {one['ms']:.3f} without")
        if not (same_p and same_1 and g["captures"] == 2
                and per.get("level_kernel.step_bwd_launches", 0) > 0
                and per.get("collectives.launches") == 1):
            raise RuntimeError("[multistep] (f): the step-route K-step call under the group "
                               "differs from its eager steps or the single-device call, or "
                               "its launches do")
        del g, p, one, sb
        torch.cuda.empty_cache()
        dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in launch_env:
            os.environ.pop(k, None)
        shutil.rmtree(MS_DIR, ignore_errors=True)

    gloo = env.gloo
    log(f"[multistep] (f) the gloo check, in [parallel] (c)'s two processes sharing the card: "
        f"make_multi_step(group=) raised {[x['refused'][:120] for x in gloo]}, launches "
        f"{[x['counts'] for x in gloo]}, captures {[x['captures'] for x in gloo]}; the trainer "
        f"at steps_per_call {MS_K}: {[x['mode'] for x in gloo]}, calls "
        f"{[x['calls'] for x in gloo]}")
    log(f"[multistep] (f) {time.perf_counter() - t_f:.1f} s")


# [multichip]: the four-card dry run at one rank, its phases and time limit
MC_PHASES = "kbde"
MC_TIMEOUT = 300


def multichip_phase(card: str) -> None:
    """[multichip]: ``examples/dryrun_multichip.py`` at ``--nproc 1`` (its
    launcher builds nothing new: the kernels are built) in a subprocess;
    raises unless it exits 0 with a "held" line of every phase and the
    "every phase held" line."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "mgvae_tpu_torch.examples.dryrun_multichip", "--nproc", "1",
           "--phases", MC_PHASES, "--timeout", str(MC_TIMEOUT - 30)]
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                       timeout=MC_TIMEOUT)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[multichip]")]
    for ln in lines:
        log(ln)
    held = {ph for ph in MC_PHASES
            if any(ln.startswith(f"[multichip] ({ph})") and ": held on ranks [True]" in ln
                   for ln in lines)}
    log(f"[multichip] the dry run at --nproc 1, phases {MC_PHASES}: exit {p.returncode}, "
        f"phases held {sorted(held)}, {time.perf_counter() - t0:.1f} s; card {card}")
    if p.returncode or held != set(MC_PHASES) or "[multichip] (-) every phase held" not in lines:
        raise RuntimeError(f"[multichip] the dry run failed (exit {p.returncode}):\n"
                           f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")



# [gather]: the backward of the model's row gathers (ops/gather, csrc/gather_rows_bwd.cu)
GATHER_SITES = 7        # a train step's gather sites: examples/gather_profile.sites' first seven
GATHER_REPS = 20        # calls a time (CUDA events)
F32_EPS = 2.0 ** -24    # fp32's unit roundoff


def gather_phase(torch, dev, card: str) -> list:
    """[gather]: the backward of the model's row gathers (``ops/gather``,
    ``csrc/gather_rows_bwd.cu``) at the seven sites of a bs16 MIG and of the
    giant XMG train step (the benchmark cells' batches, as
    ``examples/gather_profile`` makes them). At each site, with random
    cotangents: the kernels' gradients (``_backward_cuda``) twice, bit for
    bit, and against the plain version on the CPU
    (``gather_rows_bwd_reference``: index_add_ in index order), each entry
    within its row's entries x 2^-24 x the sum of its terms' |values| (the
    kernels sum a row in fp32 partial sums of ``chunk_len(n)`` sorted
    positions: another order, fp32 rounding only); by CUDA events over
    GATHER_REPS calls the op's backward (its plan and both launches), the
    plain version on the card (index_add_: atomics) and PyTorch's index
    backward of the same gathers (index_put_ with accumulate: a sort and
    ``indexing_backward_kernel``, what autograd of ``table[index]`` runs);
    and the bound of the gradients' bytes. ``gather.bwd_launches``, set to
    0 just before, over the main path's own calls: one K-step train call
    and one eval call on the bs16 circuits stacked MS_K times (2 a site a
    train step, none in eval), and one eager train step on the giant batch.
    Returns the kernels line's two entries."""
    from mgvae_tpu_torch.data import batching
    from mgvae_tpu_torch.examples import gather_profile
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import gather
    from mgvae_tpu_torch.train import step as step_mod

    want_per_step = 2 * GATHER_SITES
    entries = []
    for (tag, (modality, host_batch)), name in zip(gather_profile.batches().items(),
                                                   ("gather_rows_bwd", "gather_rows_bwd_giant")):
        moved = flops = 0
        worst = worst_share = 0.0
        same = True
        ms = {"op": 0.0, "plain": 0.0, "library": 0.0}
        for site, index, shapes in gather_profile.sites(modality, host_batch, dev)[:GATHER_SITES]:
            flat, rows = index.reshape(-1), shapes[0][0]
            gen = torch.Generator(device=dev).manual_seed(SEED + 31)
            grads = [torch.randn((flat.shape[0], math.prod(s[1:])), generator=gen, device=dev)
                     for s in shapes]
            got = gather._backward_cuda(flat, grads, rows)
            same &= all(torch.equal(a, b)
                        for a, b in zip(got, gather._backward_cuda(flat, grads, rows)))
            flat_cpu, site_d = flat.cpu(), 0.0
            count = torch.bincount(flat_cpu, minlength=rows)[:, None]
            for g, a, w in zip(grads, got,
                               gather.gather_rows_bwd_reference(flat_cpu, [g.cpu() for g in grads],
                                                                rows)):
                d = (a.cpu() - w).abs()
                tol = count * F32_EPS * torch.zeros_like(w).index_add_(0, flat_cpu, g.cpu().abs())
                site_d = max(site_d, float(d.max()) if d.numel() else 0.0)
                worst_share = max(worst_share, float((d / tol.clamp(min=1e-300)).max())
                                  if d.numel() else 0.0)
                if not bool((d <= tol).all()):
                    raise RuntimeError(f"[gather] {tag} {site}: the kernels' gradient is "
                                       f"{float((d - tol).max()):.3e} past fp32 rounding of the "
                                       f"plain version")
            calls = {
                "op": lambda: gather._backward_cuda(flat, grads, rows),
                "plain": lambda: [g.new_zeros((rows, g.shape[1])).index_add_(0, flat, g)
                                  for g in grads],
                "library": lambda: [g.new_zeros((rows, g.shape[1])).index_put_((flat,), g,
                                                                                accumulate=True)
                                    for g in grads],
            }
            for k, fn in calls.items():
                fn()
                ms[k] += event_ms(torch, fn, GATHER_REPS)
            worst = max(worst, site_d)
            moved += gather_profile.site_bytes(index, shapes)
            flops += flat.shape[0] * sum(g.shape[1] for g in grads)
            log(f"[gather] {tag} {site}: {flat.shape[0]} entries, {rows} rows, longest run "
                f"{int(count.max()) if count.numel() else 0}: max |d| vs the plain version "
                f"{site_d:.3e}")
        cfg = dg_ae.DGConfig(modality=modality, dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                             layernorm=True, matmul_precision="highest")
        params, state = dg_ae.init_params(cfg, seed=SEED + 13, device=dev)
        opt = step_mod.make_optimizer(params, TRAIN_LR)
        rng = torch.Generator(device=dev).manual_seed(SEED + 13)
        if name == "gather_rows_bwd":   # the main path's K-step calls
            sb = batching.collate_shards([gather_profile.bs16_graphs()] * MS_K)
            multi, multi_eval = step_mod.make_multi_step(cfg, opt), step_mod.make_multi_eval(cfg)
            gather.bwd_launches = 0
            state, _ = multi(params, state, sb, rng, WEIGHTS)
            multi_eval(params, state, sb, rng, WEIGHTS)
            steps, captures = MS_K, multi.captures + multi_eval.captures
        else:                           # one eager train step
            train_step, _ = step_mod.make_train_step(cfg, opt)
            gather.bwd_launches = 0
            train_step(params, state, host_batch, rng, WEIGHTS)
            steps, captures = 1, 0
        torch.cuda.synchronize()
        launches = gather.bwd_launches
        b = bound(moved, flops)
        log(f"[gather] {tag}, the {GATHER_SITES} sites of a train step: kernels twice bit for "
            f"bit {same}; max |d| vs the plain version {worst:.3e}, at most {worst_share:.2e} of "
            f"its fp32 rounding bound; CUDA events over {GATHER_REPS} calls: the op's backward "
            f"(plan and launches) {ms['op']:.4f} ms, the plain version (index_add_) "
            f"{ms['plain']:.4f} ms, PyTorch's index backward {ms['library']:.4f} ms; bound by "
            f"bytes {b['bytes_ms']:.4f} ms; launches over {steps} train steps "
            f"({captures} captures) {launches}, want {want_per_step * steps}; card {card}")
        if not same or launches != want_per_step * steps:
            raise RuntimeError(f"[gather] {tag}: the kernels differ between two calls ({not same})"
                               f" or {launches} launches, not {want_per_step * steps}")
        entries.append({"name": name, "route": "cuda",
                        "source": "mgvae_tpu_torch/csrc/gather_rows_bwd.cu",
                        "replaces": "none: the backward of XLA's gather (mgvae_tpu/models/dg_ae.py)",
                        "launches": launches, "max_abs_err": worst, "ms": ms["op"],
                        "plain_ms": ms["plain"], **b, "library_ms": ms["library"],
                        "launches_per_step": launches / steps, "rounding_share": worst_share})
        del params, state, opt
        torch.cuda.empty_cache()
    return entries


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def torchrun(argv: list, nprocs: int, timeout: float) -> None:
    """Run ``argv`` (a script and its arguments) as ``nprocs`` ranks of
    ``torchrun --standalone`` on this host; torchrun takes a free port and
    stops every rank when one fails. Past ``timeout`` seconds it gets
    SIGTERM, on which it stops its ranks, then SIGKILL. Raises with the end
    of the ranks' output when they failed or ran out of time."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nprocs), *argv]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        text, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.terminate()
        try:
            text, _ = p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        raise RuntimeError(f"{nprocs} ranks of {argv} past {timeout} s:\n{text[-6000:]}")
    if p.returncode:
        raise RuntimeError(f"{nprocs} ranks of {argv}: exit code {p.returncode}\n{text[-6000:]}")


def par_counts():
    """Every kernel's launch count and the collectives', in the order of
    PAR_NAMES."""
    from mgvae_tpu_torch.ops import level_kernel, struct_kernel
    from mgvae_tpu_torch.parallel import collectives

    return (struct_kernel.launches, struct_kernel.bwd_launches, level_kernel.launches,
            level_kernel.bwd_launches, level_kernel.lists_launches, level_kernel.step_launches,
            level_kernel.step_bwd_launches, level_kernel.giant_launches,
            level_kernel.giant_bwd_launches, collectives.launches)


PAR_NAMES = ("(struct, struct bwd, level, level bwd, lists, step, step bwd, giant, giant bwd, "
             "collectives)")


def par_draws(torch, batch, seed: int):
    """Negatives over the batch's valid rows and dropout keep masks, made on
    the CPU from ``seed`` (phase 7's fixed_draws)."""
    from mgvae_tpu_torch.models.dg_ae import DGConfig
    from mgvae_tpu_torch.train import losses as losses_mod

    g = torch.Generator().manual_seed(seed)
    n_real, e_pad, n_pad = (int(batch["n_nodes"]), batch["edge_src"].shape[0],
                            batch["gate"].shape[0])
    neg = tuple(losses_mod.to_valid_runs(t.to(torch.int32), batch)
                for t in torch.randint(0, n_real, (2, e_pad), generator=g))
    dim_mlp = DGConfig(**PAR_CFG).dim_mlp
    return neg, [torch.rand(n_pad, dim_mlp, generator=g) < 0.8 for _ in range(2)]


def par_stepper(torch, make, cfg, batch, draws, where, weights):
    """(run, leaves): ``run()`` takes one step of ``make(optimizer)`` (SGD at
    lr 0, so that the params stay and every step reads the same) on the
    batch with the draws and loss weights; the gradients are the leaves'
    ``.grad`` after it."""
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.train.step import param_leaves

    params, state = dg_ae.init_params(cfg, seed=SEED + 3, device=where)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    step = make(torch.optim.SGD(leaves, lr=0.0))
    neg = tuple(t.to(where) for t in draws[0])
    keep = [k.to(where) for k in draws[1]]
    return (lambda: step(params, state, batch, None, weights, neg_edges=neg, drop_keep=keep),
            leaves)


def par_grads(leaves):
    return [None if t.grad is None else t.grad.detach().clone() for t in leaves]


def par_held(tag: str, got, want, phase: str = "[parallel]") -> float:
    """The worst leaf's max |d| / (GRAD_TOL * max(its scale, 1)); raises past 1."""
    worst = 0.0
    for i, (a, c) in enumerate(zip(got, want, strict=True)):
        if (a is None) != (c is None):
            raise RuntimeError(f"{phase} {tag}: leaf {i} has a gradient on one side only")
        if c is None:
            continue
        a, c = a.float().cpu(), c.float().cpu()
        if not bool(a.isfinite().all()):
            raise RuntimeError(f"{phase} {tag}: non-finite gradient, leaf {i}")
        worst = max(worst, (a - c).abs().max().item() / (GRAD_TOL * max(c.abs().max().item(),
                                                                         1.0)))
    if not worst <= 1.0:
        raise RuntimeError(f"{phase} {tag}: a gradient leaf is past {GRAD_TOL} * "
                           f"max(scale, 1): {worst:.3f} of it")
    return worst


def ms_gloo_check(torch, cfg, dev, group, data: dict, outdir: str) -> dict:
    """[multistep] (f) in one of [parallel] (c)'s gloo processes on the
    card: ``make_multi_step(group=)`` must raise before any step runs, and
    the trainer at steps_per_call MS_K must step singly. Returns what each
    did: the error, the launches in the call, its captures, the trainer's
    step mode and its calls."""
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.train import step as step_mod
    from mgvae_tpu_torch.train.trainer import Trainer

    params, state = dg_ae.init_params(cfg, seed=SEED + 3, device=dev)
    multi = step_mod.make_multi_step(cfg, step_mod.make_optimizer(params, TRAIN_LR),
                                     group=group)
    before = par_counts()
    try:
        multi(params, state, data["ms_group"], torch.Generator(device=dev).manual_seed(SEED),
              WEIGHTS)
        refused = "not refused"
    except ValueError as e:
        refused = f"ValueError: {e}"
    counts = tuple(a - b for a, b in zip(par_counts(), before))
    tr = Trainer(types.SimpleNamespace(model="DG_AE"), cfg, training_id="gloo",
                 save_dir=os.path.join(outdir, "gloo"), batch_size=2, distributed=True,
                 seed=SEED, steps_per_call=MS_K, device=dev)
    calls = {"group": 0, "single": 0}
    inner_multi, inner_single = tr.multi_step, tr.train_step

    def spy_multi(*a, **kw):
        calls["group"] += 1
        return inner_multi(*a, **kw)

    def spy_single(*a, **kw):
        calls["single"] += 1
        return inner_single(*a, **kw)

    tr.multi_step, tr.train_step = spy_multi, spy_single
    tr.train(1, data["ms_graphs"], [])
    torch.cuda.synchronize()
    return {"refused": refused, "counts": counts, "captures": multi.captures,
            "mode": tr.step_mode, "grouped": tr.grouped, "calls": calls}


def parallel_worker(inp: str, outdir: str) -> None:
    """[parallel] (c): one of two processes that share the card over gloo
    (``python3 chip_smoke.py --parallel-worker <in> <out>``, started by
    ``parallel_phase``): a dp = 2 step on its bs16 shard, then a dp = 1 x
    mp = 2 step as member ``rank`` of the bs16 batch's dst-complete tables,
    each once for the gradients and PAR_TIMED times for the clock."""
    import torch
    import torch.distributed as dist

    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.parallel import mesh as mesh_mod
    from mgvae_tpu_torch.parallel import sharded
    from mgvae_tpu_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    rank, world = mesh_mod.maybe_initialize_distributed(dev, backend="gloo", timeout=120)
    # does this torch's gloo take the card's tensors for all_gather? (the
    # collectives hand it the card's tensors)
    x = torch.full((4,), float(rank), device=dev)
    parts = [torch.empty_like(x) for _ in range(world)]
    try:
        dist.all_gather(parts, x)
        probe = f"yes ({[float(p[0]) for p in parts]})"
    except (RuntimeError, ValueError) as e:
        probe = f"no ({type(e).__name__}: {str(e).splitlines()[0][:160]})"
    data = torch.load(inp, weights_only=False)
    cfg = dg_ae.DGConfig(**PAR_CFG)
    sync = torch.cuda.synchronize
    out = {"probe": probe, "torch": torch.__version__}

    dp_mesh = mesh_mod.make_mesh(world, 1)
    run, leaves = par_stepper(
        torch, lambda opt: step_mod.make_train_step(cfg, opt, group=dp_mesh.dp_group)[0], cfg,
        data["dp"][rank], data["dp_draws"][rank], dev, WEIGHTS)
    run()
    out["dp_grads"] = par_grads(leaves)
    out["dp_ms"] = median_wall(run, PAR_TIMED, sync) * 1e3

    out["ms_gloo"] = ms_gloo_check(torch, cfg, dev, dp_mesh.dp_group, data, outdir)

    mp_mesh = mesh_mod.make_mesh(1, world)
    run, leaves = par_stepper(
        torch, lambda opt: sharded.make_sharded_train_step(cfg, opt, mp_mesh), cfg,
        data["mp"], data["mp_draws"], dev, SMOOTH_WEIGHTS)
    sync()
    before = par_counts()
    run()
    sync()
    out["mp_counts"] = tuple(a - b for a, b in zip(par_counts(), before))
    out["mp_grads"] = par_grads(leaves)
    out["mp_ms"] = median_wall(run, PAR_TIMED, sync) * 1e3
    out["collectives_backend"] = dist.get_backend(mp_mesh.mp_group)
    torch.save(out, os.path.join(outdir, f"{rank}.pt"))
    dist.destroy_process_group()


def parallel_phase(torch, dev, card: str, env) -> dict:
    """[parallel] (ROADMAP 1.7): (a) the [trainer] epoch data-parallel over a
    one-rank NCCL group, bit for bit against the single-device epoch; (b)
    the within-level sharded train step at mp = 1 by the dst-complete kernel
    route (kernels 5 and 6 per real level) on the bs16 and the giant batch,
    against the single-device step (kernels 1/2 and 3/4), and kernels 5 and
    6 on member tables (mp = 1 and each member at mp = 2) against their
    plain versions; (c) two processes sharing the card over gloo: dp = 2
    and dp = 1 x mp = 2. ``env``: main's log, held, written_rows, step_bound,
    requests, giant_batch and clock. Returns the numbers of the kernels line."""
    import torch.distributed as dist

    from mgvae_tpu_torch import cli, collate
    from mgvae_tpu_torch.config import get_parse_args
    from mgvae_tpu_torch.data.batching import collate_shards, shard_levels_by_dst
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import level_kernel
    from mgvae_tpu_torch.ops.precision import matmul_precision as precision_scope
    from mgvae_tpu_torch.parallel import mesh as mesh_mod
    from mgvae_tpu_torch.parallel import sharded
    from mgvae_tpu_torch.train import step as step_mod
    from mgvae_tpu_torch.train import trainer as trainer_mod

    log, sync = env.log, torch.cuda.synchronize
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    os.makedirs(PAR_DIR)
    step_names = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak", "d_hf")

    # ---- (a) the [trainer] epoch, data-parallel over one rank (NCCL) --------
    args = get_parse_args(TRAINER_ARGV + ["--save_dir", PAR_DIR])
    cfg_t = cli.model_config(args)
    train_ds, val_ds = cli.load_dataset(args)

    def epoch(distributed: bool, tid: str):
        # step by step on both sides (the data-parallel trainer always is):
        # the all-reduce's cost beside the same steps
        tr = trainer_mod.Trainer(args, cfg_t, training_id=tid, save_dir=PAR_DIR,
                                 batch_size=args.batch_size, distributed=distributed,
                                 seed=args.seed, steps_per_call=1, device=DEVICE)
        tr.set_training_args(rc_prob_func_weight=WEIGHTS[:3], lr=TRAIN_LR)
        rows, per_step = [], {"train": [], "val": []}
        for phase, name in (("train", "train_step"), ("val", "eval_step")):
            def recorded(*a, _fn=getattr(tr, name), _phase=phase, **kw):
                before = par_counts()
                res = _fn(*a, **kw)
                per_step[_phase].append(tuple(x - y for x, y in zip(par_counts(), before)))
                if _phase == "train":
                    rows.append(torch.stack([res[1][k] for k in PAR_KEYS]))
                return res
            setattr(tr, name, recorded)
        m = tr.train(1, train_ds, val_ds)
        sync()
        opt = [t for s in tr.optimizer.state_dict()["state"].values() for t in s.values()]
        return {"rows": torch.stack(rows).cpu(), "per_step": per_step,
                "ms": m["train"]["time"] * 1e3, "group": tr.group,
                "leaves": step_mod.param_leaves(tr.params) + step_mod.param_leaves(tr.state)
                + opt}

    # four epochs in turns, single, dp, dp, single: the first of each kind
    # warms cuBLAS and NCCL up
    env.clock("[parallel] (a)")
    launch_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                  "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    os.environ.update(launch_env)
    try:
        single = [epoch(False, "single")]
        dp = [epoch(True, "dp"), epoch(True, "dp2")]
        single.append(epoch(False, "single2"))
        backend = dist.get_backend()
        if (dp[0]["group"] is None or single[1]["group"] is not None
                or backend != ("nccl" if dev.type == "cuda" else "gloo")):
            raise RuntimeError(f"[parallel] (a): the data-parallel trainer did not take the "
                               f"one-rank {backend} group, or the single-device one did")
        same = all(torch.equal(x["rows"], single[0]["rows"])
                   and len(x["leaves"]) == len(single[0]["leaves"])
                   and all(torch.equal(a, c) for a, c in zip(x["leaves"], single[0]["leaves"]))
                   for x in dp + single[1:])
        want_train = (2 * ROUNDS, SBWD_LAUNCHES, 1, 3, 1, 0, 0, 0, 0)
        want_val = (2 * ROUNDS, 0, 1, 0, 1, 0, 0, 0, 0)
        ok_counts = all(
            s == want + (coll,)
            for x, coll in ((dp[0], 1), (dp[1], 1), (single[0], 0), (single[1], 0))
            for phase, want in (("train", want_train), ("val", want_val))
            for s in x["per_step"][phase])
        n_train = len(single[0]["per_step"]["train"])
        log(f"[parallel] (a) the [trainer] epoch (MIG bs16, D={DIM}, rounds {ROUNDS}, "
            f"{n_train} train + {len(single[0]['per_step']['val'])} val steps, weights "
            f"{WEIGHTS[:3]}, lr {TRAIN_LR}) data-parallel over a one-rank {backend} group, "
            f"twice, against the single-device epoch, twice: per-step losses and metrics, "
            f"params, BN state and Adam state bit for bit the same: {same}; launches per train "
            f"step {PAR_NAMES} {dp[0]['per_step']['train'][0]} (the single-device step's "
            f"{single[0]['per_step']['train'][0]} and one all-reduce), per val step "
            f"{dp[0]['per_step']['val'][0]}: as wanted {ok_counts}")
        log(f"[parallel] (a) ms per train step (the trainer's epoch average; in turns single, "
            f"dp, dp, single, the first of each kind with its warm-up): {single[0]['ms']:.3f}, "
            f"{dp[0]['ms']:.3f}, {dp[1]['ms']:.3f}, {single[1]['ms']:.3f}; card {card}")
        if not (same and ok_counts):
            raise RuntimeError("[parallel] (a): the data-parallel epoch over one rank differs "
                               "from the single-device epoch, or its launches do")
        out = {"a_ms": [x["ms"] for x in single[:1] + dp + single[1:]]}
        del dp, single

        # ---- (b) the sharded train step at mp = 1 by the kernel route ----------
        env.clock("[parallel] (b)")
        mesh11 = mesh_mod.make_mesh(1, 1)
        cfg = dg_ae.DGConfig(**PAR_CFG)
        base = collate(env.requests[0], mp=2)        # (c)'s mp = 2 collation, one batch for both
        bs16_draws = par_draws(torch, base, SEED + 11)
        cases = {"bs16": (shard_levels_by_dst(base, 1), bs16_draws),
                 "giant": (shard_levels_by_dst(env.giant_batch, 1),
                           par_draws(torch, env.giant_batch, SEED + 12))}
        out["mp_launches"] = [0, 0]
        timing = {}
        for tag, (batch, draws) in cases.items():
            n_lv = dg_ae.num_levels(batch)
            if sharded.route_of(batch, cfg, 1) != "kernel":
                raise RuntimeError(f"[parallel] (b) {tag}: the batch did not select the "
                                   "dst-complete kernel route")
            run_mp, leaves_mp = par_stepper(
                torch, lambda opt: sharded.make_sharded_train_step(cfg, opt, mesh11),
                cfg, batch, draws, dev, SMOOTH_WEIGHTS)
            run_1, leaves_1 = par_stepper(
                torch, lambda opt: step_mod.make_train_step(cfg, opt)[0], cfg, batch, draws,
                dev, SMOOTH_WEIGHTS)
            sync()
            before = par_counts()
            run_mp()
            sync()
            got = tuple(a - b for a, b in zip(par_counts(), before))
            out["mp_launches"][0] += got[5]
            out["mp_launches"][1] += got[6]
            g_mp = par_grads(leaves_mp)
            run_1()
            g_1 = par_grads(leaves_1)
            if tag == "bs16":
                out["bs16_grads"] = g_mp
            worst = par_held(f"(b) {tag}", g_mp, g_1)
            want = (0, 0, 0, 0, 1, n_lv, 3 * n_lv, 0, 0, 2 * (4 * ROUNDS + n_lv) + 1)
            t1 = [median_wall(run_1, PAR_TIMED, sync)]
            tm = [median_wall(run_mp, PAR_TIMED, sync), median_wall(run_mp, PAR_TIMED, sync)]
            t1.append(median_wall(run_1, PAR_TIMED, sync))
            timing[tag] = (t1, tm)
            log(f"[parallel] (b) {tag} (N={batch['gate'].shape[0]}, {n_lv} real levels, member "
                f"tables Ep_m={batch['mp_lv_edge_src'].shape[-1]} "
                f"Np_m={batch['mp_lv_nodes'].shape[-1]}): one sharded step at mp = 1 by the "
                f"kernel route, launches {PAR_NAMES} {got} (want {want}: kernel 5 once and "
                f"kernel 6's three launches per real level, the struct towers plain); weights "
                f"{SMOOTH_WEIGHTS} (SMOOTH_WEIGHTS' reason: the route sums the struct towers "
                f"in another order); each gradient leaf against the single-device step's (kernels "
                f"{'1/2' if tag == 'bs16' else '3/4'} and 7/8): worst {worst:.3f} of "
                f"{GRAD_TOL} * max(scale, 1)")
            log(f"[parallel] (b) {tag} ms per step (synchronised, medians of {PAR_TIMED}, in "
                f"turns single, mp, mp, single): {t1[0] * 1e3:.3f}, {tm[0] * 1e3:.3f}, "
                f"{tm[1] * 1e3:.3f}, {t1[1] * 1e3:.3f}; card {card}")
            if got != want:
                raise RuntimeError(f"[parallel] (b) {tag}: launches {got} != {want}")
            if tag == "giant":
                profile_train(torch, run_mp, card, "[parallel] (b) the sharded giant step at "
                              "mp = 1", steps=2, rows=12, warm=0)
            del run_mp, run_1, leaves_mp, leaves_1
        out["timing"] = timing

        # the same step at D = 256, past the kernels' width: the batch keeps its
        # dst-complete tables and the edge-split route (plain torch) takes it
        cfg_w = dg_ae.DGConfig(**dict(PAR_CFG, dim_hidden=PAR_WIDE_DIM))
        batch, draws = cases["bs16"]
        route = sharded.route_of(batch, cfg_w, 1)
        run_mp, leaves_mp = par_stepper(
            torch, lambda opt: sharded.make_sharded_train_step(cfg_w, opt, mesh11), cfg_w,
            batch, draws, dev, SMOOTH_WEIGHTS)
        run_1, leaves_1 = par_stepper(
            torch, lambda opt: step_mod.make_train_step(cfg_w, opt)[0], cfg_w, batch, draws,
            dev, SMOOTH_WEIGHTS)
        sync()
        before = par_counts()
        run_mp()
        sync()
        got = tuple(a - b for a, b in zip(par_counts(), before))
        g_mp = par_grads(leaves_mp)
        run_1()
        worst = par_held("(b) wide", g_mp, par_grads(leaves_1))
        tw = (median_wall(run_1, PAR_TIMED, sync), median_wall(run_mp, PAR_TIMED, sync))
        log(f"[parallel] (b) wide: the bs16 step at D = {PAR_WIDE_DIM} at mp = 1 by the {route} "
            f"route (the batch's dst-complete tables kept), launches {PAR_NAMES} {got} (want "
            f"no kernel launch); each gradient leaf against the single-device step's: worst "
            f"{worst:.3f} of {GRAD_TOL} * max(scale, 1); ms per step (medians of {PAR_TIMED}, "
            f"single then sharded) {tw[0] * 1e3:.3f}, {tw[1] * 1e3:.3f}; card {card}")
        if route != "edge" or any(got[:9]):
            raise RuntimeError(f"[parallel] (b) wide: route {route}, launches {got}: past the "
                               "kernels' width the edge-split route launches no kernel")
        out["wide_ms"] = tw
        del run_mp, run_1, leaves_mp, leaves_1

        env.clock("[parallel] kernels 5 and 6 on member tables")

        # kernels 5 and 6 on member tables against their plain versions
        params, _ = dg_ae.init_params(cfg, seed=SEED + 3, device=dev)
        mp2 = shard_levels_by_dst(base, 2)
        fwd_err, bwd_err, rep = [0.0, 0.0, 0.0], 0.0, ""
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        timed = None
        for tag, batch, mp in (("bs16 mp=1", cases["bs16"][0], 1), ("bs16 mp=2", mp2, 2),
                               ("giant mp=1", cases["giant"][0], 1)):
            n_lv = dg_ae.num_levels(batch)
            with torch.no_grad(), precision_scope("highest"):
                hs, hf, _ = dg_ae.forward(params, batch, cfg)
                bd = dg_ae.batch_to_device(batch, dev)
                expert = cfg.expert_of_gate(dev)[bd["gate"].long()]
                for m in range(mp):
                    b = sharded.member_to_device(sharded.member_slices(batch, m, mp), dev,
                                                 "kernel")
                    a = sharded.member_level_inputs(params, b, cfg, hs, expert)
                    rows = []
                    for lv in range(n_lv):
                        sa = (hf, a[0][lv], a[1][lv], a[2][lv], a[3][lv], a[5][lv], a[6][lv],
                              *a[7:])
                        out_k = level_kernel._step_forward_cuda(sa, residuals=True)
                        out_k = (out_k[0], *env.written_rows(sa[3], sa[4], sa[5], 1, out_k[1],
                                                             out_k[2]))
                        out_r = level_kernel.level_step_reference(*sa, with_residuals=True)
                        for j, (x, r) in enumerate(zip(out_k, out_r)):
                            if not torch.isfinite(x).all():
                                raise RuntimeError(f"[parallel] {tag}: non-finite output")
                            fwd_err[j] = max(fwd_err[j], (x - r).abs().max().item())
                        g = torch.randn(sa[5].shape[0], DIM, device=dev, generator=gen)
                        grads_k = level_kernel._step_backward_cuda(g, out_k[1], out_k[2], sa[1:],
                                                                   hf.shape[0])
                        grads_r = level_kernel.level_step_bwd_reference(
                            g, out_k[1], out_k[2], *sa[1:9], sa[10], sa[11],
                            num_nodes=hf.shape[0])
                        report, worst = env.held(f"parallel {tag}", step_names, grads_k, grads_r)
                        if worst >= bwd_err:
                            bwd_err, rep = worst, f"{tag} level {lv}: {report}"
                        rows.append((sa, g))
                    if tag.startswith("giant"):
                        timed = (rows, a)
        log(f"[parallel] kernels 5 and 6 on member tables (bs16 at mp = 1 and each member at "
            f"mp = 2, the giant batch at mp = 1; every real level) against level_step_reference "
            f"/ level_step_bwd_reference: forward max|d| h_new/res_e/res_n {fwd_err[0]:.3e}/"
            f"{fwd_err[1]:.3e}/{fwd_err[2]:.3e} (tol {KERNEL_TOL}); backward, worst: {rep}")
        if not max(fwd_err) <= KERNEL_TOL:
            raise RuntimeError(f"[parallel] kernel 5 disagrees with its plain version on member "
                               f"tables: {fwd_err}")
        out["fwd_err"], out["bwd_err"] = max(fwd_err), bwd_err

        # their times: one pass over the giant member tables' real levels, the
        # lists and the expert-major weights built once, as the route builds them
        rows, a = timed
        lists, packed = dg_ae.kernel_inputs(a)
        lrows = [type(lists)(*r) for r in zip(*(t[:, None].unbind(0) for t in lists))]
        packed = level_kernel.repack_expert_major(a[7], a[8], cfg.num_experts, backward=True)
        N = rows[0][0][0].shape[0]
        with torch.no_grad():
            res = [level_kernel._step_forward_cuda(sa, True, lrows[i], packed)
                   for i, (sa, _) in enumerate(rows)]
            kf = lambda: [level_kernel._step_forward_cuda(sa, True, lrows[i], packed)
                          for i, (sa, _) in enumerate(rows)]
            pf = lambda: [level_kernel.level_step_reference(*sa, with_residuals=True)
                          for sa, _ in rows]
            kb = lambda: [level_kernel._step_backward_cuda(g, r[1], r[2], sa[1:], N, lrows[i],
                                                           packed)
                          for i, ((sa, g), r) in enumerate(zip(rows, res))]
            pb = lambda: [level_kernel.level_step_bwd_reference(g, r[1], r[2], *sa[1:9], sa[10],
                                                                sa[11], num_nodes=N)
                          for (sa, g), r in zip(rows, res)]
            for f in (kf, pf, kb, pb):
                f()
            ms = {"kf": [event_ms(torch, kf, 3)], "pf": [event_ms(torch, pf, 1)],
                  "kb": [event_ms(torch, kb, 3)], "pb": [event_ms(torch, pb, 1)]}
            ms["pb"].append(event_ms(torch, pb, 1))
            ms["kb"].append(event_ms(torch, kb, 3))
            ms["pf"].append(event_ms(torch, pf, 1))
            ms["kf"].append(event_ms(torch, kf, 3))
        out["ms"] = {k: sum(v) / 2 for k, v in ms.items()}
        out["levels"] = len(rows)

        def summed(backward):
            bs = [env.step_bound(sa, not backward, backward=backward) for sa, _ in rows]
            by_b, by_o = sum(x["bytes_ms"] for x in bs), sum(x["operations_ms"] for x in bs)
            return {"bound_ms": max(by_b, by_o), "bound_by": "bytes" if by_b >= by_o
                    else "operations", "bytes_ms": by_b, "operations_ms": by_o}

        out["bounds"] = {"level_step_mp": summed(False), "level_step_bwd_mp": summed(True)}
        log(f"[parallel] kernels 5 and 6 on the giant member tables, one pass over its "
            f"{len(rows)} real levels (CUDA events, in turns): forward with residuals "
            f"{ms['kf'][0]:.3f}/{ms['kf'][1]:.3f} ms, plain {ms['pf'][0]:.3f}/{ms['pf'][1]:.3f} "
            f"ms; backward {ms['kb'][0]:.3f}/{ms['kb'][1]:.3f} ms, plain {ms['pb'][0]:.3f}/"
            f"{ms['pb'][1]:.3f} ms; bounds {out['bounds']['level_step_mp']['bound_ms']:.4f} / "
            f"{out['bounds']['level_step_bwd_mp']['bound_ms']:.4f} ms; card {card}")
        del timed, rows, res, lists, lrows, packed, a
        dist.destroy_process_group()
    finally:
        for k in launch_env:
            os.environ.pop(k, None)

    # ---- (c) two processes sharing the card over gloo -----------------------
    env.clock("[parallel] (c)")
    dp_batches = [collate(r) for r in env.requests[:2]]
    dp_draws = [par_draws(torch, b, SEED + 20 + d) for d, b in enumerate(dp_batches)]
    inp = os.path.join(PAR_DIR, "parallel_in.pt")
    # [multistep] (f)'s gloo check: a K = 2 group of the first two requests, and
    # 32 graphs, 8 trainer steps of 2 x bs2
    ms_graphs = list(env.requests[0]) + list(env.requests[1])
    torch.save({"dp": dp_batches, "dp_draws": dp_draws, "mp": mp2, "mp_draws": bs16_draws,
                "ms_group": collate_shards([env.requests[0], env.requests[1]]),
                "ms_graphs": ms_graphs}, inp)
    t0 = time.perf_counter()
    torchrun([os.path.abspath(__file__), "--parallel-worker", inp, PAR_DIR], 2,
             PAR_WORKER_TIMEOUT)
    wall = time.perf_counter() - t0
    res = [torch.load(os.path.join(PAR_DIR, f"{r}.pt"), weights_only=False) for r in range(2)]
    # dp = 2 against one process computing both shards and averaging them
    ref = []
    for b, d in zip(dp_batches, dp_draws):
        run, leaves = par_stepper(torch, lambda opt: step_mod.make_train_step(cfg, opt)[0], cfg,
                                  b, d, dev, WEIGHTS)
        run()
        ref.append(par_grads(leaves))
    mean = [None if a is None else (a + c) / 2 for a, c in zip(*ref)]
    w_dp = max(par_held(f"(c) dp=2 rank {r}", x["dp_grads"], mean) for r, x in enumerate(res))
    w_mp = max(par_held(f"(c) mp=2 member {r}", x["mp_grads"], out["bs16_grads"])
               for r, x in enumerate(res))
    n_lv = dg_ae.num_levels(base)
    want = (0, 0, 0, 0, 1, n_lv, 3 * n_lv, 0, 0, 2 * (4 * ROUNDS + n_lv) + 1)
    counts = [x["mp_counts"] for x in res]
    log(f"[parallel] (c) two processes sharing the card over gloo ({wall:.1f} s with their "
        f"start; torch {res[0]['torch']}; gloo takes the card's tensors for all_gather: "
        f"{res[0]['probe']}): dp = 2, one bs16 shard "
        f"each, averaged gradients against one process averaging both shards' own: worst "
        f"{w_dp:.3f} of the bound; dp = 1 x mp = 2 on the bs16 batch's dst-complete tables, "
        f"launches per member {PAR_NAMES} {counts} (want {want}), gradients against (b)'s "
        f"bs16 step: worst {w_mp:.3f} of the bound; ms per step (medians of {PAR_TIMED}, each "
        f"process's): dp = 2 {[round(x['dp_ms'], 3) for x in res]}, mp = 2 "
        f"{[round(x['mp_ms'], 3) for x in res]}; card {card}")
    if any(c != want for c in counts):
        raise RuntimeError(f"[parallel] (c): member launches {counts} != {want}")
    gloo = [x["ms_gloo"] for x in res]
    n_steps = len(ms_graphs) // (2 * 2)
    log(f"[parallel] (c) [multistep] (f)'s gloo check: make_multi_step(group=) on the card "
        f"{[x['refused'][:160] for x in gloo]}; launches in the call {PAR_NAMES} "
        f"{[x['counts'] for x in gloo]}; the trainer at steps_per_call {MS_K}: "
        f"{[x['mode'] for x in gloo]}, calls {[x['calls'] for x in gloo]}")
    if not all(x["refused"].startswith("ValueError") and "NCCL" in x["refused"]
               and not any(x["counts"]) and x["captures"] == 0 and not x["grouped"]
               and x["calls"] == {"group": 0, "single": n_steps} for x in gloo):
        raise RuntimeError("[parallel] (c): the K-step call did not refuse the gloo group "
                           "before any step, or the trainer grouped its steps over gloo")
    out["gloo"] = gloo
    out["c"] = {"dp_ms": [x["dp_ms"] for x in res], "mp_ms": [x["mp_ms"] for x in res]}
    shutil.rmtree(PAR_DIR)
    del out["bs16_grads"]
    return out


# [balancer]: the multi-task trainers and the rest of ROADMAP 1.9 on the card
BAL_DIR = os.path.join("exp", "chip_smoke_balancer")
# launches per Balancer or GradNorm train step, in PAR_NAMES' order: one
# forward (struct 2R, the fused level scan, the lists) and three backwards
# from its residuals, the struct backward once per task (3 x (4R + 1)) and
# the level backward for prob and func (2 x 3: recon does not reach hf)
BAL_STEP_LAUNCHES = (2 * ROUNDS, 3 * SBWD_LAUNCHES, 1, 2 * 3, 1, 0, 0, 0, 0, 0)
BAL_LINE = (r"^balancer\| Epoch: 0/1 \|Recon: \d+\.\d{4} \|Prob: \d+\.\d{4} \|Func: \d+\.\d{4}"
            r"\|Net: \d+\.\d{2}s$")
GN_LINE = (r"^gradnorm\| Epoch: 0/1 \|Recon: \d+\.\d{4} \|Prob: \d+\.\d{4} \|Func: \d+\.\d{4} "
           r"\|W: \[\d+\.\d{3} \d+\.\d{3} \d+\.\d{3}\] \|Lgrad: \d+\.\d{4}\|Net: \d+\.\d{2}s$")
# the kernels of rows 1, 2 (its sweep), 7 and 8 and the lists kernel, as the
# capture names them
TRACE_KERNELS = ("level_scan_kernel", "level_scan_bwd_kernel", "struct_fwd_kernel",
                 "struct_bwd_row_kernel", "struct_grad_partial_kernel", "struct_grad_sum_kernel",
                 "level_lists_kernel")
TRACE_CAT = "kernel"           # the capture's category of device kernels
# CUDA-event calls per timing of the re-entered backwards: the kernels',
# and their plain versions' (autograd through the plain forward, ~100x slower)
BAL_TIMED, BAL_TIMED_PLAIN = 20, 3


def bal_separate(torch, cfg, params, state, batch, neg, keep):
    """Each task's gradient (recon, prob, func) from a forward and a
    backward of its own, with the given negatives and dropout masks."""
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.train import losses
    from mgvae_tpu_torch.train.step import param_leaves

    leaves = param_leaves(params)
    out = []
    for t in range(3):
        b = dg_ae.batch_to_device(batch, leaves[0].device)
        hs, hf, _ = dg_ae.forward_device(params, b, cfg, dg_ae.level_counts(batch))
        loss = (losses.recon_loss(params, hs, b, neg_edges=neg)[0] if t == 0
                else losses.prob_loss(params, state, hf, b, True, drop_keep=keep)[0] if t == 1
                else losses.func_loss(hf, b))
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.append([torch.zeros_like(x) if y is None else y for x, y in zip(leaves, g)])
    return out


def bal_instrument(torch, tr, attr: str, phase: str, rec: dict) -> None:
    """Wrap the trainer's step ``attr`` so that each call records its
    launches (``par_counts``) and its metrics under ``phase``."""
    fn = getattr(tr, attr)

    def call(*a, **kw):
        before = par_counts()
        res = fn(*a, **kw)
        delta = tuple(x - y for x, y in zip(par_counts(), before))
        out = res if isinstance(res, dict) else res[-1]
        if isinstance(out, dict):
            rec.setdefault(phase, []).append(delta)
            rec.setdefault("metrics", []).append(out)
        else:   # a K-step call's [K, 9] rows (train.step.make_multi_step)
            from mgvae_tpu_torch.train.step import METRIC_KEYS
            k = out.shape[0]
            rec.setdefault(phase, []).extend([tuple(x // k for x in delta)] * k)
            rec.setdefault("metrics", []).extend(dict(zip(METRIC_KEYS, r)) for r in out)
        return res

    setattr(tr, attr, call)


def collate_probe() -> None:
    """``--collate-probe``: the [trainer] epoch's collation alone on the host
    (its 9 bs16 train batches at the epoch's running-max dims), ms per batch
    as the median of 5 passes, as one JSON line; the caller sets
    MGVAE_NO_MALLOC_TUNE or not."""
    from mgvae_tpu_torch import cli
    from mgvae_tpu_torch.data import batching
    from mgvae_tpu_torch.utils import hostmem

    train_ds, _ = cli.load_dataset(cli.get_parse_args(TRAINER_ARGV))
    idx = np.random.default_rng(SEED + 2).permutation(len(train_ds))
    shards = [[train_ds[i] for i in idx[s * BATCH:(s + 1) * BATCH]]
              for s in range(len(idx) // BATCH)]
    dims: dict = {}
    for s in shards:
        for k, v in batching.natural_dims(s).items():
            dims[k] = max(dims.get(k, 0), v)
    passes = []
    for _ in range(5):
        t0 = time.perf_counter()
        for s in shards:
            batching.collate(s, dims=dims)
        passes.append((time.perf_counter() - t0) / len(shards) * 1e3)
    print(json.dumps({"collate_ms": statistics.median(passes), "passes": passes,
                      "tuned": hostmem._done, "batches": len(shards)}), flush=True)


def balancer_phase(torch, dev, card: str, env) -> dict:
    """[balancer] (ROADMAP 1.9): (a) one epoch each of BalancerTrainer,
    GradNormTrainer and EarlyTrainer(patience=1) in [trainer]'s
    configuration, with launches per step, epoch lines, task weights, ms per
    step beside the plain trainer's in turns and the peak memory; (b) the
    three per-task gradients of one forward bit for bit against three
    separate passes on the bs16, bs64 C=2 (step route) and giant batches,
    and one Balancer step card against CPU; (c) the Balancer epoch over a
    one-rank NCCL group bit for bit against the single-device one; (d)
    Trainer(trace_dir=) over one [trainer] epoch; (e) the large-batch
    example; (f) the re-entered backwards (kernels 8 and 2) against their
    plain versions, the residuals untouched, by CUDA events; (g) the host
    collation with and without the allocator tuning. ``env``: main's log,
    clock, held, written_rows, struct_bound, level_bound, card_vs_cpu_prob,
    requests, chunked and giant_batch. Returns the kernels line's numbers."""
    import glob

    import torch.distributed as dist

    from mgvae_tpu_torch import cli, collate
    from mgvae_tpu_torch.config import get_parse_args
    from mgvae_tpu_torch.examples import large_batch_training
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import level_kernel, struct_kernel
    from mgvae_tpu_torch.ops.precision import matmul_precision as precision_scope
    from mgvae_tpu_torch.ops.struct_kernel import (struct_inputs, struct_tables,
                                                   struct_towers_bwd_reference,
                                                   struct_towers_reference)
    from mgvae_tpu_torch.train import gradnorm, trainer_balancer, trainer_early_stop
    from mgvae_tpu_torch.train import trainer_gradnorm
    from mgvae_tpu_torch.train import step as step_mod
    from mgvae_tpu_torch.train import trainer as trainer_mod

    log, sync = env.log, torch.cuda.synchronize
    shutil.rmtree(BAL_DIR, ignore_errors=True)
    os.makedirs(BAL_DIR)
    args = get_parse_args(TRAINER_ARGV + ["--save_dir", BAL_DIR])
    cfg_t = cli.model_config(args)
    train_ds, val_ds = cli.load_dataset(args)
    out = {"bounds": {}}

    def make(cls, tid, distributed=False, **kw):
        tr = cls(args, cfg_t, training_id=tid, save_dir=BAL_DIR, batch_size=args.batch_size,
                 distributed=distributed, seed=args.seed, device=DEVICE,
                 rc_prob_func_weight=WEIGHTS[:3], **kw)
        tr.set_training_args(lr=TRAIN_LR)
        return tr

    def lines_of(tr):
        logs = [f for f in os.listdir(tr.log_dir) if f.startswith("log-")]
        with open(os.path.join(tr.log_dir, logs[0])) as f:
            return [ln.rstrip("\n") for ln in f if "| Epoch:" in ln]

    def peak_gib(base):
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30

    # ---- (a) one epoch of each trainer -------------------------------------
    env.clock("[balancer] (a)")
    runs = {}
    for cls, tid, attr, kw in (
            (trainer_balancer.BalancerTrainer, "balancer", "_bal_step", {}),
            (trainer_gradnorm.GradNormTrainer, "gradnorm", "_gn_step", {}),
            (trainer_early_stop.EarlyTrainer, "early", None, {"patience": 1})):
        tr = make(cls, tid, **kw)
        rec: dict = {}
        if attr:
            bal_instrument(torch, tr, attr, "train", rec)
        else:   # EarlyTrainer: the grouped train phase and the val step
            for name, ph in (("train_step", "train"), ("eval_step", "val"),
                             ("multi_step", "train"), ("multi_eval", "val")):
                bal_instrument(torch, tr, name, ph, rec)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m = tr.train(1, train_ds, val_ds)
        sync()
        runs[tid] = (tr, rec, m, peak_gib(base))
    bal, gn, early = runs["balancer"], runs["gradnorm"], runs["early"]
    w_rows = torch.stack([torch.stack([x[f"w_{t}"] for t in trainer_balancer.TASKS])
                          for x in gn[1]["metrics"]]).cpu()
    s_rows = torch.stack([torch.stack([x[f"scale_{t}"] for t in trainer_balancer.TASKS])
                          for x in bal[1]["metrics"]]).cpu()
    loss_rows = torch.stack([torch.stack([x[k] for k in ("recon_loss", "prob_loss",
                                                          "func_loss")])
                             for r in runs.values() for x in r[1]["metrics"]]).cpu()
    want_early = {"train": [(2 * ROUNDS, SBWD_LAUNCHES, 1, 3, 1, 0, 0, 0, 0, 0)],
                  "val": [(2 * ROUNDS, 0, 1, 0, 1, 0, 0, 0, 0, 0)]}
    got = {tid: {ph: sorted(set(r[1].get(ph, []))) for ph in ("train", "val")}
           for tid, r in runs.items()}
    n_steps = {tid: len(r[1]["train"]) for tid, r in runs.items()}
    lines = {tid: lines_of(r[0]) for tid, r in runs.items()}
    for tid, ls in lines.items():
        for ln in ls:
            log(f"[balancer] (a) {tid} log: {ln}")
    meters_ok = all(math.isfinite(r[2][k]) for r in runs.values() for k in ("recon", "prob",
                                                                             "func"))
    weights_ok = bool(((w_rows.sum(1) - 3.0).abs() <= 1e-5).all()) and abs(
        sum(gn[0].task_weights) - 3.0) <= 1e-5
    best = os.path.isfile(os.path.join(early[0].log_dir, "model_best.pth"))
    log(f"[balancer] (a) one epoch each in [trainer]'s configuration (MIG bs{BATCH}, D={DIM}, "
        f"rounds {ROUNDS}, layernorm, highest; {n_steps['balancer']} train steps; weights "
        f"{WEIGHTS[:3]}, lr {TRAIN_LR}): launches per train step {PAR_NAMES}: Balancer "
        f"{got['balancer']['train']}, GradNorm {got['gradnorm']['train']} (want "
        f"{BAL_STEP_LAUNCHES}); EarlyTrainer train {got['early']['train']}, val "
        f"{got['early']['val']}; meters finite {meters_ok} and every step's losses "
        f"{bool(torch.isfinite(loss_rows).all())}; Balancer scales first/last step "
        f"{[round(x, 5) for x in s_rows[0].tolist()]} / "
        f"{[round(x, 5) for x in s_rows[-1].tolist()]}; GradNorm weights "
        f"{[round(x, 5) for x in gn[0].task_weights]} (each step's sum 3 within 1e-5: "
        f"{weights_ok}); EarlyTrainer best {early[0].best_loss:.4f}, model_best.pth {best}; "
        f"epoch peaks above what was held {bal[3]:.3f} / {gn[3]:.3f} / {early[3]:.3f} GiB")
    if not (got["balancer"]["train"] == got["gradnorm"]["train"] == [BAL_STEP_LAUNCHES]
            and got["early"] == want_early and n_steps["balancer"] == n_steps["gradnorm"] == 9
            and meters_ok and bool(torch.isfinite(loss_rows).all()) and weights_ok and best
            and re.match(BAL_LINE, lines["balancer"][0]) and len(lines["balancer"]) == 1
            and re.match(GN_LINE, lines["gradnorm"][0]) and len(lines["gradnorm"]) == 1
            and len(lines["early"]) == 2 and all(re.match(EPOCH_LINE, ln)
                                                 for ln in lines["early"])):
        raise RuntimeError("[balancer] (a): launches, meters, epoch lines, task weights or "
                           "model_best.pth not as wanted")
    out["launches"] = [sum(c[i] for c in bal[1]["train"]) for i in (1, 3)]
    out["per_step"] = [BAL_STEP_LAUNCHES[1], BAL_STEP_LAUNCHES[3]]

    # the trainers' ms per train step in turns (train phase alone), and peaks
    plain_tr = make(trainer_mod.Trainer, "plain")
    turns = []
    for name, tr in (("plain", plain_tr), ("balancer", bal[0]), ("balancer", bal[0]),
                     ("plain", plain_tr)):
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train(1, train_ds, [])
        sync()
        turns.append((name, (time.perf_counter() - t0) / n_steps["balancer"] * 1e3,
                      peak_gib(base)))
    log(f"[balancer] (a) ms per train step, the epoch's wall time over its "
        f"{n_steps['balancer']} steps, in turns (the plain Trainer's train phase, the "
        f"Balancer's): " + ", ".join(f"{n} {ms:.3f}" for n, ms, _ in turns)
        + "; peak above what was held: " + ", ".join(f"{n} {p:.3f} GiB" for n, _, p in turns)
        + f"; card {card}")
    out["turns"] = turns
    del runs, bal, gn, early, plain_tr

    # ---- (b) per-task gradients from one forward, bit for bit ----------------
    env.clock("[balancer] (b)")
    cfg = dg_ae.DGConfig(**PAR_CFG)
    bs16 = collate(env.requests[0])
    cases = {"bs16": bs16, "bs64 C=2": env.chunked, "giant": env.giant_batch}
    for tag, batch in cases.items():
        neg, keep = par_draws(torch, batch, SEED + 31)
        neg, keep = tuple(t.to(dev) for t in neg), [k.to(dev) for k in keep]
        params, state = dg_ae.init_params(cfg, seed=SEED + 3, device=dev)
        leaves = step_mod.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        with precision_scope(cfg.matmul_precision):
            # one forward and the summed loss's backward: its launches and peak
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = par_counts()
            total, _ = step_mod.loss_and_metrics(params, state, batch, None, WEIGHTS, cfg, True,
                                                 neg_edges=neg, drop_keep=keep)
            torch.autograd.grad(total, leaves, allow_unused=True)
            sync()
            single = tuple(x - y for x, y in zip(par_counts(), before))
            single_peak = peak_gib(base)
            del total
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = par_counts()
            one, _, _, _ = trainer_balancer.task_grads(cfg, params, state, batch, None,
                                                       neg_edges=neg, drop_keep=keep)
            sync()
            counts = tuple(x - y for x, y in zip(par_counts(), before))
            one_peak = peak_gib(base)
            three = bal_separate(torch, cfg, params, state, batch, neg, keep)
            sync()
        same = all(torch.equal(a, c) for t in range(3) for a, c in zip(one[t], three[t]))
        # the forward's launches as one step's; the struct backward three times
        # (and its forward again per backward where the struct remat is on), the
        # level recurrence's backward by its route twice
        want = tuple(2 * ROUNDS + 3 * (x - 2 * ROUNDS) if i == 0
                     else x * (3 if i == 1 else 2 if i in (3, 6, 8) else 1)
                     for i, x in enumerate(single))
        log(f"[balancer] (b) {tag}: the three per-task gradients of one forward (retain_graph) "
            f"against three separate forward + backward passes with the same draws, "
            f"{len(leaves)} leaves each: bit for bit {same}; launches {PAR_NAMES}: one forward "
            f"+ three backwards {counts}, one forward + one backward {single}; peak above what "
            f"was held: task_grads {one_peak:.3f} GiB, one step's forward and backward "
            f"{single_peak:.3f} GiB")
        if not (same and counts == want and any(bool(g.any()) for g in one[1])):
            raise RuntimeError(f"[balancer] (b) {tag}: the re-entered backwards differ from "
                               f"separate passes, or launches {counts} != {want}")
        out.setdefault("peaks", {})[tag] = (one_peak, single_peak)
        del one, three, params, state, leaves

    # one Balancer step card against CPU: per-task gradients, scales and the
    # weighted sum, on the bs16 batch
    env.clock("[balancer] (b) card vs CPU")
    neg, keep = par_draws(torch, bs16, SEED + 32)
    side = {}
    for where in ("cpu", DEVICE):
        params, state = dg_ae.init_params(cfg, seed=SEED + 3, device=where)
        leaves = step_mod.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        draws = dict(neg_edges=tuple(t.to(where) for t in neg),
                     drop_keep=[k.to(where) for k in keep])
        with precision_scope(cfg.matmul_precision):
            tasks, _, _, _ = trainer_balancer.task_grads(cfg, params, state, bs16, None, **draws)
        bal_cfg = gradnorm.BalancerConfig(weights=tuple(WEIGHTS[:3]))
        step = trainer_balancer.make_balancer_train_step(
            cfg, torch.optim.SGD(leaves, lr=0.0), bal_cfg)
        _, _, m = step(params, state, gradnorm.balancer_init(bal_cfg, where), bs16, None,
                       **draws)
        side[where] = ([[g.cpu() for g in t] for t in tasks],
                       torch.stack([m[f"scale_{t}"] for t in trainer_balancer.TASKS]).cpu(),
                       [t.grad.cpu() for t in leaves])
    worst = [par_held(f"(b) card vs CPU, {trainer_balancer.TASKS[t]} gradient",
                      side[DEVICE][0][t], side["cpu"][0][t], "[balancer]") for t in range(3)]
    worst.append(par_held("(b) card vs CPU, the scales", list(side[DEVICE][1]),
                          list(side["cpu"][1]), "[balancer]"))
    worst.append(par_held("(b) card vs CPU, the weighted sum", side[DEVICE][2], side["cpu"][2],
                          "[balancer]"))
    log(f"[balancer] (b) one Balancer step on bs16 card vs CPU (weights {WEIGHTS[:3]}, the "
        f"same draws): worst leaf against {GRAD_TOL} * max(scale, 1), recon / prob / func "
        f"gradients {worst[0]:.3f} / {worst[1]:.3f} / {worst[2]:.3f}, scales {worst[3]:.3f} "
        f"({side[DEVICE][1].tolist()} vs {side['cpu'][1].tolist()}), the weighted sum "
        f"{worst[4]:.3f}")
    env.card_vs_cpu_prob("balancer", bs16)
    del side

    # ---- (c) the Balancer epoch over a one-rank NCCL group -------------------
    env.clock("[balancer] (c)")
    launch_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                  "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}

    def bal_epoch(distributed, tid):
        tr = make(trainer_balancer.BalancerTrainer, tid, distributed=distributed)
        rec: dict = {}
        bal_instrument(torch, tr, "_bal_step", "train", rec)
        tr.train(1, train_ds, [])
        sync()
        opt = [t for s in tr.optimizer.state_dict()["state"].values() for t in s.values()]
        rows = torch.stack([torch.stack([x[k] for k in sorted(x)]) for x in rec["metrics"]])
        return {"rows": rows.cpu(), "counts": rec["train"], "group": tr.group,
                "leaves": (step_mod.param_leaves(tr.params) + step_mod.param_leaves(tr.state)
                           + opt + step_mod.param_leaves(tr.bal_state))}

    os.environ.update(launch_env)
    try:
        single = bal_epoch(False, "bal_single")
        dp = bal_epoch(True, "bal_dp")
        backend = dist.get_backend()
        same = (torch.equal(dp["rows"], single["rows"])
                and len(dp["leaves"]) == len(single["leaves"])
                and all(torch.equal(a, c) for a, c in zip(dp["leaves"], single["leaves"])))
        want_dp = BAL_STEP_LAUNCHES[:-1] + (1,)
        log(f"[balancer] (c) the Balancer epoch ({len(dp['counts'])} steps) data-parallel over "
            f"a one-rank {backend} group against the single-device epoch: per-step losses, "
            f"scales and metrics, params, BN state, Adam state and the Balancer's averages bit "
            f"for bit the same: {same}; launches per step {PAR_NAMES} "
            f"{sorted(set(dp['counts']))} (want {want_dp}: one all-reduce of the three "
            f"gradient sets, the BN state, the losses and the metrics)")
        if not (same and dp["group"] is not None and single["group"] is None
                and sorted(set(dp["counts"])) == [want_dp]):
            raise RuntimeError("[balancer] (c): the data-parallel Balancer epoch over one rank "
                               "differs from the single-device epoch, or its launches do")
        dist.destroy_process_group()
    finally:
        for k in launch_env:
            os.environ.pop(k, None)
    del single, dp

    # ---- (d) Trainer(trace_dir=) over one [trainer] epoch ----------------------
    env.clock("[balancer] (d)")
    trace_dir = os.path.join(BAL_DIR, "trace")
    side = {}
    for tid, td in (("traced", trace_dir), ("untraced", None)):
        tr = make(trainer_mod.Trainer, tid, trace_dir=td)
        rec = {}
        bal_instrument(torch, tr, "train_step", "train", rec)
        bal_instrument(torch, tr, "eval_step", "val", rec)
        bal_instrument(torch, tr, "multi_step", "train", rec)
        bal_instrument(torch, tr, "multi_eval", "val", rec)
        tr.train(1, train_ds, val_ds)
        sync()
        rows = torch.stack([torch.stack([x[k] for k in step_mod.METRIC_KEYS])
                            for x in rec["metrics"]]).cpu()
        side[tid] = (rows, [t.detach().clone() for t in step_mod.param_leaves(tr.params)
                            + step_mod.param_leaves(tr.state)])
    same = torch.equal(side["traced"][0], side["untraced"][0]) and all(
        torch.equal(a, c) for a, c in zip(side["traced"][1], side["untraced"][1], strict=True))
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == TRACE_CAT]
    table = {}
    for k in TRACE_KERNELS:
        hits = [e for e in kern if re.search(rf"\b{k}\b", e.get("name", ""))]
        table[k] = (len(hits), sum(float(e.get("dur", 0.0)) for e in hits) / 1e3)
    log(f"[balancer] (d) Trainer(trace_dir=...) over one [trainer] epoch "
        f"({len(side['traced'][0])} steps): {len(files)} trace file(s) "
        f"({os.path.getsize(files[0]) / 2 ** 20:.1f} MiB, {len(events)} events, {len(kern)} "
        f"device kernels); per-step losses, metrics, params and BN state bit for bit the "
        f"untraced epoch's: {same}")
    for k, (n, ms) in table.items():
        log(f"[balancer] (d)   {n:6d} calls {ms:10.4f} ms device  {k}")
    if not (same and len(files) == 1 and all(n > 0 for n, _ in table.values())):
        raise RuntimeError("[balancer] (d): the capture is missing, misses a kernel of rows 1, "
                           "2, 7, 8 or the lists, or tracing changed a number")
    del side, events, kern

    # ---- (e) the large-batch example --------------------------------------------
    env.clock("[balancer] (e)")
    before = par_counts()
    t0 = time.perf_counter()
    steps = large_batch_training.main(["--device", DEVICE])
    sync()
    wall = time.perf_counter() - t0
    counts = tuple(x - y for x, y in zip(par_counts(), before))
    log(f"[balancer] (e) large_batch_training.main(['--device', 'cuda']): {len(steps)} bs64 "
        f"steps in {wall:.1f} s with collation; losses {[round(m['loss'], 4) for m in steps]}; "
        f"launches over the steps {PAR_NAMES} {counts}")
    if not (len(steps) == 5 and all(math.isfinite(m["loss"]) for m in steps)
            and counts[0] == 5 * 2 * ROUNDS and counts[2] >= 5 and counts[3] == 3 * counts[2]
            and counts[5:9] == (0, 0, 0, 0)):
        raise RuntimeError("[balancer] (e): the large-batch example's losses or launches")

    # ---- (f) the re-entered backwards against their plain versions --------------
    env.clock("[balancer] (f)")
    b = dg_ae.batch_to_device(bs16, dev)
    params, _ = dg_ae.init_params(cfg, seed=SEED + 3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    with torch.no_grad():
        sargs = [a.detach().clone() for a in struct_inputs(
            params["struct"], dg_ae.struct_input(b["gate"], cfg), b, cfg.layernorm)]
        tables = struct_tables(b)
        _, sres = struct_kernel._forward_cuda(sargs, tables, ROUNDS, True, residuals=True)
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    N, n_lv, n_edges = sargs[0].shape[2], dg_ae.num_levels(bs16), int(bs16["n_edges"])
    Nn = hs.shape[0]
    dstates = [torch.randn((2, N, DIM), device=dev, generator=gen) for _ in range(3)]
    prepared = level_kernel._prepared(args, backward=True)
    hf, re_k, rn_k = level_kernel._forward_cuda(args, Nn, n_lv, residuals=True,
                                                lists=prepared[0], packed=prepared[1])
    re_k, rn_k = env.written_rows(args[2], args[3], args[5], n_lv, re_k, rn_k)
    ghfs = [torch.randn(hf.shape, device=dev, generator=gen) for _ in range(2)]
    saved = [sres, re_k, rn_k, *prepared[0], *prepared[1]]
    snap = [t.clone() for t in saved]
    sbwd = lambda d: struct_kernel._backward_cuda(d, sres, sargs[1], sargs[2], sargs[4], tables,
                                                  ROUNDS, True)
    lbwd = lambda g: level_kernel._backward_cuda(g, re_k, rn_k, args, n_lv, *prepared)
    # each cotangent in turn from the same residuals, then the first again
    s_again = [sbwd(d) for d in dstates]
    l_again = [lbwd(g) for g in ghfs]
    last = (sbwd(dstates[0]), lbwd(ghfs[0]))
    sync()
    repeat = (all(torch.equal(a, c) for a, c in zip(last[0], s_again[0]))
              and all(torch.equal(a, c) for a, c in zip(last[1], l_again[0]))
              and all(torch.equal(a, c) for a, c in zip(saved, snap)))
    s_err = l_err = 0.0
    for d, got in zip(dstates, s_again):
        _, w = env.held("balancer struct re-entered", ("dxi", "dwfold", "dwhh", "dbhh", "dlnw",
                                                       "dlnb"), got,
                        struct_towers_bwd_reference(d, sres, sargs[1], sargs[2], sargs[4],
                                                    tables, ROUNDS, True))
        s_err = max(s_err, w)
    bargs = (*args[:9], args[10], args[11])
    for g, got in zip(ghfs, l_again):
        _, w = env.held("balancer level re-entered", ("d_pack", "d_wkv", "d_wih", "d_bih",
                                                      "d_bhh", "d_wak"), got,
                        level_kernel.level_scan_bwd_reference(g, re_k, rn_k, *bargs,
                                                              num_levels=n_lv))
        l_err = max(l_err, w)
    for a in sargs:
        a.requires_grad_(True)
    for i in level_kernel.FLOAT_ARGS:
        args[i].requires_grad_(True)
    st_plain = struct_towers_reference(*sargs, tables, ROUNDS, True)
    hf_plain = level_kernel.level_scan_reference(*args, num_nodes=Nn, num_levels=n_lv)
    diff = [args[i] for i in level_kernel.FLOAT_ARGS]
    fns = {"struct": (lambda: [sbwd(d) for d in dstates],
                      lambda: [torch.autograd.grad(st_plain, sargs, d, retain_graph=True)
                               for d in dstates], 3),
           "level": (lambda: [lbwd(g) for g in ghfs],
                     lambda: [torch.autograd.grad(hf_plain, diff, g, retain_graph=True)
                              for g in ghfs], 2)}
    ms = {}
    for name, (kern, plain, n) in fns.items():
        plain()
        for _ in range(5):
            kern()
        t = [event_ms(torch, f, r) / n for f, r in ((plain, BAL_TIMED_PLAIN), (kern, BAL_TIMED),
                                                     (kern, BAL_TIMED), (plain, BAL_TIMED_PLAIN))]
        ms[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t)
    out["bounds"] = {
        "struct_towers_bwd_reentered": env.struct_bound(sargs, tables, n_edges, True,
                                                        backward=True),
        "level_scan_bwd_reentered": env.level_bound(args, n_lv, Nn, True, backward=True)}
    out["err"], out["ms"] = (s_err, l_err), ms
    log(f"[balancer] (f) the re-entered backwards on phase 7's bs16 batch ({n_lv} levels): "
        f"one forward's residuals, lists and weight copies, then the struct backward three "
        f"times and the level backward twice on other cotangents: the first cotangent's "
        f"gradients again bit for bit and every saved tensor unchanged: {repeat}; max|d| "
        f"against the plain backwards {s_err:.3e} / {l_err:.3e}; per backward by CUDA events "
        f"(plain, kernel, kernel, plain; autograd through the plain forward): struct "
        + "/".join(f"{x:.4f}" for x in ms["struct"][2]) + " ms, level "
        + "/".join(f"{x:.4f}" for x in ms["level"][2]) + f" ms; bounds "
        f"{out['bounds']['struct_towers_bwd_reentered']['bound_ms']:.5f} / "
        f"{out['bounds']['level_scan_bwd_reentered']['bound_ms']:.5f} ms; card {card}")
    if not repeat:
        raise RuntimeError("[balancer] (f): a re-entered backward changed what it saved, or "
                           "does not repeat itself")

    # ---- (g) the host collation with and without the allocator tuning ----------
    env.clock("[balancer] (g)")
    probe = {}
    for off in ("1", ""):
        e = dict(os.environ)
        e.pop("MGVAE_NO_MALLOC_TUNE", None)
        if off:
            e["MGVAE_NO_MALLOC_TUNE"] = off
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--collate-probe"],
                           capture_output=True, text=True, timeout=300, env=e, check=True)
        res = json.loads(r.stdout.strip().splitlines()[-1])
        probe.setdefault(res["tuned"], []).append(res["collate_ms"])
    log(f"[balancer] (g) [trainer]'s collation on the host, ms per bs16 batch (median of 5 "
        f"passes over 9 batches, a process each, off then on): without the allocator tuning "
        f"{probe.get(False)}, with it {probe.get(True)}")
    shutil.rmtree(BAL_DIR, ignore_errors=True)
    return out


# [native]: the native host library (ROADMAP 1.10) on the card's host
NAT_REPS = 21                  # host timings: medians of this many calls
NAT_EPOCHS = 3                 # (d)'s epochs per process
NAT_DIR = os.path.join("exp", "chip_smoke_native")
NAT_SHARDS = 8                 # (c)'s collate_shards: 8 bs16 shards
NAT_PROBE_TIMEOUT = 300        # seconds for (d)'s MGVAE_NO_NATIVE=1 process


class numpy_branch:
    """Within the block every caller of the native library takes its numpy
    branch (what ``get_lib`` keeps after ``MGVAE_NO_NATIVE=1``)."""

    def __enter__(self):
        from mgvae_tpu_torch import native

        self.native, self.saved = native, native._lib
        native._lib = False

    def __exit__(self, *exc):
        self.native._lib = self.saved


def nat_differ(a: dict, b: dict, path: str = "") -> list:
    """The keys of two batches that differ in key set, dtype, shape or a
    byte (a split batch's groups key by key)."""
    if set(a) != set(b):
        return [f"{path}keys {sorted(set(a) ^ set(b))}"]
    out = []
    for k in sorted(a):
        if k == "groups":
            for g, (x, y) in enumerate(zip(a[k], b[k], strict=True)):
                out += nat_differ(x, y, f"{path}groups/{g}/")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            out.append(path + k)
    return out


def nat_trainer_epochs(torch) -> dict:
    """[native] (d): [trainer]'s configuration (MIG bs16, D = 64, rounds 4,
    176 synthetic circuits), NAT_EPOCHS epochs of its 9 train steps (no val),
    each epoch's ms per step (its wall time over its steps, the plan, the
    prefetch collate and the metrics' read-back included), every step's
    metrics, then a bare train_step loop over one more epoch's collated
    batches, three passes. The caller picks native or numpy."""
    from mgvae_tpu_torch import cli, native
    from mgvae_tpu_torch.train import trainer as trainer_mod

    shutil.rmtree(NAT_DIR, ignore_errors=True)
    args = cli.get_parse_args(TRAINER_ARGV + ["--save_dir", NAT_DIR])
    cfg = cli.model_config(args)
    train_ds, _ = cli.load_dataset(args)
    tt = trainer_mod.Trainer(args, cfg, training_id="native", save_dir=NAT_DIR,
                             batch_size=BATCH, distributed=False, seed=SEED, device=DEVICE)
    tt.set_training_args(rc_prob_func_weight=[1.0, 4.0, 4.0], lr=TRAIN_LR)
    metrics, step, multi = [], tt.train_step, tt.multi_step

    def recorded(*a, **kw):
        out = step(*a, **kw)
        metrics.append([float(out[1][k]) for k in trainer_mod.METRIC_KEYS])
        return out

    def recorded_group(*a, **kw):   # the grouped trainer's K-step calls
        out = multi(*a, **kw)
        metrics.extend(out[1].tolist())
        return out

    tt.train_step, tt.multi_step = recorded, recorded_group
    epochs_ms = [tt.train(1, train_ds, [])["train"]["time"] * 1e3 for _ in range(NAT_EPOCHS)]
    rows = metrics
    tt.train_step, tt.multi_step = step, multi
    idx, n_steps, dims, C = tt._epoch_plan(train_ds)
    batches = [tt._collate_step([train_ds[i] for i in idx[s * BATCH:(s + 1) * BATCH]], dims, C)
               for s in range(n_steps)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def bare():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in batches:
            tt.state, _ = tt.train_step(tt.params, tt.state, b, gen, tt.weights)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / len(batches) * 1e3

    bare_ms = [bare() for _ in range(3)]
    shutil.rmtree(NAT_DIR, ignore_errors=True)
    return {"native": native.get_lib() is not None, "epochs_ms": epochs_ms, "bare_ms": bare_ms,
            "metrics": rows, "dims": tt._dims_max, "chunks": tt._chunks, "steps": len(rows)}


def native_probe(out: str) -> None:
    """``--native-probe <out>``: (d)'s epochs in this process, which the
    caller starts with MGVAE_NO_NATIVE=1; writes their numbers to ``out``."""
    import torch

    res = nat_trainer_epochs(torch)
    with open(out, "w") as f:
        json.dump(res, f)


def native_phase(torch, dev, card: str, env) -> None:
    """[native] (ROADMAP 1.10): (a) the library phase 2 built from the port's
    copy, its seconds and ABI; (b) its batches against the numpy branch's,
    byte for byte on every key, dtype and shape: bs16 per modality,
    collate(mp=2), the bs64 layouts, collate_shards and collate_split_step
    at dp = 2, the giant batch; (c) host ms, medians of NAT_REPS: a bs16
    collate, the trainer's epoch plan (stats cache against trial collates),
    collate_shards of 8 bs16 shards at 1 and 8 threads, the giant collate;
    (d) [trainer]'s epoch in ms per step, native against numpy (a process
    under MGVAE_NO_NATIVE=1), beside the bare loop, the per-step metrics
    bit for bit. ``env``: main's log, clock, the native build, the 64 MIG
    circuits and the giant graph."""
    from mgvae_tpu_torch import cli, native, random_circuit
    from mgvae_tpu_torch.data import batching
    from mgvae_tpu_torch.train import trainer as trainer_mod

    log = env.log
    # ---- (a) the build ---------------------------------------------------------
    env.clock("[native] (a)")
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("[native] (a): the native host library did not load")
    log(f"[native] (a) {native.library_path().name} built by g++ {' '.join(native.CXX_FLAGS)} "
        f"from {native.SRC.name} in {env.built.seconds:.2f} s (0.00 = already built), ABI "
        f"{lib.mg_abi_version()}; host: {os.cpu_count()} cores; card: {card}")

    # ---- (b) native against numpy, byte for byte -------------------------------
    env.clock("[native] (b)")
    graphs = env.graphs
    shards = [graphs[:BATCH], graphs[BATCH:2 * BATCH]]
    split_dims = batching.split_dims(shards, GROUPS)

    def layouts():
        out = {f"bs16 {m}": lambda m=m: batching.collate(dataset(random_circuit, m, 400, BATCH))
               for m in MODALITIES}
        out.update({
            "collate(mp=2)": lambda: batching.collate(graphs[:BATCH], mp=2),
            "bs64 collate_fit": lambda: batching.collate_fit(graphs),
            "bs64 collate_chunked(2)": lambda: batching.collate_chunked(graphs, CHUNKS),
            "bs64 collate_split(4)": lambda: batching.collate_split(graphs, GROUPS),
            "collate_shards dp=2": lambda: batching.collate_shards(shards),
            "collate_split_step dp=2": lambda: batching.collate_split_step(shards, split_dims),
            "giant": lambda: batching.collate([env.giant_graph]),
        })
        return out

    made = {name: fn() for name, fn in layouts().items()}
    with numpy_branch():
        ref = {name: fn() for name, fn in layouts().items()}
    bad = {name: nat_differ(made[name], ref[name]) for name in made}
    bad = {k: v for k, v in bad.items() if v}
    log(f"[native] (b) native against numpy, byte for byte on every key, dtype and shape: "
        f"{', '.join(made)}: {'equal' if not bad else bad}; the giant batch N = "
        f"{made['giant']['gate'].shape[0]}")
    if bad:
        raise RuntimeError(f"[native] (b): native and numpy batches differ: {bad}")

    # ---- (c) host ms ----------------------------------------------------------
    env.clock("[native] (c)")

    def med(fn):
        return median_wall(fn, NAT_REPS, lambda: None) * 1e3

    def both(fn, fn_np=None, turns=("numpy", "native", "native", "numpy")):
        """([native ms], [numpy ms]) of fn (fn_np on the numpy branch), in
        turns."""
        got = {"native": [], "numpy": []}
        for kind in turns:
            if kind == "native":
                got[kind].append(med(fn))
            else:
                with numpy_branch():
                    got[kind].append(med(fn_np or fn))
        return got["native"], got["numpy"]

    b16 = graphs[:BATCH]
    c16 = both(lambda: batching.collate(b16))
    args = cli.get_parse_args(TRAINER_ARGV + ["--save_dir", NAT_DIR])
    cfg = cli.model_config(args)
    train_ds, _ = cli.load_dataset(args)

    def planner():
        return trainer_mod.Trainer(args, cfg, training_id="plan", save_dir=NAT_DIR,
                                   batch_size=BATCH, distributed=False, seed=SEED,
                                   steps_per_call=1, device=DEVICE)

    t_nat = planner()
    t0 = time.perf_counter()
    t_nat._epoch_plan(train_ds)          # the first plan builds the stats cache
    first_ms = (time.perf_counter() - t0) * 1e3
    plan_threads = {}
    saved = os.environ.get("MGVAE_COLLATE_THREADS")
    try:
        for n in ("1", "8", "1", "8"):
            os.environ["MGVAE_COLLATE_THREADS"] = n
            plan_threads.setdefault(n, []).append(med(lambda: t_nat._epoch_plan(train_ds)))
    finally:
        if saved is None:
            os.environ.pop("MGVAE_COLLATE_THREADS", None)
        else:
            os.environ["MGVAE_COLLATE_THREADS"] = saved
    with numpy_branch():
        t_np = planner()
        t_np._epoch_plan(train_ds)
    plan = both(lambda: t_nat._epoch_plan(train_ds), lambda: t_np._epoch_plan(train_ds))
    if t_nat._dims_max != t_np._dims_max or t_nat._chunks != t_np._chunks:
        raise RuntimeError(f"[native] (c): the plans' dims differ: {t_nat._dims_max} "
                           f"{t_np._dims_max}")
    ds8 = dataset(random_circuit, "mig", 500, NAT_SHARDS * BATCH)
    sh8 = [ds8[i * BATCH:(i + 1) * BATCH] for i in range(NAT_SHARDS)]
    dims8 = {k: max(d[k] for d in map(batching.natural_dims, sh8)) for k in batching._DIM_KEYS}
    threads = {}
    try:
        for n in ("1", "8", "1", "8"):
            os.environ["MGVAE_COLLATE_THREADS"] = n
            threads.setdefault(n, []).append(med(lambda: batching.collate_shards(sh8, dims=dims8)))
    finally:
        if saved is None:
            os.environ.pop("MGVAE_COLLATE_THREADS", None)
        else:
            os.environ["MGVAE_COLLATE_THREADS"] = saved
    with numpy_branch():
        sh8_np = med(lambda: batching.collate_shards(sh8, dims=dims8))
    giant = both(lambda: batching.collate([env.giant_graph]), turns=("native", "numpy"))
    fmt = lambda xs: "/".join(f"{x:.3f}" for x in xs)
    log(f"[native] (c) card: {card}; host ms, medians of {NAT_REPS} calls, native a/b against "
        f"numpy a/b in turns (numpy, native, native, numpy):")
    log(f"[native] (c)   a bs16 MIG collate (16 x {NUM_GATES} gates): native {fmt(c16[0])}, "
        f"numpy {fmt(c16[1])}")
    log(f"[native] (c)   the trainer's _epoch_plan ([trainer]'s 158 train graphs, 9 bs16 "
        f"shards: shuffle and dims scan): with the stats cache {fmt(plan[0])} (its first plan, "
        f"the cache built, {first_ms:.3f}; mg_group_stats on 1 thread "
        f"{fmt(plan_threads['1'])}, on 8 {fmt(plan_threads['8'])}), trial collates "
        f"{fmt(plan[1])}; dims "
        f"{t_nat._dims_max}, C = {t_nat._chunks}")
    log(f"[native] (c)   collate_shards of {NAT_SHARDS} bs16 MIG shards at their common dims "
        f"(one mg_collate_step): 1 thread {fmt(threads['1'])}, 8 threads {fmt(threads['8'])}; "
        f"numpy {sh8_np:.3f}")
    log(f"[native] (c)   the giant collate (N = {made['giant']['gate'].shape[0]}, "
        f"{env.giant_graph.num_edges} edges): native {fmt(giant[0])}, numpy {fmt(giant[1])}")
    shutil.rmtree(NAT_DIR, ignore_errors=True)

    # ---- (d) the [trainer] epoch, native against numpy --------------------------
    env.clock("[native] (d)")
    # in this process, in turns (native, numpy, numpy, native): the timing;
    # then numpy in a process under MGVAE_NO_NATIVE=1: the branch as a user
    # selects it, its metrics bit for bit
    turns = []
    for kind in ("native", "numpy", "numpy", "native"):
        if kind == "native":
            turns.append(nat_trainer_epochs(torch))
        else:
            with numpy_branch():
                turns.append(nat_trainer_epochs(torch))
    nat = turns[0]
    out = os.path.abspath(os.path.join("exp", "chip_smoke_native_probe.json"))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    e = dict(os.environ, MGVAE_NO_NATIVE="1")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--native-probe", out],
                       capture_output=True, text=True, timeout=NAT_PROBE_TIMEOUT, env=e)
    probe_s = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"[native] (d): the MGVAE_NO_NATIVE=1 process failed "
                           f"({r.returncode}):\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    with open(out) as f:
        npy = json.load(f)
    os.remove(out)
    runs = turns + [npy]
    same = all(t["metrics"] == nat["metrics"] and t["dims"] == nat["dims"] for t in runs)
    branches = [t["native"] for t in runs] == [True, False, False, True, False]
    log(f"[native] (d) card: {card}")
    log(f"[native] (d) [trainer]'s epoch (MIG bs{BATCH}, D={DIM}, rounds {ROUNDS}, 9 train "
        f"steps), ms per step over {NAT_EPOCHS} epochs, then the bare loop's three passes, in "
        f"this process in turns: " + "; ".join(
            f"{'native' if t['native'] else 'numpy'} {fmt(t['epochs_ms'])}, bare "
            f"{fmt(t['bare_ms'])}" for t in turns)
        + f"; numpy in a process under MGVAE_NO_NATIVE=1 ({probe_s:.1f} s with its start; its "
        f"first epoch warms the process up) {fmt(npy['epochs_ms'])}, bare {fmt(npy['bare_ms'])}; "
        f"dims {nat['dims']}; {nat['steps']} steps' metrics bit for bit in all five runs: "
        f"{same}; each took its branch: {branches}")
    if not (same and branches and nat["steps"] == NAT_EPOCHS * 9):
        raise RuntimeError("[native] (d): the native and numpy epochs differ, or a run took "
                           "the wrong branch")


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
    from mgvae_tpu_torch import native
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
    # the native host library: the data layer's collates from phase 3 on
    native_built = native.build()
    if native.get_lib() is None:
        raise RuntimeError("[build] the native host library did not load on the card's host")
    log(f"[build] {native_built.path.name} (native host library, g++): "
        f"{native_built.seconds:.2f} s (0.00 = already built)")

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
        with precision_scope(c.matmul_precision), gathers_as_on_card(where):
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

    clock("[wide]")
    # ---- [wide]: D = 256 and 160, past the kernels' width --------------------------
    # Round 5's configuration (MIG bs16, D = 256, s/t_rounds 4, layernorm, weights
    # [1, 4, 2, 0]) in fp32 ("highest") and bf16: the eager struct towers and
    # dg_ae.level_scan_fast, plain torch, with every kernel's count at 0
    t_wide = time.perf_counter()
    wide, b16 = {}, batches[0]
    rows_w = torch.as_tensor(b16["node_valid"])
    for dtype in ("float32", "bfloat16"):
        cw = dg_ae.DGConfig(modality="mig", dim_hidden=WIDE_DIM, s_rounds=ROUNDS,
                            t_rounds=ROUNDS, layernorm=True, compute_dtype=dtype,
                            matmul_precision="highest")
        var_zero()
        if dtype == "float32":    # the serving path: one Model.encode_many request
            got = Model(modality="mig", dim_hidden=WIDE_DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                        layernorm=True, seed=SEED, device=DEVICE).encode_many(requests[0])
            want = Model(modality="mig", dim_hidden=WIDE_DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                         layernorm=True, seed=SEED, device="cpu").encode_many(requests[0])
            enc = [(torch.as_tensor(np.concatenate([o[i] for o in got])),
                    torch.as_tensor(np.concatenate([o[i] for o in want]))) for i in (0, 1)]
        else:
            pair = []
            for where in (DEVICE, "cpu"):
                p_w, _ = dg_ae.init_params(cw, seed=SEED, device=where)
                with torch.inference_mode():
                    pair.append([t.cpu().float()[rows_w] for t in dg_ae.forward(p_w, b16, cw)[:2]])
            enc = list(zip(*pair))
        s_card = step_grads(cw, b16, DEVICE, WIDE_WEIGHTS)
        sync()
        counts = var_read()
        tol = CPU_TOL if dtype == "float32" else BF16_ULPS
        e_err = []
        for name, (g, c) in zip(("hs", "hf"), enc):
            err, sc = (g - c).abs().max().item(), c.abs().max().item()
            e_err.append(f"{name} {err:.3e}/{sc:.3e}")
            if not (torch.isfinite(g).all() and err <= tol * sc):
                raise RuntimeError(f"[wide] D={WIDE_DIM} {dtype} encode card vs CPU: {name} "
                                   f"max|d| {err} past {tol} * {sc}")
        s_cpu = step_grads(cw, b16, "cpu", WIDE_WEIGHTS)
        if dtype == "float32":
            (l_g, g_g), (l_c, g_c) = s_card, s_cpu
            g_scale = max(c.abs().max().item() for c in g_c)
            worst = max(((a - c).abs().max().item() / (GRAD_TOL * max(
                c.abs().max().item(), GRAD_FLOOR * g_scale)), name) for name, a, c in zip(
                    named_leaves(dg_ae.init_params(cw, device="cpu")[0]), g_g, g_c, strict=True))
            l_err = max(abs(a - c) / max(abs(c), 1.0) for a, c in zip(l_g, l_c))
            step_report = (f"losses max rel|d| {l_err:.3e}; worst gradient leaf {worst[1]} at "
                    f"{worst[0]:.3f} of {GRAD_TOL} * max(its scale, {GRAD_FLOOR} * "
                    f"{g_scale:.3e})")
            if not (l_err <= CPU_TOL and worst[0] <= 1.0):
                raise RuntimeError(f"[wide] D={WIDE_DIM} fp32 step card vs CPU: {step_report}")
        else:
            step_report = step_held(f"wide D={WIDE_DIM} bf16 step card vs CPU", s_card, s_cpu,
                                    BF16_ATOL)
        wide[dtype] = counts
        log(f"[wide] D={WIDE_DIM} {dtype} MIG bs{BATCH} (weights {WIDE_WEIGHTS}): launches "
            f"{var_names} {counts}; encode card vs CPU max|d|/scale {', '.join(e_err)} (tol "
            f"{tol} of the scale); one train step card vs CPU: {step_report}")
        if counts != (0,) * 6:
            raise RuntimeError(f"[wide] D={WIDE_DIM} {dtype}: a kernel launched {counts}")
    if leaf_faults:
        raise RuntimeError(f"[wide] gradient leaves past their bounds: {leaf_faults}")
    # the chunked layout at D = 160: one step on phase 12's two-chunk bs64
    # batch, card vs CPU (the prob term apart, SMOOTH_WEIGHTS' reason)
    c160 = dg_ae.DGConfig(modality="mig", dim_hidden=WIDE_CHUNKED_DIM, s_rounds=ROUNDS,
                          t_rounds=ROUNDS, layernorm=True, matmul_precision="highest")
    chunked160 = collate_chunked(graphs, CHUNKS)
    var_zero()
    card_vs_cpu_step(f"wide D={WIDE_CHUNKED_DIM} chunked", chunked160, SMOOTH_WEIGHTS, c160)
    sync()
    counts = var_read()
    log(f"[wide] D={WIDE_CHUNKED_DIM} collate_chunked(64 circuits, {CHUNKS}): launches "
        f"{var_names} {counts}")
    if counts != (0,) * 6:
        raise RuntimeError(f"[wide] D={WIDE_CHUNKED_DIM} chunked: a kernel launched {counts}")
    # for information: the bs16 step at D = 256 beside phase 7's D = 64 ("highest",
    # [precision] (d)'s step), medians of 5 in turns, and a D = 256 step's own peak
    wide_steps = {"D=64 fp32": steps_tf["highest"]}
    for dtype in ("float32", "bfloat16"):
        cw = dg_ae.DGConfig(modality="mig", dim_hidden=WIDE_DIM, s_rounds=ROUNDS,
                            t_rounds=ROUNDS, layernorm=True, compute_dtype=dtype,
                            matmul_precision="highest")
        p_w, s_w = dg_ae.init_params(cw, seed=SEED, device=dev)
        ts_w, _ = train_step_mod.make_train_step(cw, train_step_mod.make_optimizer(p_w, TRAIN_LR))
        ts_w(p_w, s_w, b16, gen, WIDE_WEIGHTS)
        wide_steps[f"D={WIDE_DIM} {dtype}"] = (ts_w, p_w, s_w)
    wide_ms = {k: [] for k in wide_steps}
    for k in (*wide_steps, *reversed(wide_steps)):
        ts_w, p_w, s_w = wide_steps[k]
        wide_ms[k].append(median_wall(lambda: ts_w(p_w, s_w, b16, gen, WIDE_WEIGHTS), 5, sync)
                          * 1e3)
    peaks = {}
    for k in list(wide_steps)[1:]:
        ts_w, p_w, s_w = wide_steps[k]
        sync()
        held_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ts_w(p_w, s_w, b16, gen, WIDE_WEIGHTS)
        sync()
        peaks[k] = (torch.cuda.max_memory_allocated() - held_bytes) / 2**30
    log(f"[wide] card: {card}")
    log(f"[wide] MIG bs{BATCH} train step (host batch -> Adam update, synchronised), medians of "
        f"5 in turns: " + "; ".join(f"{k} {[round(x, 3) for x in v]} ms"
                                    for k, v in wide_ms.items())
        + f"; D={WIDE_DIM} / D=64 fp32 "
        f"{statistics.median(wide_ms[f'D={WIDE_DIM} float32']) / statistics.median(wide_ms['D=64 fp32']):.3f}"
        f"; a D={WIDE_DIM} step's own peak device memory above what the script held: "
        + ", ".join(f"{k} {v:.3f} GiB" for k, v in peaks.items()))
    ts_w, p_w, s_w = wide_steps[f"D={WIDE_DIM} float32"]
    profile_train(torch, lambda: ts_w(p_w, s_w, b16, gen, WIDE_WEIGHTS), card,
                  f"D={WIDE_DIM} fp32 MIG bs{BATCH} train step", steps=1, rows=12, warm=0)
    del wide_steps
    log(f"[wide] {time.perf_counter() - t_wide:.1f} s")

    clock("[pretrained]")
    # ---- [pretrained]: a reference .pth through Model.load ----------------------
    # the state dict of benchmarks/torch_reference.ReferenceModel (torch only, the
    # reference's parameter names), saved as the reference trainer saves it
    from benchmarks.torch_reference import ReferenceModel

    torch.manual_seed(SEED)
    ref = ReferenceModel("mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                         layernorm=True).eval()
    ref_dir = os.path.join("exp", "chip_smoke_pretrained")
    os.makedirs(ref_dir, exist_ok=True)
    ref_path = os.path.join(ref_dir, "reference.pth")
    torch.save({"epoch": 3, "state_dict": ref.state_dict()}, ref_path)
    loaded = Model(modality="mig", layernorm=True, device=DEVICE).load(ref_path)
    loaded_cpu = Model(modality="mig", layernorm=True, device="cpu").load(ref_path)
    var_zero()
    out_ref = loaded.encode_many(requests[0])
    sync()
    counts = var_read()
    d_ref = [max(float(np.abs(a[i] - c[i]).max()) for a, c in zip(
        out_ref, loaded_cpu.encode_many(requests[0]))) for i in (0, 1)]
    g0 = requests[0][0]
    with torch.no_grad():
        hs_t, hf_t = ref(torch.from_numpy(g0.gate).long(), torch.from_numpy(g0.edge_index),
                         torch.from_numpy(g0.forward_level).long())
    d_model = [float(np.abs(out_ref[0][i] - t.numpy()).max()) for i, t in enumerate((hs_t, hf_t))]
    want = (2 * ROUNDS, 0, 1, 0, 1, 0)
    log(f"[pretrained] {ref_path} (ReferenceModel's state dict, epoch 3) through Model.load, "
        f"one bs{BATCH} encode_many request on the card: launches {var_names} {counts} (want "
        f"{want}); card vs the same file on the CPU max|d| hs/hf {d_ref[0]:.3e}/{d_ref[1]:.3e}; "
        f"its first circuit vs ReferenceModel's own forward {d_model[0]:.3e}/{d_model[1]:.3e} "
        f"(tol {CPU_TOL})")
    if counts != want or not max(d_ref + d_model) <= CPU_TOL:
        raise RuntimeError("[pretrained] the loaded reference weights do not encode as on the "
                           "CPU and in the reference model, or not through the kernels")
    try:
        Model(modality="mig", layernorm=True, device=DEVICE).load_pretrained()
    except FileNotFoundError as e:
        log(f"[pretrained] load_pretrained() without weights: FileNotFoundError ({e})")
    else:
        raise RuntimeError("[pretrained] load_pretrained() without weights did not raise")
    shutil.rmtree(ref_dir)

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

    clock("[parallel]")
    # ---- [parallel]: data and model parallelism (ROADMAP 1.7) --------------------
    par = parallel_phase(torch, dev, card, types.SimpleNamespace(
        log=log, held=held, written_rows=written_rows, step_bound=step_bound,
        requests=requests, giant_batch=giant_batch, clock=clock))
    bounds.update(par["bounds"])

    clock("[balancer]")
    # ---- [balancer]: the multi-task trainers and the rest of ROADMAP 1.9 ---------
    bal = balancer_phase(torch, dev, card, types.SimpleNamespace(
        log=log, clock=clock, held=held, written_rows=written_rows, struct_bound=struct_bound,
        level_bound=level_bound, card_vs_cpu_prob=card_vs_cpu_prob, requests=requests,
        chunked=chunked, giant_batch=giant_batch))
    bounds.update(bal["bounds"])

    clock("[native]")
    # ---- [native]: the native host library (ROADMAP 1.10) ------------------------
    native_phase(torch, dev, card, types.SimpleNamespace(
        log=log, clock=clock, built=native_built, graphs=graphs, giant_graph=giant_graph))

    clock("[multistep]")
    # ---- [multistep]: the K-step calls as CUDA graphs (ROADMAP 1.14) --------------
    ms_out = multistep_phase(torch, dev, card, types.SimpleNamespace(
        log=log, clock=clock, giant_graph=giant_graph, gloo=par["gloo"]))
    clock("[multichip]")
    # ---- [multichip]: the four-card dry run at one rank (ROADMAP 1.12, 1.13) ----
    multichip_phase(card)
    clock("[gather]")
    # ---- [gather]: the backward of the model's row gathers ------------------------
    gather_entries = gather_phase(torch, dev, card)
    for name, eager in (("struct_towers_graph", "struct_towers_residuals"),
                        ("struct_towers_bwd_graph", "struct_towers_bwd"),
                        ("level_scan_graph", "level_scan_residuals"),
                        ("level_scan_bwd_graph", "level_scan_bwd")):
        bounds[name] = bounds[eager]

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
        # kernels 5 and 6 on model-parallel member tables ([parallel]): launches
        # of (b)'s two sharded steps (bs16 and giant); times and bounds of one
        # pass over the giant member tables' real levels
        entry("level_step_mp", "level_step.cu", "level_kernel.py:1636", par["mp_launches"][0],
              par["fwd_err"], par["ms"]["kf"], par["ms"]["pf"], launches_per_pass=par["levels"]),
        entry("level_step_bwd_mp", "level_step_bwd.cu", "level_kernel.py:1706",
              par["mp_launches"][1], par["bwd_err"], par["ms"]["kb"], par["ms"]["pb"],
              launches_per_pass=3 * par["levels"]),
        # kernels 8 and 2 re-entered from one forward's residuals on the
        # Balancer step ([balancer]): launches of (a)'s Balancer epoch; time
        # per backward on phase 7's bs16 batch
        entry("struct_towers_bwd_reentered", "struct_towers_bwd.cu", "struct_kernel.py:338",
              bal["launches"][0], bal["err"][0], *bal["ms"]["struct"][:2],
              launches_per_step=bal["per_step"][0]),
        entry("level_scan_bwd_reentered", "level_scan_bwd.cu", "level_kernel.py:487",
              bal["launches"][1], bal["err"][1], *bal["ms"]["level"][:2],
              launches_per_step=bal["per_step"][1]),
        # kernels 7, 8, 1 and 2 replayed from the K-step call's CUDA graph
        # ([multistep] (a), fp32): launches of (a)'s graph run (train and eval
        # calls), max |d| of everything it made against its eager steps, and
        # device ms per train step of the replays under torch.profiler; the
        # plain versions' times and the bounds of the eager entries
        entry("struct_towers_graph", "struct_towers.cu", "struct_kernel.py:175",
              ms_out["launches"]["struct_kernel.launches"], ms_out["struct_towers_graph"]["err"],
              ms_out["struct_towers_graph"]["ms"], srms_p,
              launches_per_step=ms_out["struct_towers_graph"]["per_step"]),
        entry("struct_towers_bwd_graph", "struct_towers_bwd.cu", "struct_kernel.py:338",
              ms_out["launches"]["struct_kernel.bwd_launches"],
              ms_out["struct_towers_bwd_graph"]["err"], ms_out["struct_towers_bwd_graph"]["ms"],
              sbms_p, launches_per_step=ms_out["struct_towers_bwd_graph"]["per_step"]),
        entry("level_scan_graph", "level_scan.cu", "level_kernel.py:173",
              ms_out["launches"]["level_kernel.launches"], ms_out["level_scan_graph"]["err"],
              ms_out["level_scan_graph"]["ms"], rms_p,
              launches_per_step=ms_out["level_scan_graph"]["per_step"]),
        entry("level_scan_bwd_graph", "level_scan_bwd.cu", "level_kernel.py:487",
              ms_out["launches"]["level_kernel.bwd_launches"],
              ms_out["level_scan_bwd_graph"]["err"], ms_out["level_scan_bwd_graph"]["ms"],
              bms_p, launches_per_step=ms_out["level_scan_bwd_graph"]["per_step"]),
        # the row gathers' backward ([gather]): launches of the main path's
        # calls; times summed over a train step's seven sites
        *gather_entries,
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(*sys.argv[2:4])
        sys.exit(0)
    if sys.argv[1:2] == ["--collate-probe"]:
        collate_probe()
        sys.exit(0)
    if sys.argv[1:2] == ["--native-probe"]:
        native_probe(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
