"""The level recurrence, forward and backward: the CUDA kernels' wrappers
and their plain PyTorch versions.

Counterpart of ``mgvae_tpu/ops/pallas/level_kernel.py``, in forms that share
one level's arithmetic:

  * the fused scan over all levels of one (sub-)batch, hf kept inside:
    ``fused_level_scan`` (with and without residuals) is
    ``csrc/level_scan.cu``, ``fused_level_scan_bwd`` is
    ``csrc/level_scan_bwd.cu``, and the custom VJP ``pallas_level_scan`` that
    joins them is the autograd Function behind ``level_scan``;
  * the single-level step from an explicit hf: ``level_step_call`` is
    ``csrc/level_step.cu``, ``level_step_bwd_call`` is
    ``csrc/level_step_bwd.cu``, and the custom VJP ``pallas_level_step`` is
    the autograd Function behind ``level_step``. It returns the level's new
    rows h_new [Np, D] unscattered;
  * the step route, for chunked batches whose chunks are too large for the
    fused route: the JAX package's scan of ``pallas_level_step`` over the
    (chunk, level) rows (``mgvae_tpu/models/dg_ae.py::_level_scan_step``) is
    ``level_scan_step``, whose autograd Function runs one launch of
    ``csrc/level_step.cu``'s kernel per level index for all chunks, the new
    rows scattered into hf inside the kernel, and a backward that carries
    hf's cotangent in place over the level indices (``csrc/level_step_bwd.cu``),
    keeping its scratch for K level indices at a time
    (``step_chunk_levels``);
  * the scan of one batch of any size that keeps no residuals, for giant
    single graphs and every plain batch too large for the fused route's size
    gate: ``fused_level_scan_hbm`` is ``csrc/level_scan.cu``'s launch
    without residuals, ``fused_level_scan_hbm_bwd`` is
    ``csrc/level_scan_giant_bwd.cu``, and the custom VJP
    ``pallas_level_scan_hbm`` is the autograd Function behind
    ``level_scan_giant``. Its forward saves hf alone and its backward
    recomputes the levels' intermediates from it, K levels at a time
    (``giant_chunk_levels``), so training needs O(N * D + K * Ep * D) working
    memory where the fused route's residuals need O(L * Ep * D).

Dispatch of ``level_scan``, ``level_step``, ``level_scan_step`` and
``level_scan_giant``, with no hidden fallback:
  * CUDA tensors: the forward kernel or raise. When grad is enabled and a
    float input requires grad it goes through the autograd Function: the
    forward kernel also writes the residuals (the giant route has none: it
    saves hf), and the backward launches the backward kernels. Otherwise
    (serving) it takes the launch without residuals.
  * CPU tensors: the plain version; autograd differentiates it.

``level_scan_reference`` / ``level_step_reference`` /
``level_scan_step_reference`` (``with_residuals=True`` for the training
forward) and ``level_scan_bwd_reference`` / ``level_step_bwd_reference`` /
``level_scan_step_bwd_reference`` (with ``chunk_levels`` in its kernel's
order) are the plain versions of the first four kernels and of the step
route, ``level_scan_giant_reference`` (hf only) and
``level_scan_giant_bwd_reference`` (which recomputes from hf, as its kernel
does, and with ``chunk_levels`` in its kernel's order) those of the giant
route's, that the tests and ``chip_smoke.py`` hold
them against; ``_forward_cuda``, ``_backward_cuda``, ``_step_forward_cuda``,
``_step_backward_cuda``, ``_step_route_forward_cuda``,
``_step_route_backward_cuda``, ``_giant_forward_cuda`` and
``_giant_backward_cuda`` are the kernels' wrappers (CUDA tensors only,
arguments as the public functions check them).

The kernels find their work in index lists, not by scanning the level
tables: ``level_lists`` groups, per level, the updated slots by expert, the
live in-edge rows by destination slot and by source node, in plain torch on
the tables' device with no host sync, and on the card in one launch of
``csrc/level_lists.cu`` (``lists_launches``). The wrappers build them when
the caller passes none (``lists=``); ``models/dg_ae.level_recurrence`` builds
them once per batch, and the autograd Functions keep them, and the
expert-major copy of the weights (``repack_expert_major``), from the forward
for the backward.

Launch counts, so that a run can show that it went through the kernels by
setting them to 0 and reading them afterwards: ``launches`` (the fused
forward: one persistent launch per call) with ``levels_walked`` (the levels
those launches walked), ``bwd_launches`` (the fused backward: one persistent
sweep, then the weight gradients' partials and, past
``LEVELS_PER_BLOCK`` levels, their sums: three per call) with
``bwd_levels_walked``, ``step_launches`` (the step kernel: one per
``level_step`` call, one per level index of a ``level_scan_step`` pass,
max(real levels), as the C entry counts them), ``step_bwd_launches``
(three per backward of a ``level_step`` call: slots, sources, weight
gradients; per backward of a ``level_scan_step`` pass two per level index
and the weight gradients per block of K level indices and chunk, as the C
entry counts them, ``step_route_launch_count``), ``giant_launches`` (the giant forward: one
persistent launch per call) and ``giant_bwd_launches`` (the giant backward:
per chunk of levels a recompute, a persistent sweep and the weight
gradients' partials, and where the chunk has more than one level their
sums, as the C entry counts them; ``giant_bwd_launch_count`` says how many
that should be).

Values: fp32 or bf16 on every route (the JAX package's throughput mode,
``level_kernel.py:352-356``), all float arguments of a call in one type: in
bf16 pack_lv, hf and the backward's d_pack are bf16, values are rounded
where the JAX kernels round them (``rounder``), everything else is fp32, and
the weight gradients are summed in fp32 and rounded once to the weights'
dtype. The fused and step routes (kernels 1, 2, 5, 6) round as
``_level_body`` / ``_level_bwd_body`` do: bf16 residuals, and a bf16
cotangent of hf carried back, one rounding per level where a level's
sources' gradients are added into it. The giant backward (kernel 4) rounds
as the JAX package's ``_level_bwd_kernel_hbm``: it carries the cotangent of
hf in fp32, adds the sources' gradients unrounded, and keeps the levels'
values it recomputes in fp32; only the products' operands and d_pack are
rounded. On CPU tensors training goes through each route's autograd
Function with both plain versions, in either value type, so that the CPU
rounds where the kernels do. Every autograd Function saves the forward's matmul precision
(``ops.precision``) and runs its backward in it.

Residual layout (the port's own, unpadded): res_e [L, Ep, 3D+1] =
hf_src | khf | v | attn per edge, res_n [L, Np, 4D] = msg | r | z | nw per
slot (the step route's over all C * L rows); the step's are one level's,
[Ep, 3D+1] and [Np, 4D]. The kernels write
the rows of live edges and updated slots (``live_rows``) of the real levels
and read no other; the plain versions leave the other rows 0, the kernels
leave them unwritten.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .precision import bf16_flag, current_precision, matmul_precision, rounder
from .segment import segment_softmax, segment_sum

MAX_DIM = 128      # the kernels' limits (csrc/level_common.cuh)
MAX_EXPERTS = 5

# levels per block of the weight-gradient kernel: a chunk's rows are summed in
# one accumulator, the chunks' partials pairwise. At most 32 chunks per call.
LEVELS_PER_BLOCK = 4
# The backwards that keep their scratch for K levels at a time: the giant
# backward's chunks of levels (giant_chunk_levels; within a chunk the weight
# gradients take a partial per level, so that one chunk's few levels still
# fill the card) and the step route's blocks of level indices
# (step_chunk_levels). Their scratch may take SCRATCH_SHARE of the bytes the
# route holds anyway, or SCRATCH_FLOOR bytes where that is more.
SCRATCH_SHARE = 0.18
SCRATCH_FLOOR = 16 << 20

lists_launches = 0
launches = 0
bwd_launches = 0
levels_walked = 0
bwd_levels_walked = 0
step_launches = 0
step_bwd_launches = 0
giant_launches = 0
giant_bwd_launches = 0

# Size gate of the fused route for a chunk of a chunked batch, copied from the
# JAX package (``level_kernel.py:145-158``), where it is the TPU kernel's VMEM
# gate. The CUDA kernels have no such limit: this is shape arithmetic only,
# kept so that ``collate_fit`` chunks a batch, and ``models/dg_ae`` routes it,
# the same way in both packages. (The JAX package's two further gates, past
# which it leaves its giant kernels, are not copied: the giant route here
# takes any size.)
KERNEL_MAX_NODES = 8192
KERNEL_MAX_EP = 512
KERNEL_MAX_NP = 512


def kernel_fits(num_nodes: int, ep: int, np_: int, dim: int) -> bool:
    return (num_nodes <= KERNEL_MAX_NODES and ep <= KERNEL_MAX_EP
            and np_ <= KERNEL_MAX_NP and dim <= 128)


# positions of the float (differentiable) arguments among level_scan's (and
# level_scan_giant's) 12:
# pack_lv, wkv_hf, w_ih, b_ih, b_hh, wa_k
FLOAT_ARGS = (0, 7, 8, 9, 10, 11)
# and among level_step's 12: hf, pack, wkv_hf, w_ih, b_ih, b_hh, wa_k
STEP_FLOAT_ARGS = (0, 1, 7, 8, 9, 10, 11)


class LevelLists(NamedTuple):
    """Where the kernels find a level's work (``level_lists``); int32, one
    row per level."""
    slot_rows: torch.Tensor   # [R, Np] updated slots, grouped by expert, ascending
    slot_off: torch.Tensor    # [R, T+1] expert e's slots: positions [off[e], off[e+1])
    in_rows: torch.Tensor     # [R, Ep] live edge rows, grouped by slot position, in row order
    in_off: torch.Tensor      # [R, Np+1] position p's in-edges: in_rows[off[p] : off[p+1]]
    src_rows: torch.Tensor    # [R, Ep] live edge rows, grouped by source node, in row order

    def rows(self, begin: int, end: int) -> "LevelLists":
        """The lists of levels [begin, end)."""
        return LevelLists(*(t[begin:end] for t in self))


def live_rows(lv_dslot, lv_evalid, lv_upd):
    """(edges [..., Ep], slots [..., Np]) as bool: the updated slots, and
    the valid edges into them. Only their residual rows are written."""
    upd = lv_upd > 0
    dslot = lv_dslot.long().clamp(0, upd.shape[-1] - 1)
    return (lv_evalid > 0) & upd.gather(-1, dslot), upd


def level_lists(lv_src, lv_dslot, lv_evalid, lv_upd, lv_e_n, num_experts: int) -> LevelLists:
    """The index lists of the level tables [R, Ep] / [R, Np] int32 (or of one
    level's, [Ep] / [Np]), for all levels at once, in any row order: on CUDA
    tensors one launch of ``csrc/level_lists.cu`` (counted in
    ``lists_launches``), on CPU tensors ``level_lists_reference``, the plain
    version, which gives the same lists entry for entry."""
    tables = (lv_src, lv_dslot, lv_evalid, lv_upd, lv_e_n)
    if lv_src.dim() == 1:
        tables = tuple(t[None] for t in tables)
    dev = lv_src.device
    if dev.type == "cpu":
        return level_lists_reference(*tables, num_experts)
    if dev.type != "cuda":
        raise ValueError(f"level_lists: no kernel for device {dev}")
    global lists_launches
    (R, ep), np_ = tables[0].shape, tables[3].shape[1]
    _check_tensors("level_lists", ("lv_src", "lv_dslot", "lv_evalid", "lv_upd", "lv_e_n"), tables,
                   [((R, ep), torch.int32)] * 3 + [((R, np_), torch.int32)] * 2, dev)
    lists = LevelLists(*(torch.empty((R, n), dtype=torch.int32, device=dev)
                         for n in (np_, num_experts + 1, ep, np_ + 1, ep)))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_lists(*(t.data_ptr() for t in (*tables, *lists)),
                                     R, ep, np_, num_experts, stream)
    _build.check(lib, code, "level_lists kernel launch")
    lists_launches += 1
    return lists


def level_lists_reference(lv_src, lv_dslot, lv_evalid, lv_upd, lv_e_n,
                          num_experts: int) -> LevelLists:
    """The lists' plain version, on the tables' device with no host sync.

    Per level: the updated slots sorted by expert (``slot_rows``,
    ``slot_off``); the live edge rows, i.e. the valid edges into updated
    slots, sorted by their slot's position in ``slot_rows`` (``in_rows``,
    ``in_off``), so that a slot's in-edges and an expert's edges are both
    contiguous; and the same rows sorted by source node (``src_rows``; a
    source's group ends where the next row has another source, and the
    level has ``in_off[:, Np]`` live rows). All sorts are stable: ties keep
    row order, which fixes the order of every sum the kernels take. Plain
    torch on the tables' device, with no host sync."""
    if lv_src.dim() == 1:
        lv_src, lv_dslot, lv_evalid, lv_upd, lv_e_n = (
            t[None] for t in (lv_src, lv_dslot, lv_evalid, lv_upd, lv_e_n))
    R, np_ = lv_upd.shape
    dev = lv_src.device
    live, upd = live_rows(lv_dslot, lv_evalid, lv_upd)
    key, slot_rows = torch.sort(torch.where(upd, lv_e_n, num_experts), dim=1, stable=True)
    bounds = torch.arange(num_experts + 1, dtype=key.dtype, device=dev).expand(R, -1)
    slot_off = torch.searchsorted(key, bounds.contiguous(), out_int32=True)
    position = torch.empty_like(slot_rows).scatter_(
        1, slot_rows, torch.arange(np_, device=dev).expand(R, -1))
    dslot = lv_dslot.long().clamp(0, np_ - 1)
    key, in_rows = torch.sort(torch.where(live, position.gather(1, dslot), np_), dim=1,
                              stable=True)
    bounds = torch.arange(np_ + 1, device=dev).expand(R, -1)
    in_off = torch.searchsorted(key, bounds.contiguous(), out_int32=True)
    never = torch.iinfo(torch.int32).max
    src_rows = torch.sort(torch.where(live, lv_src.long(), never), dim=1, stable=True)[1]
    return LevelLists(slot_rows.to(torch.int32), slot_off, in_rows.to(torch.int32), in_off,
                      src_rows.to(torch.int32))


def repack_expert_major(wkv_hf, w_ih, num_experts: int, backward: bool = False):
    """The weights as the kernels stage them: expert-major, each expert's
    matrices contiguous and zero-padded to P = D rounded up to a multiple of
    32, so that a block copies its expert's weights into shared memory in one
    sweep and every loop of a kernel runs to a constant bound.

    (wkv_e [T, 2, P, P], wih_e [T, P, 3P]): wkv_e[e, 0] = wk_e =
    wkv_hf[:, e*D : (e+1)*D] and wkv_e[e, 1] = wv_e = wkv_hf[:, (T+e)*D :
    (T+e+1)*D] in their top left [D, D]; wih_e[e] = w_ih[:, e*3D : (e+1)*3D]
    with gate g's D columns at g*P. With ``backward`` also (wvt_e [T, P, P],
    wiht_e [T, 3P, P]): wv_e and w_ih_e transposed, which the backward
    kernels' transposed products read row by row. The copies are fp32
    whatever the weights' dtype: a bf16 weight is exact in fp32, and so is
    the product of two bf16 values, so the kernels read their weights the
    same way in both value types."""
    D, T = wkv_hf.shape[0], num_experts
    P = -(-D // 32) * 32
    wkv_e = wkv_hf.detach().float().view(D, 2, T, D).permute(2, 1, 0, 3)
    wih_e = w_ih.detach().float().view(D, T, 3, D).permute(1, 0, 2, 3)
    if P != D:
        wkv_e = torch.nn.functional.pad(wkv_e, (0, P - D, 0, P - D))
        wih_e = torch.nn.functional.pad(wih_e, (0, P - D, 0, 0, 0, P - D))
    wkv_e, wih_e = wkv_e.contiguous(), wih_e.reshape(T, P, 3 * P).contiguous()
    if not backward:
        return wkv_e, wih_e
    return (wkv_e, wih_e, wkv_e[:, 1].transpose(1, 2).contiguous(),
            wih_e.transpose(1, 2).contiguous())


def select_expert(stacked: torch.Tensor, expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """stacked [M, T*W] -> each row's expert slice [M, W]."""
    m = stacked.shape[0]
    w = stacked.shape[1] // num_experts
    idx = expert.long().view(m, 1, 1).expand(m, 1, w)
    return stacked.view(m, num_experts, w).gather(1, idx).squeeze(1)


def _level_forward(hf, pk, src, dslot, evalid, upd, e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k,
                   with_residuals: bool, residual_dtype: torch.dtype | None = None):
    """One level from hf [N, D] with the math of the JAX package's
    ``_level_scan_fast`` (``mgvae_tpu/models/dg_ae.py``): src / dslot / e_n
    int64, evalid / upd bool. Returns (h_new [Np, D], 0 on the slots that
    are not updated, res_e [Ep, 3D+1] or None, res_n [Np, 4D] or None),
    h_new in the value type of ``pk``, the residuals in ``residual_dtype``
    (by default the value type). In bf16 the values are rounded where the
    JAX package's ``_level_body`` rounds them (``level_kernel.py:418-420``:
    v * attn before the message sum; ``:427``: msg before the GRU product;
    ``:446-462``: the residuals and h_new) and computed in fp32 between;
    with fp32 residuals they are the unrounded values, msg its sum before
    the rounding that feeds the GRU product, as the giant backward
    recomputes them (``:1375-1410``)."""
    vdt = pk.dtype
    rnd = rounder(vdt)
    hf, pk, wkv_hf, w_ih, b_ih, b_hh, wa_k = (
        t.float() for t in (hf, pk, wkv_hf, w_ih, b_ih, b_hh, wa_k))
    D = pk.shape[1] - 2
    T = wa_k.shape[0]
    np_ = upd.shape[0]
    e_edge = pk[:, D + 1].long()
    hf_src = hf[src]
    kv = hf_src @ wkv_hf                                        # [Ep, 2TD]
    khf = select_expert(kv[:, : T * D], e_edge, T)
    vhf = select_expert(kv[:, T * D :], e_edge, T)
    score = pk[:, D] + (khf * wa_k[e_edge]).sum(-1)
    v = pk[:, :D] + vhf
    attn = segment_softmax(score, dslot, np_, valid=evalid)
    msg = segment_sum(rnd(v * attn[:, None]), dslot, np_)       # [Np, D]

    gi = select_expert(rnd(msg) @ w_ih, e_n, T) + b_ih[e_n]
    gh = b_hh[e_n]                                              # h == 0
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = torch.where(upd[:, None], (1.0 - z) * n, 0.0).to(vdt)
    if not with_residuals:
        return h_new, None, None
    live = (evalid & upd[dslot])[:, None]
    res_e = torch.where(live, torch.cat([hf_src, khf, v, attn[:, None]], 1), 0.0)
    res_n = torch.where(upd[:, None], torch.cat([msg, r, z, n], 1), 0.0)
    rdt = residual_dtype or vdt
    return h_new, res_e.detach().to(rdt), res_n.detach().to(rdt)


def _level_backward(g, res_e, res_n, pk, dslot, evf, e_n, wkv_hf, w_ih, b_hh, wa_k,
                    carry_dtype: torch.dtype | None = None):
    """One level's backward, written out as the JAX package's
    ``_level_bwd_body`` (``level_kernel.py:645-778``): g [Np, D] is the
    cotangent of h_new, already 0 on the slots that are not updated; evf the
    edge mask as float. Returns (d_pack [Ep, D+2] in the value type of
    ``pk``, d_wkv, d_wih, d_bih, d_bhh, d_wak in fp32, dhf_src [Ep, D]: the
    sources' gradients per edge, masked). In bf16 the values are rounded
    where ``_level_bwd_body`` rounds them: dgi before the dmsg product
    (``level_kernel.py:728``), dmsg (``:732``), dk | dv before the dhf_src
    product (``:750``), d_pack (``:758``), and dhf_src to ``carry_dtype``,
    the type of hf's carried cotangent (by default the value type,
    ``:774-778``; fp32 in the giant backward, ``:1486-1518``: unrounded)."""
    vdt = pk.dtype
    rnd = rounder(vdt)
    g, res_e, res_n, wkv_hf, w_ih, b_hh, wa_k = (
        t.float() for t in (g, res_e, res_n, wkv_hf, w_ih, b_hh, wa_k))
    ep, pw = pk.shape
    D, T = pw - 2, wa_k.shape[0]
    np_ = g.shape[0]
    hf_src, khf, v, attn = res_e.split([D, D, D, 1], dim=1)
    attn = attn[:, 0]
    msg, r, z, nw = res_n.split(D, dim=1)

    # cotangent of h_new = (1 - z) * nw
    dnw = g * (1.0 - z)
    dz = -g * nw
    dnu = dnw * (1.0 - nw * nw)                                 # pre-tanh
    dr = dnu * b_hh[e_n][:, 2 * D :]
    dzeta = dz * z * (1.0 - z)                                  # pre-sigmoid z
    drho = dr * r * (1.0 - r)                                   # pre-sigmoid r
    dgi = torch.cat([drho, dzeta, dnu], 1)                      # [Np, 3D]
    dbh = torch.cat([drho, dzeta, dnu * r], 1)
    onehot_n = torch.nn.functional.one_hot(e_n, T).to(g.dtype)  # [Np, T]
    dgi_all = (onehot_n[:, :, None] * dgi[:, None, :]).reshape(np_, 3 * T * D)
    d_wih = msg.T @ dgi_all
    d_bih = onehot_n.T @ dgi
    d_bhh = onehot_n.T @ dbh
    dmsg = rnd(rnd(dgi_all) @ w_ih.T)                           # [Np, D]

    # attention backward over the in-edges
    per_edge = dmsg[dslot] * evf[:, None]
    dv = attn[:, None] * per_edge
    dattn = (v * per_edge).sum(-1)
    s_grp = segment_sum(attn * dattn * evf, dslot, np_)
    dscore = attn * (dattn - s_grp[dslot]) * evf
    e_edge = pk[:, D + 1].long()
    onehot_e = torch.nn.functional.one_hot(e_edge, T).to(g.dtype) * evf[:, None]
    dkhf = dscore[:, None] * wa_k[e_edge]
    d_wak = onehot_e.T @ (dscore[:, None] * khf)
    dkv = torch.cat([(onehot_e[:, :, None] * dkhf[:, None, :]).reshape(ep, T * D),
                     (onehot_e[:, :, None] * dv[:, None, :]).reshape(ep, T * D)], 1)
    d_wkv = hf_src.T @ dkv
    dhf_src = rounder(carry_dtype or vdt)((rnd(dkv) @ wkv_hf.T) * evf[:, None])   # [Ep, D]
    d_pack = torch.zeros_like(pk)                               # no gradient for the expert column
    d_pack[:, :D] = dv
    d_pack[:, D] = dscore
    return d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, dhf_src


def level_scan_reference(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                         wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
                         num_levels: int, with_residuals: bool = False):
    """Eager loop over levels; returns hf [N, D], or with ``with_residuals``
    (hf, res_e, res_n), the residuals detached.

    Every slot is written: ``h_new`` where ``lv_upd`` is set, else 0 (the
    padding slots all point at the dump row, which so stays 0). Autograd
    differentiates the loop: the in-place row write is legal because the
    earlier reads ``hf[src]`` save only their indices, not hf."""
    return _forward_sweep((pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                           wkv_hf, w_ih, b_ih, b_hh, wa_k), (num_levels,), num_nodes,
                          with_residuals)


def level_scan_step_reference(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                              wkv_hf, w_ih, b_ih, b_hh, wa_k, n_levels, n_sub: int,
                              with_residuals: bool = False):
    """The step route's forward: the tables hold C = len(n_levels) chunks
    of L rows each, chunk-local node ids, chunk k's real levels at rows
    [k * L, k * L + n_levels[k]) and its nodes at hf rows [k * n_sub,
    (k + 1) * n_sub). Returns hf [C * n_sub, D], or with ``with_residuals``
    (hf, res_e [C * L, Ep, 3D+1], res_n [C * L, Np, 4D]), the residuals
    detached and 0 on the rows of padding levels. Autograd differentiates
    it."""
    return _forward_sweep((pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                           wkv_hf, w_ih, b_ih, b_hh, wa_k), tuple(n_levels), n_sub,
                          with_residuals)


def _forward_sweep(args, n_levels: tuple, n_sub: int, with_residuals: bool):
    """Chunk by chunk, level by level: each level from its chunk's rows of hf,
    its new rows written into them (``level_scan_step_reference``)."""
    (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n, *weights) = args
    R, ep, pw = pack_lv.shape
    C, D, np_ = len(n_levels), pw - 2, lv_nodes.shape[1]
    L = R // C
    hf = pack_lv.new_zeros((C * n_sub, D))
    if with_residuals:
        res_e = pack_lv.new_zeros((R, ep, 3 * D + 1))
        res_n = pack_lv.new_zeros((R, np_, 4 * D))
    for k, levels in enumerate(n_levels):
        hf_k = hf.narrow(0, k * n_sub, n_sub)
        for row in range(k * L, k * L + levels):
            h_new, re, rn = _level_forward(
                hf_k, pack_lv[row], lv_src[row].long(), lv_dslot[row].long(),
                lv_evalid[row] > 0, lv_upd[row] > 0, lv_e_n[row].long(), *weights,
                with_residuals)
            hf[lv_nodes[row].long() + k * n_sub] = h_new
            if with_residuals:
                res_e[row], res_n[row] = re, rn
    if with_residuals:
        return hf, res_e, res_n
    return hf


def _reverse_sweep(ghf, residuals_of, pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd,
                   lv_e_n, wkv_hf, w_ih, b_hh, wa_k, n_levels: tuple, n_sub: int = 0,
                   chunk_levels: int = 1, carry_dtype: torch.dtype | None = None):
    """The reverse sweep over levels with hf's cotangent ``ghf`` carried back
    to the sources, for tables of C = len(n_levels) chunks of L rows each
    (chunk k's real levels at rows k * L + lv, lv < n_levels[k], its nodes at
    hf rows k * n_sub on; a plain batch is C == 1); ``residuals_of(row)``
    gives a row's (res_e, res_n). The level indices go from the top in
    blocks of ``chunk_levels`` (``giant_chunks``): a block's residuals are
    all taken first, then its level indices swept, each for every chunk,
    the weight gradients summed per chunk and the chunks' sums added to the
    totals in chunk order. Returns (d_pack [C * L, Ep, D+2], d_wkv, d_wih,
    d_bih, d_bhh, d_wak); the pack's expert column gets no gradient. In
    bf16 d_pack is bf16 and ghf is carried in ``carry_dtype`` (by default
    bf16: the fused and step routes; fp32 in the giant backward); the
    weight gradients are summed in fp32 and returned in the weights'
    dtypes."""
    ghf = ghf.detach().to(carry_dtype or pack_lv.dtype, copy=True)
    d_pack = torch.zeros_like(pack_lv)
    sums = [torch.zeros_like(t, dtype=torch.float32) for t in (wkv_hf, w_ih, b_hh, b_hh, wa_k)]
    L = pack_lv.shape[0] // len(n_levels)
    for begin, end in giant_chunks(max(n_levels), chunk_levels):
        live = [[(k, k * L + lv) for k, levels in enumerate(n_levels) if lv < levels]
                for lv in range(begin, end)]
        residuals = {row: residuals_of(row) for rows in live for _, row in rows}
        chunk = [[torch.zeros_like(t) for t in sums] for _ in n_levels]
        for rows in reversed(live):
            for k, row in rows:
                off = k * n_sub
                g = torch.where((lv_upd[row] > 0)[:, None], ghf[lv_nodes[row].long() + off], 0.0)
                d_pack[row], *grads, dhf_src = _level_backward(
                    g, *residuals[row], pack_lv[row], lv_dslot[row].long(),
                    (lv_evalid[row] > 0).to(ghf.dtype), lv_e_n[row].long(), wkv_hf, w_ih, b_hh,
                    wa_k, ghf.dtype)
                for acc, x in zip(chunk[k], grads):
                    acc += x
                _add_sources(ghf, lv_src[row].long() + off, dhf_src)
        for part in chunk:
            for acc, x in zip(sums, part):
                acc += x
    return (d_pack, *(x.to(t.dtype) for x, t in zip(sums, (wkv_hf, w_ih, b_hh, b_hh, wa_k))))


def _add_sources(ghf, src, dhf_src):
    """ghf[src] += dhf_src, the level's rows of one source summed first. In
    bf16 (ghf's dtype) as the JAX package's scatter (``level_kernel.py:774-778``):
    the fp32 sum of a source's rows rounded, then added to its row of ghf
    and rounded again."""
    if ghf.dtype == torch.float32:
        ghf.index_add_(0, src, dhf_src)
        return
    add = torch.zeros(ghf.shape, dtype=torch.float32, device=ghf.device)
    add.index_add_(0, src, dhf_src)
    rows = torch.unique(src)
    ghf[rows] = (ghf[rows].float() + add[rows].to(ghf.dtype).float()).to(ghf.dtype)


def level_scan_bwd_reference(ghf, res_e, res_n, pack_lv, lv_src, lv_dslot, lv_evalid,
                             lv_nodes, lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k,
                             num_levels: int):
    """The fused backward's math: the reverse sweep over the saved
    residuals. Returns (d_pack [L, Ep, D+2], d_wkv, d_wih, d_bih, d_bhh,
    d_wak)."""
    return _reverse_sweep(ghf, lambda lv: (res_e[lv], res_n[lv]), pack_lv, lv_src, lv_dslot,
                          lv_evalid, lv_nodes, lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k,
                          (num_levels,))


def level_scan_step_bwd_reference(ghf, res_e, res_n, pack_lv, lv_src, lv_dslot, lv_evalid,
                                  lv_nodes, lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k, n_levels,
                                  n_sub: int, chunk_levels: int | None = None):
    """The step route's backward: from hf's cotangent ghf [C * n_sub, D] and
    the stacked residuals of ``level_scan_step_reference``, the reverse sweep
    over the level indices with ghf carried in place, each level index for
    every chunk. ``chunk_levels`` None: a level index at a time; K: in the
    kernel's order, the level indices from the top in blocks of K, each
    block's weight gradients summed per chunk and the sums added in chunk
    order. Returns (d_pack [C * L, Ep, D+2], 0 on the rows not walked,
    d_wkv, d_wih, d_bih, d_bhh, d_wak)."""
    return _reverse_sweep(ghf, lambda row: (res_e[row], res_n[row]), pack_lv, lv_src,
                          lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n, wkv_hf, w_ih, b_hh,
                          wa_k, tuple(n_levels), n_sub, chunk_levels or 1)


def level_scan_giant_reference(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                               wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
                               num_levels: int) -> torch.Tensor:
    """The giant forward's math: hf [N, D] and nothing else. The same eager
    loop as ``level_scan_reference``; autograd differentiates it."""
    return level_scan_reference(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                                wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes, num_levels)


def level_scan_giant_bwd_reference(ghf, hf, pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes,
                                   lv_upd, lv_e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k,
                                   num_levels: int, chunk_levels: int | None = None):
    """The giant backward's math: the reverse sweep with each level's
    residuals recomputed from the forward's final hf [N, D] (exact: a
    level's sources all lie at lower levels, and with one round their rows
    are final before it runs). ``chunk_levels`` None: a level at a time;
    K: in the kernel's order, the levels from the top in chunks of K, each
    chunk recomputed, swept, and its weight gradients summed and added.
    Returns (d_pack [L, Ep, D+2], d_wkv, d_wih, d_bih, d_bhh, d_wak). In
    bf16 it rounds where the JAX package's giant backward does
    (``_level_bwd_kernel_hbm``, ``level_kernel.py:1375-1564``), not where
    the fused one does: the recomputed values stay fp32 (only the products'
    operands are rounded), ghf is carried in fp32 from a copy of the bf16
    cotangent, and each level's dhf_src is added into it unrounded; d_pack
    is bf16."""
    def recompute(lv):
        with torch.no_grad():
            _, res_e, res_n = _level_forward(
                hf, pack_lv[lv], lv_src[lv].long(), lv_dslot[lv].long(), lv_evalid[lv] > 0,
                lv_upd[lv] > 0, lv_e_n[lv].long(), wkv_hf, w_ih, b_ih, b_hh, wa_k, True,
                residual_dtype=torch.float32)
        return res_e, res_n

    return _reverse_sweep(ghf, recompute, pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes,
                          lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k, (num_levels,),
                          chunk_levels=chunk_levels or 1, carry_dtype=torch.float32)


def giant_chunks(num_levels: int, chunk_levels: int) -> list[tuple[int, int]]:
    """The giant backward's chunks of levels [0, num_levels) as (begin, end),
    in the order it takes them: from the top, ``chunk_levels`` levels each,
    the last (lowest) chunk ragged."""
    if chunk_levels < 1:
        raise ValueError(f"chunk_levels must be >= 1, got {chunk_levels}")
    return [(max(top - chunk_levels, 0), top)
            for top in range(num_levels, 0, -chunk_levels)]


def _giant_scratch_floats(ep: int, np_: int, dim: int, num_experts: int):
    """(floats per level of a chunk, floats per chunk whatever its size) of
    the giant backward's scratch: per level res_e, res_n, dkv, dg, score_buf,
    v_buf and a weight-gradient partial; per chunk dhf_buf."""
    partial = num_experts * dim * (5 * dim + 7)
    return ep * (6 * dim + 2) + np_ * 10 * dim + partial, ep * dim


def giant_chunk_levels(ep: int, np_: int, dim: int, levels: int, num_nodes: int,
                       num_experts: int = MAX_EXPERTS) -> int:
    """K, the levels per chunk of the giant backward, for level tables of
    ``levels`` levels [levels, Ep] / [levels, Np], D = ``dim``, N =
    ``num_nodes``: as many as the scratch budget allows, at least 1, at most
    ``levels``. The budget is SCRATCH_SHARE of the bytes the route
    holds anyway (hf and ghf's working copy, 2 N D floats, and d_pack_lv,
    L Ep (D+2)), at least SCRATCH_FLOOR, so that the route's working
    memory stays within a fixed share above what it holds anyway
    (``chip_smoke.py`` phase 17 allows 1.25 x those bytes)."""
    per_level, fixed = _giant_scratch_floats(ep, np_, dim, num_experts)
    held = 4 * (2 * num_nodes * dim + levels * ep * (dim + 2))
    budget = max(SCRATCH_FLOOR, SCRATCH_SHARE * held)
    return int(max(1, min(levels, (budget / 4 - fixed) // per_level)))


def giant_bwd_launch_count(num_levels: int, chunk_levels: int) -> int:
    """The giant backward's launches for ``num_levels`` real levels in
    chunks of ``chunk_levels``: per chunk a recompute, a sweep and the
    weight-gradient partials, a partial per level, and their sums where the
    chunk has more than one level."""
    return sum(3 + (end - begin > 1) for begin, end in giant_chunks(num_levels, chunk_levels))


def _step_scratch_floats(ep: int, np_: int, dim: int, chunks: int, num_experts: int):
    """(floats per level index of a block, floats per block whatever its
    size) of the step route's backward scratch: per level index each chunk's
    dkv and dg rows, and a weight-gradient partial; per block each chunk's
    dhf_buf."""
    partial = num_experts * dim * (5 * dim + 7)
    return chunks * (ep * 2 * dim + np_ * 6 * dim) + partial, chunks * ep * dim


def step_chunk_levels(ep: int, np_: int, dim: int, rows: int, chunks: int, num_nodes: int,
                      num_experts: int = MAX_EXPERTS) -> int:
    """K, the level indices per block of the step route's backward, for
    ``chunks`` chunks of ``rows`` level rows [rows, Ep] / [rows, Np] each,
    D = ``dim``, ``num_nodes`` = C * N_sub: as many as the scratch budget
    allows, at least 1, at most ``rows``. The budget is SCRATCH_SHARE of
    the bytes the route holds anyway (the stacked residuals, C L (Ep (3D+1) +
    Np 4D) floats, hf and ghf's working copy, 2 N D, and d_pack_lv,
    C L Ep (D+2)), at least SCRATCH_FLOOR, so that the route's working
    memory stays within a fixed share above what it holds anyway
    (``chip_smoke.py`` phase 12 allows 1.25 x those bytes)."""
    per_level, fixed = _step_scratch_floats(ep, np_, dim, chunks, num_experts)
    held = 4 * (2 * num_nodes * dim + chunks * rows * (
        ep * (dim + 2) + ep * (3 * dim + 1) + np_ * 4 * dim))
    budget = max(SCRATCH_FLOOR, SCRATCH_SHARE * held)
    return int(max(1, min(rows, (budget / 4 - fixed) // per_level)))


def step_route_launch_count(n_levels, chunk_levels: int) -> int:
    """The step route's backward launches for chunks of ``n_levels`` real
    levels in blocks of ``chunk_levels`` level indices: per level index a
    slot launch and a source launch (all chunks in each), and per block and
    chunk with real levels in it the weight-gradient partials, a partial per
    level, and their sum where it has more than one. (Its forward launches
    once per level index: max(n_levels).)"""
    count = 0
    for begin, end in giant_chunks(max(n_levels), chunk_levels):
        count += 2 * (end - begin)
        for levels in n_levels:
            rows = min(end, levels) - begin
            count += (rows > 0) + (rows > 1)
    return count


def level_step_reference(hf, pack, src, dslot, evalid, upd, e_n,
                         wkv_hf, w_ih, b_ih, b_hh, wa_k, with_residuals: bool = False):
    """The step kernel's math: h_new [Np, D] of one level from hf [N, D],
    0 on the slots where ``upd`` is 0 and not scattered; with
    ``with_residuals`` (h_new, res_e [Ep, 3D+1], res_n [Np, 4D]), the
    residuals detached. Autograd differentiates it, hf included."""
    h_new, res_e, res_n = _level_forward(
        hf, pack, src.long(), dslot.long(), evalid > 0, upd > 0, e_n.long(),
        wkv_hf, w_ih, b_ih, b_hh, wa_k, with_residuals)
    return (h_new, res_e, res_n) if with_residuals else h_new


def level_step_bwd_reference(g, res_e, res_n, pack, src, dslot, evalid, upd, e_n,
                             wkv_hf, w_ih, b_hh, wa_k, num_nodes: int):
    """The step backward's math: from the cotangent g [Np, D] of h_new and
    one level's residuals, (d_pack [Ep, D+2], d_wkv, d_wih, d_bih, d_bhh,
    d_wak, d_hf [num_nodes, D]); d_hf holds the sources' gradients, summed
    per source (in bf16 each source's fp32 sum rounded, as the JAX step
    backward's, ``level_kernel.py:774-778``), in the value type; the weight
    gradients fp32."""
    g = torch.where((upd > 0)[:, None], g.detach().to(pack.dtype), 0.0)
    *grads, dhf_src = _level_backward(
        g, res_e, res_n, pack, dslot.long(), (evalid > 0).to(g.dtype), e_n.long(),
        wkv_hf, w_ih, b_hh, wa_k)
    d_hf = g.new_zeros((num_nodes, g.shape[1]))
    _add_sources(d_hf, src.long(), dhf_src)
    return (*grads, d_hf)


def level_scan(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
               wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
               num_levels: int, lists: LevelLists | None = None,
               packed: tuple | None = None) -> torch.Tensor:
    """Level recurrence over levels [0, num_levels) of the tables.

    pack_lv [L, Ep, D+2]: per edge [vhs | score_static | expert];
    lv_src / lv_dslot / lv_evalid [L, Ep] and lv_nodes / lv_upd / lv_e_n
    [L, Np] int32; wkv_hf [D, 2TD], w_ih [D, 3TD], b_ih / b_hh [T, 3D],
    wa_k [T, D]; the float arguments all fp32, or all bf16 (the value type:
    hf, the residuals and the backward's d_pack and carried d_hf are then
    bf16, with fp32 accumulation). Returns hf [num_nodes, D] in the value
    type, differentiable with respect to pack_lv, wkv_hf, w_ih, b_ih, b_hh
    and wa_k. ``lists``: the tables' ``level_lists``, and ``packed``: the
    weights' ``repack_expert_major(wkv_hf, w_ih, T, backward=True)``, for a
    caller that built them already for several calls (only the kernels read
    them).

    On CPU tensors training goes through ``_LevelScan`` with the plain
    versions of both kernels, so that the CPU rounds where the kernels do.
    """
    args = (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
            wkv_hf, w_ih, b_ih, b_hh, wa_k)
    _check(args, num_nodes, num_levels)
    dev = pack_lv.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"level_scan: no kernel for device {dev}")
    if dev.type == "cuda":
        _check_prepared("level_scan", args, lists, packed)
    if torch.is_grad_enabled() and any(args[i].requires_grad for i in FLOAT_ARGS):
        return _LevelScan.apply(num_nodes, num_levels, (lists, packed), *args)
    if dev.type == "cpu":
        return level_scan_reference(*args, num_nodes, num_levels)
    return _forward_cuda(args, num_nodes, num_levels, residuals=False, lists=lists,
                         packed=packed)


class _LevelScan(torch.autograd.Function):
    """The forward with residuals and the backward from them: on CUDA
    tensors the kernels, on CPU tensors their plain versions.
    Counterpart of the JAX package's custom VJP ``pallas_level_scan``. The
    backward runs in the forward's matmul precision."""

    @staticmethod
    def forward(ctx, num_nodes, num_levels, prepared, *args):
        ctx.precision = current_precision()
        ctx.num_levels = num_levels
        if args[0].is_cuda:
            ctx.lists, ctx.packed = _prepared(args, *prepared, backward=True)
            hf, res_e, res_n = _forward_cuda(args, num_nodes, num_levels, residuals=True,
                                             lists=ctx.lists, packed=ctx.packed)
        else:
            hf, res_e, res_n = level_scan_reference(*args, num_nodes, num_levels,
                                                    with_residuals=True)
        ctx.save_for_backward(*args, res_e, res_n)
        return hf

    @staticmethod
    def backward(ctx, ghf):
        *args, res_e, res_n = ctx.saved_tensors
        with matmul_precision(ctx.precision):
            if ghf.is_cuda:
                grads = _backward_cuda(ghf, res_e, res_n, tuple(args), ctx.num_levels,
                                       lists=ctx.lists, packed=ctx.packed)
            else:
                grads = level_scan_bwd_reference(ghf, res_e, res_n,
                                                 *(args[i] for i in (0, 1, 2, 3, 4, 5, 6, 7, 8,
                                                                     10, 11)), ctx.num_levels)
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak = grads
        d_bih = d_bih.to(args[9].dtype)
        # (num_nodes, num_levels, prepared, pack_lv, 6 int tables, wkv_hf, w_ih, b_ih, b_hh, wa_k)
        return (None, None, None, d_pack) + (None,) * 6 + (d_wkv, d_wih, d_bih, d_bhh, d_wak)


def _kernel_dims(pack_lv, wa_k):
    D, T = pack_lv.shape[-1] - 2, wa_k.shape[0]
    if D > MAX_DIM or T > MAX_EXPERTS:
        raise ValueError(f"the level kernels take D <= {MAX_DIM} and T <= "
                         f"{MAX_EXPERTS}, got D={D}, T={T} (a kernel limit: wider models "
                         f"take the plain route, models/dg_ae.level_scan_fast)")
    return D, T


def _prepared(args, lists: LevelLists | None = None, packed=None, backward: bool = False):
    """(lists, packed) of ``level_scan``'s 12 arguments or of ``level_step``'s
    last 11, built where the caller has none: the tables' ``level_lists``
    and the weights' ``repack_expert_major``, with ``backward`` its
    transposed slices too."""
    _, lv_src, lv_dslot, lv_evalid, *rest = args
    lv_upd, lv_e_n, wkv_hf, w_ih = rest[-7:-3]
    T = args[-1].shape[0]
    if lists is None:
        lists = level_lists(lv_src, lv_dslot, lv_evalid, lv_upd, lv_e_n, T)
    if packed is None or (backward and len(packed) < 4):
        packed = repack_expert_major(wkv_hf, w_ih, T, backward)
    return lists, packed


def _check_prepared(op: str, args, lists, packed) -> None:
    """Shape, dtype, device and contiguity checks of a caller's ``lists``
    and ``packed`` against ``level_scan``'s 12 arguments or ``level_step``'s
    last 11."""
    lv_src, lv_upd, wkv_hf = args[1], args[-7], args[-5]
    T, D = args[-1].shape
    if lists is not None:
        rows = 1 if lv_src.dim() == 1 else lv_src.shape[0]
        ep, np_ = lv_src.shape[-1], lv_upd.shape[-1]
        want = [((rows, n), torch.int32) for n in (np_, T + 1, ep, np_ + 1, ep)]
        _check_tensors(f"{op} lists", LevelLists._fields, lists, want, lv_src.device)
    if packed is not None:
        P = -(-D // 32) * 32
        want = [((T, 2, P, P), torch.float32), ((T, P, 3 * P), torch.float32),
                ((T, P, P), torch.float32), ((T, 3 * P, P), torch.float32)][:len(packed)]
        _check_tensors(f"{op} packed", ("wkv_e", "wih_e", "wvt_e", "wiht_e"), packed, want,
                       wkv_hf.device)


def _scratch(dev, *floats: int):
    """Float scratch areas of the given sizes in one allocation: (the buffer,
    to be held until the launch is enqueued, and each area's device
    pointer, 256-byte aligned). One allocation where a route makes a call
    per level and the host is what it waits for."""
    sizes = [-(-n // 64) * 64 for n in floats]
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=dev)
    ptrs, at = [], buf.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    return buf, ptrs


def _weight_grads(flat: torch.Tensor, D: int, T: int, dtypes=None):
    """The five weight gradients as views of the buffer the kernels fill:
    d_wkv [D, 2TD], d_wih [D, 3TD], d_bih, d_bhh [T, 3D], d_wak [T, D];
    with ``dtypes`` each rounded once to its weight's dtype (the kernels sum
    them in fp32, ``level_kernel.py:834-839``)."""
    sizes = (D * 2 * T * D, D * 3 * T * D, T * 3 * D, T * 3 * D, T * D)
    shapes = ((D, 2 * T * D), (D, 3 * T * D), (T, 3 * D), (T, 3 * D), (T, D))
    out = tuple(x.view(shape) for x, shape in zip(flat.split(sizes), shapes))
    return out if dtypes is None else tuple(x.to(d) for x, d in zip(out, dtypes))



def _launch_forward(args, num_nodes: int, num_levels: int, residuals: bool,
                    lists: LevelLists | None, packed, what: str):
    """The fused forward's persistent launch (``csrc/level_scan.cu``), which
    walks all real levels: (hf, res_e, res_n), the residuals None without
    ``residuals``. It launches where ``num_levels`` > 0."""
    pack_lv, lv_src, lv_nodes, b_ih, b_hh, wa_k = (args[i] for i in (0, 1, 4, 9, 10, 11))
    L, ep, _ = pack_lv.shape
    np_ = lv_nodes.shape[1]
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    lists, packed = _prepared(args, lists, packed)
    # the value type: hf and the residuals; the small vectors go as fp32 copies
    vdt = dict(dtype=pack_lv.dtype, device=dev)
    b_ih, b_hh, wa_k = (t.float().contiguous() for t in (b_ih, b_hh, wa_k))
    hf = torch.zeros((num_nodes, D), **vdt)
    res_e = torch.empty((L, ep, 3 * D + 1), **vdt) if residuals else None
    res_n = torch.empty((L, np_, 4 * D), **vdt) if residuals else None
    if num_levels > 0:
        held, scratch = _scratch(dev, ep, ep * D)              # score_buf, v_buf
        barrier = torch.empty((1,), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.mgvae_level_scan_forward(
                *(t.data_ptr() for t in (pack_lv, lv_src, lv_nodes, *lists[:4], *packed[:2],
                                         b_ih, b_hh, wa_k, hf)), *scratch,
                res_e.data_ptr() if residuals else None,
                res_n.data_ptr() if residuals else None, barrier.data_ptr(),
                num_levels, ep, np_, D, T, bf16_flag(pack_lv), stream)
        _build.check(lib, code, f"{what} kernel launch")
    return hf, res_e, res_n


def _forward_cuda(args, num_nodes: int, num_levels: int, residuals: bool,
                  lists: LevelLists | None = None, packed=None):
    global launches, levels_walked
    hf, res_e, res_n = _launch_forward(args, num_nodes, num_levels, residuals, lists, packed,
                                       "level_scan")
    if num_levels > 0:
        launches += 1
        levels_walked += num_levels
    return (hf, res_e, res_n) if residuals else hf


def _backward_cuda(ghf, res_e, res_n, args, num_levels: int,
                   lists: LevelLists | None = None, packed=None):
    global bwd_launches, bwd_levels_walked
    pack_lv, lv_src, lv_nodes, wkv_hf, b_hh, wa_k = (args[i] for i in (0, 1, 4, 7, 10, 11))
    L, ep, pw = pack_lv.shape
    np_ = lv_nodes.shape[1]
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    lists, (wkv_e, _, wvt_e, wiht_e) = _prepared(args, lists, packed, backward=True)
    f32 = dict(dtype=torch.float32, device=dev)
    vdt = dict(dtype=pack_lv.dtype, device=dev)
    bf16 = bf16_flag(pack_lv)
    d_pack = torch.zeros((L, ep, pw), **vdt)
    n_grad = T * D * (5 * D + 7)
    primal = [args[i].dtype for i in (7, 8, 9, 10, 11)]
    if num_levels == 0:
        return (d_pack, *_weight_grads(torch.zeros((n_grad,), **f32), D, T, primal))
    # a contiguous working copy in the value type: autograd may hand over an
    # expanded or shared cotangent, and the kernel adds the sources'
    # gradients into it
    g = torch.empty((ghf.shape[0], D), **vdt)
    g.copy_(ghf)
    b_hh, wa_k = (t.float().contiguous() for t in (b_hh, wa_k))
    per_block = max(LEVELS_PER_BLOCK, -(-num_levels // 32))
    chunks = -(-num_levels // per_block)
    grads = torch.empty((n_grad,), **f32)
    scratch = [torch.empty(shape, **f32) for shape in (
        (L, ep, 2 * D), (L, np_, 6 * D), (ep, D))]            # dkv, dg, dhf_buf
    partial = torch.empty((chunks, n_grad), **f32) if chunks > 1 else None
    # bf16: wk_e^T for the per-edge dhf_src product, and dscore in fp32 for d_wak
    wkt_e = wkv_e[:, 0].transpose(1, 2).contiguous() if bf16 else None
    dscore = torch.empty((L, ep), **f32) if bf16 else None
    barrier = torch.empty((1,), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_backward(
            *(t.data_ptr() for t in (g, res_e, res_n, lv_src, lv_nodes, *lists, wkv_e, wvt_e,
                                     wiht_e, b_hh, wa_k, d_pack, *scratch, grads)),
            ptr(partial), ptr(wkt_e), ptr(dscore), barrier.data_ptr(),
            num_levels, per_block, ep, np_, D, T, bf16, stream)
    _build.check(lib, code, "level_scan_bwd kernel launch")
    bwd_launches += 2 if chunks == 1 else 3
    bwd_levels_walked += num_levels
    return (d_pack, *_weight_grads(grads, D, T, primal))


def level_scan_giant(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                     wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
                     num_levels: int, lists: LevelLists | None = None,
                     packed: tuple | None = None) -> torch.Tensor:
    """Level recurrence over levels [0, num_levels) of one batch's tables at
    any size, keeping no residuals: arguments and result as ``level_scan``'s.
    Training saves hf alone; the backward recomputes each level from it.
    On CPU tensors training goes through ``_LevelScanGiant`` with the plain
    versions of both kernels, so that the CPU rounds where kernel 4 does."""
    args = (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
            wkv_hf, w_ih, b_ih, b_hh, wa_k)
    _check(args, num_nodes, num_levels, op="level_scan_giant")
    dev = pack_lv.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"level_scan_giant: no kernel for device {dev}")
    if dev.type == "cuda":
        _check_prepared("level_scan_giant", args, lists, packed)
    if torch.is_grad_enabled() and any(args[i].requires_grad for i in FLOAT_ARGS):
        return _LevelScanGiant.apply(num_nodes, num_levels, (lists, packed), *args)
    if dev.type == "cpu":
        return level_scan_giant_reference(*args, num_nodes, num_levels)
    return _giant_forward_cuda(args, num_nodes, num_levels, lists=lists, packed=packed)


class _LevelScanGiant(torch.autograd.Function):
    """The giant forward, which saves its result hf and no residuals, and
    the giant backward, which recomputes from it: on CUDA tensors the
    kernels, on CPU tensors their plain versions, the backward
    in the kernel's chunks of levels. Counterpart of the JAX package's
    custom VJP ``pallas_level_scan_hbm``. The backward runs in the forward's
    matmul precision."""

    @staticmethod
    def forward(ctx, num_nodes, num_levels, prepared, *args):
        ctx.precision = current_precision()
        if args[0].is_cuda:
            ctx.lists, ctx.packed = _prepared(args, *prepared, backward=True)
            hf = _giant_forward_cuda(args, num_nodes, num_levels, lists=ctx.lists,
                                     packed=ctx.packed)
        else:
            hf = level_scan_giant_reference(*args, num_nodes, num_levels)
        ctx.num_levels = num_levels
        ctx.save_for_backward(*args, hf)
        return hf

    @staticmethod
    def backward(ctx, ghf):
        *args, hf = ctx.saved_tensors
        with matmul_precision(ctx.precision):
            if ghf.is_cuda:
                grads = _giant_backward_cuda(ghf, hf, tuple(args), ctx.num_levels,
                                             lists=ctx.lists, packed=ctx.packed)
            else:
                (L, ep, pw), np_ = args[0].shape, args[4].shape[1]
                K = giant_chunk_levels(ep, np_, pw - 2, L, hf.shape[0], args[11].shape[0])
                grads = level_scan_giant_bwd_reference(ghf, hf, *args,
                                                       num_levels=ctx.num_levels,
                                                       chunk_levels=K)
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak = grads
        # (num_nodes, num_levels, prepared, pack_lv, 6 int tables, wkv_hf, w_ih, b_ih, b_hh, wa_k)
        return (None, None, None, d_pack) + (None,) * 6 + (d_wkv, d_wih, d_bih, d_bhh, d_wak)


def _giant_forward_cuda(args, num_nodes: int, num_levels: int,
                        lists: LevelLists | None = None, packed=None) -> torch.Tensor:
    """The fused forward's persistent launch without residuals: one launch
    walks all real levels."""
    global giant_launches
    hf, _, _ = _launch_forward(args, num_nodes, num_levels, False, lists, packed,
                               "level_scan_giant")
    if num_levels > 0:
        giant_launches += 1
    return hf


def _giant_backward_cuda(ghf, hf, args, num_levels: int,
                         lists: LevelLists | None = None, packed=None,
                         chunk_levels: int | None = None):
    """Apart from its outputs (d_pack_lv is the only float buffer with a
    leading L axis) the working memory is ghf's copy and the scratch of one
    chunk of K levels: ``chunk_levels``, or by default
    ``giant_chunk_levels``. ghf's copy and the scratch are fp32 in both
    value types (in bf16 as the JAX giant backward keeps them); d_pack
    takes pack_lv's dtype."""
    global giant_bwd_launches
    pack_lv, lv_src, lv_nodes, b_ih, b_hh, wa_k = (args[i] for i in (0, 1, 4, 9, 10, 11))
    L, ep, _ = pack_lv.shape
    np_ = lv_nodes.shape[1]
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    lists, packed = _prepared(args, lists, packed, backward=True)
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = bf16_flag(pack_lv)
    b_ih, b_hh, wa_k = (t.float().contiguous() for t in (b_ih, b_hh, wa_k))
    d_pack = torch.zeros_like(pack_lv)
    n_grad = T * D * (5 * D + 7)
    primal = [args[i].dtype for i in (7, 8, 9, 10, 11)]
    # the weight gradients are added into, chunk by chunk
    grads = torch.zeros((n_grad,), **f32)
    if num_levels == 0:
        return (d_pack, *_weight_grads(grads, D, T, primal))
    K = chunk_levels or giant_chunk_levels(ep, np_, D, L, hf.shape[0], T)
    K = min(K, num_levels)
    # a contiguous fp32 working copy: autograd may hand over an expanded or
    # shared cotangent, and the kernel adds the sources' gradients into it
    g = torch.empty((hf.shape[0], D), **f32)
    g.copy_(ghf)
    # K levels' recomputed residuals and scratch; the kernels visit live rows only
    held, scratch = _scratch(
        dev, K * ep * (3 * D + 1), K * np_ * 4 * D, K * ep * 2 * D, K * np_ * 6 * D,
        K * ep, K * ep * D, ep * D,          # res_e, res_n, dkv, dg, score_buf, v_buf, dhf_buf
        K * n_grad if K > 1 else 1,                               # partial
        K * ep if bf16 else 1)                                    # dscore
    # bf16: wk_e^T for the per-edge dhf_src product, and dscore in fp32 for d_wak
    wkt_e = packed[0][:, 0].transpose(1, 2).contiguous() if bf16 else None
    barrier = torch.empty((1,), dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)             # the kernels the C entry enqueued
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_giant_backward(
            *(t.data_ptr() for t in (g, hf, pack_lv, lv_src, lv_nodes, *lists, *packed, b_ih,
                                     b_hh, wa_k, d_pack)), *scratch[:7], grads.data_ptr(),
            scratch[7], wkt_e.data_ptr() if bf16 else None, scratch[8] if bf16 else None,
            barrier.data_ptr(), ctypes.addressof(launched), num_levels, K, ep, np_, D, T, bf16,
            stream)
    _build.check(lib, code, "level_scan_giant_bwd kernel launch")
    giant_bwd_launches += launched.value
    return (d_pack, *_weight_grads(grads, D, T, primal))


def level_step(hf, pack, src, dslot, evalid, upd, e_n,
               wkv_hf, w_ih, b_ih, b_hh, wa_k, lists: LevelLists | None = None,
               packed: tuple | None = None) -> torch.Tensor:
    """One level from an explicit hf.

    hf [N, D] (read only; a contiguous row range of a larger hf will do),
    pack [Ep, D+2]: per edge [vhs | score_static | expert]; src / dslot /
    evalid [Ep] and upd / e_n [Np] int32, src indexing hf's rows; the
    weights as ``level_scan``'s; the float arguments all fp32 or all bf16.
    Returns h_new [Np, D] in the value type, in slot order, 0 where ``upd``
    is 0, not scattered; differentiable with respect to hf (through the
    source gathers), pack and the weights. ``lists``: the level's row of the
    tables' ``level_lists`` ([1, ...]), and ``packed``: the weights'
    ``repack_expert_major(wkv_hf, w_ih, T, backward=True)``, for a caller
    that built them already for several calls.

    The JAX function's ``nodes`` argument only feeds its source windows and
    has no counterpart here. On CPU tensors training goes through
    ``_LevelStep`` with both plain versions, as ``level_scan``'s.
    """
    args = (hf, pack, src, dslot, evalid, upd, e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k)
    _check_step(args)
    dev = pack.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"level_step: no kernel for device {dev}")
    if dev.type == "cuda":
        _check_prepared("level_step", args[1:], lists, packed)
    if torch.is_grad_enabled() and any(args[i].requires_grad for i in STEP_FLOAT_ARGS):
        return _LevelStep.apply((lists, packed), *args)
    if dev.type == "cpu":
        return level_step_reference(*args)
    return _step_forward_cuda(args, residuals=False, lists=lists, packed=packed)


class _LevelStep(torch.autograd.Function):
    """The step with residuals, and its backward: on CUDA tensors the
    kernels, on CPU tensors their plain versions. Counterpart of
    the JAX package's custom VJP ``pallas_level_step``.

    hf itself is not saved (res_e holds the gathered source rows), only its
    row count: the caller writes the new rows into hf in place between
    calls, and a saved hf would fail autograd's version check at the next
    write. The backward runs in the forward's matmul precision."""

    @staticmethod
    def forward(ctx, prepared, hf, *rest):
        ctx.precision = current_precision()
        if hf.is_cuda:
            ctx.lists, ctx.packed = _prepared(rest, *prepared, backward=True)
            h_new, res_e, res_n = _step_forward_cuda((hf, *rest), residuals=True,
                                                     lists=ctx.lists, packed=ctx.packed)
        else:
            h_new, res_e, res_n = level_step_reference(hf, *rest, with_residuals=True)
        ctx.num_nodes = hf.shape[0]
        ctx.save_for_backward(*rest, res_e, res_n)
        return h_new

    @staticmethod
    def backward(ctx, g):
        *rest, res_e, res_n = ctx.saved_tensors
        with matmul_precision(ctx.precision):
            if g.is_cuda:
                grads = _step_backward_cuda(g, res_e, res_n, tuple(rest), ctx.num_nodes,
                                            lists=ctx.lists, packed=ctx.packed)
            else:
                grads = level_step_bwd_reference(
                    g, res_e, res_n, *(rest[i] for i in (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)),
                    ctx.num_nodes)
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, d_hf = grads
        d_wkv, d_wih, d_bih, d_bhh, d_wak = (
            x.to(t.dtype) for x, t in zip((d_wkv, d_wih, d_bih, d_bhh, d_wak), rest[6:]))
        # (prepared, hf, pack, 5 int tables, wkv_hf, w_ih, b_ih, b_hh, wa_k)
        return (None, d_hf, d_pack) + (None,) * 5 + (d_wkv, d_wih, d_bih, d_bhh, d_wak)


def _step_forward_cuda(args, residuals: bool, lists: LevelLists | None = None, packed=None):
    global step_launches
    hf, pack, src, b_ih, b_hh, wa_k = (args[i] for i in (0, 1, 2, 9, 10, 11))
    ep, np_ = pack.shape[0], args[5].shape[0]
    D, T = _kernel_dims(pack, wa_k)
    dev = pack.device
    lib = _build.library()
    lists, packed = _prepared(args[1:], lists, packed)
    vdt = dict(dtype=pack.dtype, device=dev)       # h_new and the residuals
    b_ih, b_hh, wa_k = (t.float().contiguous() for t in (b_ih, b_hh, wa_k))
    h_new = torch.zeros((np_, D), **vdt)
    held, scratch = _scratch(dev, ep, ep * D)                 # score_buf, v_buf
    res_e = torch.empty((ep, 3 * D + 1), **vdt) if residuals else None
    res_n = torch.empty((np_, 4 * D), **vdt) if residuals else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_step_forward(
            *(t.data_ptr() for t in (hf, pack, src, *lists[:4], *packed[:2], b_ih, b_hh, wa_k,
                                     h_new)), *scratch,
            res_e.data_ptr() if residuals else None,
            res_n.data_ptr() if residuals else None, ep, np_, D, T, bf16_flag(pack), stream)
    _build.check(lib, code, "level_step kernel launch")
    step_launches += 1
    return (h_new, res_e, res_n) if residuals else h_new


def _step_backward_cuda(g, res_e, res_n, rest, num_nodes: int,
                        lists: LevelLists | None = None, packed=None):
    """``rest``: level_step's arguments after hf."""
    global step_bwd_launches
    pack, src, b_hh, wa_k = (rest[i] for i in (0, 1, 9, 10))
    ep, pw = pack.shape
    np_ = rest[4].shape[0]
    D, T = _kernel_dims(pack, wa_k)
    dev = pack.device
    lib = _build.library()
    lists, (wkv_e, _, wvt_e, wiht_e) = _prepared(rest, lists, packed, backward=True)
    f32 = dict(dtype=torch.float32, device=dev)
    vdt = dict(dtype=pack.dtype, device=dev)       # g, d_pack and d_hf
    bf16 = bf16_flag(pack)
    # autograd may hand over an expanded cotangent; only read
    g = g.to(pack.dtype).contiguous()
    b_hh, wa_k = (t.float().contiguous() for t in (b_hh, wa_k))
    d_pack = torch.zeros((ep, pw), **vdt)
    d_hf = torch.zeros((num_nodes, D), **vdt)
    held, scratch = _scratch(dev, ep * 2 * D, np_ * 6 * D, ep * D,   # dkv, dg, dhf_buf
                             ep if bf16 else 1)                      # dscore
    # bf16: wk_e^T for the per-edge dhf_src product
    wkt_e = wkv_e[:, 0].transpose(1, 2).contiguous() if bf16 else None
    grads = torch.empty((T * D * (5 * D + 7),), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_step_backward(
            *(t.data_ptr() for t in (g, res_e, res_n, src, *lists, wkv_e, wvt_e, wiht_e, b_hh,
                                     wa_k, d_pack)), *scratch[:3], grads.data_ptr(),
            d_hf.data_ptr(), wkt_e.data_ptr() if bf16 else None, scratch[3] if bf16 else None,
            ep, np_, D, T, bf16, stream)
    _build.check(lib, code, "level_step_bwd kernel launch")
    step_bwd_launches += 3
    return (d_pack, *_weight_grads(grads, D, T), d_hf)


def level_scan_step(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                    wkv_hf, w_ih, b_ih, b_hh, wa_k, n_levels, n_sub: int,
                    lists: LevelLists | None = None, packed: tuple | None = None) -> torch.Tensor:
    """The level recurrence of a chunked batch by the step route, one level
    at a time from an explicit hf (the JAX package's ``_level_scan_step``,
    ``mgvae_tpu/models/dg_ae.py:629-652``).

    The 12 arguments as ``level_scan``'s for the batch's flat [C * L, ...]
    table rows with chunk-local node ids, C = len(n_levels): chunk k's rows
    are [k * L, (k + 1) * L), its real levels the first ``n_levels[k]`` of
    them, and its nodes hf's rows [k * n_sub, (k + 1) * n_sub). Returns hf
    [C * n_sub, D], differentiable with respect to pack_lv and the weights.
    ``lists`` / ``packed`` as ``level_scan``'s. On CUDA tensors one launch
    per level index for all chunks, the new rows scattered into hf inside
    the kernel; training goes through ``_LevelScanStep``. The kernels take a
    chunk's rows past its real levels to be padding (no updated slot, so
    empty lists), as ``collate_chunked`` pads them. On CPU tensors training
    goes through ``_LevelScanStep`` with both plain versions, the backward
    in the kernel's blocks of level indices."""
    args = (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
            wkv_hf, w_ih, b_ih, b_hh, wa_k)
    n_levels = tuple(int(n) for n in n_levels)
    C = len(n_levels)
    if C < 1 or pack_lv.dim() != 3 or pack_lv.shape[0] % C:
        raise ValueError(f"level_scan_step: {C} chunks do not divide the table rows "
                         f"{tuple(pack_lv.shape)}")
    _check(args, C * n_sub, 0, op="level_scan_step")
    if not all(0 <= n <= pack_lv.shape[0] // C for n in n_levels):
        raise ValueError(f"level_scan_step: real levels {n_levels} outside "
                         f"[0, {pack_lv.shape[0] // C}]")
    dev = pack_lv.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"level_scan_step: no kernel for device {dev}")
    if dev.type == "cuda":
        _check_prepared("level_scan_step", args, lists, packed)
    if torch.is_grad_enabled() and any(args[i].requires_grad for i in FLOAT_ARGS):
        return _LevelScanStep.apply(n_levels, n_sub, (lists, packed), *args)
    if dev.type == "cpu":
        return level_scan_step_reference(*args, n_levels, n_sub)
    return _step_route_forward_cuda(args, n_levels, n_sub, residuals=False, lists=lists,
                                    packed=packed)


class _LevelScanStep(torch.autograd.Function):
    """The step route's forward with residuals, stacked over all C * L
    rows, and its backward, which carries hf's cotangent in place over the
    level indices: on CUDA tensors the kernels, on CPU tensors their plain
    versions in the kernels' order. Counterpart of ``jax.vjp``
    of the JAX package's ``_level_scan_step``. The backward runs in the
    forward's matmul precision."""

    @staticmethod
    def forward(ctx, n_levels, n_sub, prepared, *args):
        ctx.precision = current_precision()
        if args[0].is_cuda:
            ctx.lists, ctx.packed = _prepared(args, *prepared, backward=True)
            hf, res_e, res_n = _step_route_forward_cuda(args, n_levels, n_sub, residuals=True,
                                                        lists=ctx.lists, packed=ctx.packed)
        else:
            hf, res_e, res_n = level_scan_step_reference(*args, n_levels, n_sub,
                                                         with_residuals=True)
        ctx.n_levels, ctx.n_sub = n_levels, n_sub
        ctx.save_for_backward(*args, res_e, res_n)
        return hf

    @staticmethod
    def backward(ctx, ghf):
        *args, res_e, res_n = ctx.saved_tensors
        with matmul_precision(ctx.precision):
            if ghf.is_cuda:
                grads = _step_route_backward_cuda(ghf, res_e, res_n, tuple(args), ctx.n_levels,
                                                  ctx.n_sub, lists=ctx.lists, packed=ctx.packed)
            else:
                (R, ep, pw), np_, C = args[0].shape, args[4].shape[1], len(ctx.n_levels)
                K = step_chunk_levels(ep, np_, pw - 2, R // C, C, C * ctx.n_sub,
                                      args[11].shape[0])
                grads = level_scan_step_bwd_reference(
                    ghf, res_e, res_n, *args[:9], args[10], args[11], ctx.n_levels, ctx.n_sub,
                    chunk_levels=K)
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak = grads
        # (n_levels, n_sub, prepared, pack_lv, 6 int tables, wkv_hf, w_ih, b_ih, b_hh, wa_k)
        return (None, None, None, d_pack) + (None,) * 6 + (d_wkv, d_wih, d_bih, d_bhh, d_wak)


def _step_route_forward_cuda(args, n_levels, n_sub: int, residuals: bool,
                             lists: LevelLists | None = None, packed=None):
    """One launch per level index for all chunks (the C entry's loop):
    (hf, res_e, res_n), the residuals None without ``residuals``."""
    global step_launches
    pack_lv, lv_src, lv_nodes, b_ih, b_hh, wa_k = (args[i] for i in (0, 1, 4, 9, 10, 11))
    R, ep, _ = pack_lv.shape
    np_, C = lv_nodes.shape[1], len(n_levels)
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    lists, packed = _prepared(args, lists, packed)
    vdt = dict(dtype=pack_lv.dtype, device=dev)    # hf and the residuals
    b_ih, b_hh, wa_k = (t.float().contiguous() for t in (b_ih, b_hh, wa_k))
    hf = torch.zeros((C * n_sub, D), **vdt)
    res_e = torch.empty((R, ep, 3 * D + 1), **vdt) if residuals else None
    res_n = torch.empty((R, np_, 4 * D), **vdt) if residuals else None
    held, scratch = _scratch(dev, C * ep, C * ep * D)         # score_buf, v_buf
    levels = (ctypes.c_int * C)(*n_levels)
    launched = ctypes.c_int(0)             # the kernels the C entry enqueued
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_step_forward(
            *(t.data_ptr() for t in (hf, pack_lv, lv_src, lv_nodes, *lists[:4], *packed[:2],
                                     b_ih, b_hh, wa_k)), *scratch,
            res_e.data_ptr() if residuals else None, res_n.data_ptr() if residuals else None,
            ctypes.addressof(levels), ctypes.addressof(launched), C, R // C, n_sub, ep, np_, D,
            T, bf16_flag(pack_lv), stream)
    _build.check(lib, code, "level_scan_step kernel launch")
    step_launches += launched.value
    return (hf, res_e, res_n) if residuals else hf


def _step_route_backward_cuda(ghf, res_e, res_n, args, n_levels, n_sub: int,
                              lists: LevelLists | None = None, packed=None,
                              chunk_levels: int | None = None):
    """Apart from its outputs the working memory is ghf's copy and the
    scratch of one block of K level indices: ``chunk_levels``, or by default
    ``step_chunk_levels``."""
    global step_bwd_launches
    pack_lv, lv_src, lv_nodes, b_hh, wa_k = (args[i] for i in (0, 1, 4, 10, 11))
    R, ep, _ = pack_lv.shape
    np_, C = lv_nodes.shape[1], len(n_levels)
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    lists, (wkv_e, _, wvt_e, wiht_e) = _prepared(args, lists, packed, backward=True)
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = bf16_flag(pack_lv)
    d_pack = torch.zeros_like(pack_lv)
    n_grad = T * D * (5 * D + 7)
    primal = [args[i].dtype for i in (7, 8, 9, 10, 11)]
    grads = torch.zeros((n_grad,), **f32)      # added into, block by block and chunk by chunk
    top = max(n_levels)
    if top == 0:
        return (d_pack, *_weight_grads(grads, D, T, primal))
    K = min(chunk_levels or step_chunk_levels(ep, np_, D, R // C, C, C * n_sub, T), top)
    # a contiguous working copy in the value type: autograd may hand over an
    # expanded or shared cotangent, and the kernels add the sources'
    # gradients into it
    g = torch.empty((C * n_sub, D), dtype=pack_lv.dtype, device=dev)
    g.copy_(ghf)
    b_hh, wa_k = (t.float().contiguous() for t in (b_hh, wa_k))
    held, scratch = _scratch(dev, C * K * ep * 2 * D, C * K * np_ * 6 * D, C * ep * D,
                             K * n_grad if K > 1 else 1,      # dkv, dg, dhf_buf, partial
                             C * K * ep if bf16 else 1)       # dscore
    # bf16: wk_e^T for the per-edge dhf_src product
    wkt_e = wkv_e[:, 0].transpose(1, 2).contiguous() if bf16 else None
    levels = (ctypes.c_int * C)(*n_levels)
    launched = ctypes.c_int(0)             # the kernels the C entry enqueued
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_step_backward(
            *(t.data_ptr() for t in (g, res_e, res_n, lv_src, lv_nodes, *lists, wkv_e, wvt_e,
                                     wiht_e, b_hh, wa_k, d_pack)), *scratch[:3],
            grads.data_ptr(), scratch[3], wkt_e.data_ptr() if bf16 else None,
            scratch[4] if bf16 else None, ctypes.addressof(levels), ctypes.addressof(launched),
            C, R // C, K, n_sub, ep, np_, D, T, bf16, stream)
    _build.check(lib, code, "level_scan_step_bwd kernel launch")
    step_bwd_launches += launched.value
    return (d_pack, *_weight_grads(grads, D, T, primal))


def _check_step(args) -> None:
    """Device, dtype, shape and contiguity checks of ``level_step``'s
    arguments, for both routes."""
    hf, pack = args[0], args[1]
    names = ("hf", "pack", "src", "dslot", "evalid", "upd", "e_n",
             "wkv_hf", "w_ih", "b_ih", "b_hh", "wa_k")
    if pack.dim() != 2 or pack.shape[1] < 3:
        raise ValueError(f"level_step: pack must be [Ep, D+2], got {tuple(pack.shape)}")
    ep, pw = pack.shape
    np_ = args[5].shape[-1]
    D, T = pw - 2, args[11].shape[0]
    if hf.dim() != 2 or hf.shape[0] < 1 or ep < 1 or np_ < 1:
        raise ValueError(f"level_step: hf must be [N, D] with N >= 1, got {tuple(hf.shape)}; "
                         f"Ep={ep}, Np={np_}")
    i32 = torch.int32
    vdt = _value_dtype(pack)
    want = [((hf.shape[0], D), vdt), ((ep, pw), vdt),
            ((ep,), i32), ((ep,), i32), ((ep,), i32), ((np_,), i32), ((np_,), i32),
            ((D, 2 * T * D), vdt), ((D, 3 * T * D), vdt),
            ((T, 3 * D), vdt), ((T, 3 * D), vdt), ((T, D), vdt)]
    _check_tensors("level_step", names, args, want, pack.device)


def _check(args, num_nodes: int, num_levels: int, op: str = "level_scan") -> None:
    """Device, dtype, shape and contiguity checks of ``level_scan``'s (and
    ``level_scan_giant``'s) arguments, for both routes."""
    (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
     wkv_hf, w_ih, b_ih, b_hh, wa_k) = args
    names = ("pack_lv", "lv_src", "lv_dslot", "lv_evalid", "lv_nodes", "lv_upd",
             "lv_e_n", "wkv_hf", "w_ih", "b_ih", "b_hh", "wa_k")
    if pack_lv.dim() != 3 or pack_lv.shape[2] < 3:
        raise ValueError(f"{op}: pack_lv must be [L, Ep, D+2], got {tuple(pack_lv.shape)}")
    L, ep, pw = pack_lv.shape
    np_ = lv_nodes.shape[-1]
    D, T = pw - 2, wa_k.shape[0]
    vdt = _value_dtype(pack_lv)
    want = {
        "pack_lv": ((L, ep, pw), vdt),
        "lv_src": ((L, ep), torch.int32), "lv_dslot": ((L, ep), torch.int32),
        "lv_evalid": ((L, ep), torch.int32),
        "lv_nodes": ((L, np_), torch.int32), "lv_upd": ((L, np_), torch.int32),
        "lv_e_n": ((L, np_), torch.int32),
        "wkv_hf": ((D, 2 * T * D), vdt), "w_ih": ((D, 3 * T * D), vdt),
        "b_ih": ((T, 3 * D), vdt), "b_hh": ((T, 3 * D), vdt),
        "wa_k": ((T, D), vdt),
    }
    _check_tensors(op, names, args, [want[n] for n in names], pack_lv.device)
    if not 0 <= num_levels <= L:
        raise ValueError(f"{op}: num_levels {num_levels} outside [0, {L}]")
    if num_nodes < 1 or ep < 1 or np_ < 1:
        raise ValueError(f"{op}: empty node or level tables")


def _value_dtype(values: torch.Tensor) -> torch.dtype:
    """The value type of a level op's float arguments, from the first of
    them: bf16, else fp32 (every level op takes both; the others must
    match)."""
    return values.dtype if values.dtype == torch.bfloat16 else torch.float32


def _check_tensors(op: str, names, tensors, want, device) -> None:
    for name, t, (shape, dtype) in zip(names, tensors, want):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{op}: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
