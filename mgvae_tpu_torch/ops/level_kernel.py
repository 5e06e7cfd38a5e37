"""The level recurrence, forward and backward: the CUDA kernels' wrappers
and their plain PyTorch versions.

Counterpart of ``mgvae_tpu/ops/pallas/level_kernel.py`` in fp32, in three
forms that share one level's arithmetic:

  * the fused scan over all levels of one (sub-)batch, hf kept inside:
    ``fused_level_scan`` (with and without residuals) is
    ``csrc/level_scan.cu``, ``fused_level_scan_bwd`` is
    ``csrc/level_scan_bwd.cu``, and the custom VJP ``pallas_level_scan`` that
    joins them is the autograd Function behind ``level_scan``;
  * the single-level step from an explicit hf, for chunks too large for the
    fused route: ``level_step_call`` is ``csrc/level_step.cu``,
    ``level_step_bwd_call`` is ``csrc/level_step_bwd.cu``, and the custom VJP
    ``pallas_level_step`` is the autograd Function behind ``level_step``. It
    returns the level's new rows h_new [Np, D] unscattered; the caller
    (``models/dg_ae.level_scan_step``) writes them into hf between calls;
  * the scan of one batch of any size that keeps no residuals, for giant
    single graphs and every plain batch too large for the fused route's size
    gate: ``fused_level_scan_hbm`` is ``csrc/level_scan_giant.cu``,
    ``fused_level_scan_hbm_bwd`` is ``csrc/level_scan_giant_bwd.cu``, and the
    custom VJP ``pallas_level_scan_hbm`` is the autograd Function behind
    ``level_scan_giant``. Its forward saves hf alone and its backward
    recomputes each level's intermediates from it, so training needs
    O(N * D + Ep * D) working memory where the fused route's residuals need
    O(L * Ep * D).

Dispatch of ``level_scan``, ``level_step`` and ``level_scan_giant``, with no
hidden fallback:
  * CUDA tensors: the forward kernel or raise. When grad is enabled and a
    float input requires grad it goes through the autograd Function: the
    forward kernel also writes the residuals (the giant route has none: it
    saves hf), and the backward launches the backward kernels. Otherwise
    (serving) it takes the launch without residuals.
  * CPU tensors: the plain version; autograd differentiates it.

``level_scan_reference`` / ``level_step_reference`` (``with_residuals=True``
for the training forward) and ``level_scan_bwd_reference`` /
``level_step_bwd_reference`` are the plain versions of the first four
kernels, ``level_scan_giant_reference`` (hf only) and
``level_scan_giant_bwd_reference`` (which recomputes from hf, as its kernel
does) those of the giant route's, that the tests and ``chip_smoke.py`` hold
them against; ``_forward_cuda``, ``_backward_cuda``, ``_step_forward_cuda``,
``_step_backward_cuda``, ``_giant_forward_cuda`` and ``_giant_backward_cuda``
are the kernels' wrappers (CUDA tensors only, arguments as the public
functions check them).

Launch counts, so that a run can show that it went through the kernels by
setting them to 0 and reading them afterwards: ``launches`` (the fused
forward: one per level), ``bwd_launches`` (the fused backward: a slot and a
source kernel per level, then one weight-gradient kernel per call),
``step_launches`` (one per ``level_step`` call), ``step_bwd_launches``
(three per backward of a ``level_step`` call: slots, sources, weight
gradients), ``giant_launches`` (the giant forward: one per level) and
``giant_bwd_launches`` (the giant backward: four per level: recompute,
slots, sources, the level's weight gradients).

Residual layout (the port's own, unpadded): res_e [L, Ep, 3D+1] =
hf_src | khf | v | attn per edge, res_n [L, Np, 4D] = msg | r | z | nw per
slot; the step's are one level's, [Ep, 3D+1] and [Np, 4D]. Rows of padding
levels, padding edges and slots that are not updated are 0 and are never
read.
"""
from __future__ import annotations

import torch

from . import _build
from .segment import segment_softmax, segment_sum

MAX_DIM = 128      # the kernels' limits (csrc/level_common.cuh)
MAX_EXPERTS = 5

launches = 0
bwd_launches = 0
step_launches = 0
step_bwd_launches = 0
giant_launches = 0
giant_bwd_launches = 0

# Size gate of the fused route for a chunk of a chunked batch, copied from the
# JAX package (``level_kernel.py:145-158``), where it is the TPU kernel's VMEM
# gate. The CUDA kernels have no such limit: this is shape arithmetic only,
# kept so that ``collate_fit`` chunks a batch, and ``models/dg_ae`` routes it,
# the same way in both packages.
KERNEL_MAX_NODES = 8192
KERNEL_MAX_EP = 512
KERNEL_MAX_NP = 512


def kernel_fits(num_nodes: int, ep: int, np_: int, dim: int) -> bool:
    return (num_nodes <= KERNEL_MAX_NODES and ep <= KERNEL_MAX_EP
            and np_ <= KERNEL_MAX_NP and dim <= 128)


# Size gates of the giant route for an unchunked batch that fails
# ``kernel_fits``, forward and with its backward, copied from the JAX package
# (``level_kernel.py:851, 1189``: the VMEM gates of its HBM-streamed
# kernels). The CUDA kernels have no such limit either: shape arithmetic,
# kept so that ``models/dg_ae.level_recurrence`` routes alike in both
# packages.
def kernel_fits_hbm(num_nodes: int, ep: int, np_: int, dim: int) -> bool:
    return ep <= 4096 and np_ <= 2048 and dim <= 128


def kernel_fits_hbm_bwd(num_nodes: int, ep: int, np_: int, dim: int) -> bool:
    return ep <= 2048 and np_ <= 1024 and dim <= 128


# positions of the float (differentiable) arguments among level_scan's (and
# level_scan_giant's) 12:
# pack_lv, wkv_hf, w_ih, b_ih, b_hh, wa_k
FLOAT_ARGS = (0, 7, 8, 9, 10, 11)
# and among level_step's 12: hf, pack, wkv_hf, w_ih, b_ih, b_hh, wa_k
STEP_FLOAT_ARGS = (0, 1, 7, 8, 9, 10, 11)


def select_expert(stacked: torch.Tensor, expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """stacked [M, T*W] -> each row's expert slice [M, W]."""
    m = stacked.shape[0]
    w = stacked.shape[1] // num_experts
    idx = expert.long().view(m, 1, 1).expand(m, 1, w)
    return stacked.view(m, num_experts, w).gather(1, idx).squeeze(1)


def _level_forward(hf, pk, src, dslot, evalid, upd, e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k,
                   with_residuals: bool):
    """One level from hf [N, D] with the math of the JAX package's
    ``_level_scan_fast`` (``mgvae_tpu/models/dg_ae.py``): src / dslot / e_n
    int64, evalid / upd bool. Returns (h_new [Np, D], 0 on the slots that
    are not updated, res_e [Ep, 3D+1] or None, res_n [Np, 4D] or None)."""
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
    msg = segment_sum(v * attn[:, None], dslot, np_)            # [Np, D]

    gi = select_expert(msg @ w_ih, e_n, T) + b_ih[e_n]
    gh = b_hh[e_n]                                              # h == 0
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    h_new = torch.where(upd[:, None], (1.0 - z) * n, 0.0)
    if not with_residuals:
        return h_new, None, None
    live = (evalid & upd[dslot])[:, None]
    res_e = torch.where(live, torch.cat([hf_src, khf, v, attn[:, None]], 1), 0.0)
    res_n = torch.where(upd[:, None], torch.cat([msg, r, z, n], 1), 0.0)
    return h_new, res_e.detach(), res_n.detach()


def _level_backward(g, res_e, res_n, pk, dslot, evf, e_n, wkv_hf, w_ih, b_hh, wa_k):
    """One level's backward, written out as the JAX package's
    ``_level_bwd_body`` (``level_kernel.py:645-778``): g [Np, D] is the
    cotangent of h_new, already 0 on the slots that are not updated; evf the
    edge mask as float. Returns (d_pack [Ep, D+2], d_wkv, d_wih, d_bih,
    d_bhh, d_wak, dhf_src [Ep, D]: the sources' gradients per edge, masked)."""
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
    dmsg = dgi_all @ w_ih.T                                     # [Np, D]

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
    dhf_src = (dkv @ wkv_hf.T) * evf[:, None]                   # [Ep, D]
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
    D = pack_lv.shape[2] - 2
    L, ep, _ = pack_lv.shape
    np_ = lv_nodes.shape[1]
    hf = pack_lv.new_zeros((num_nodes, D))
    if with_residuals:
        res_e = pack_lv.new_zeros((L, ep, 3 * D + 1))
        res_n = pack_lv.new_zeros((L, np_, 4 * D))
    for lv in range(num_levels):
        h_new, re, rn = _level_forward(
            hf, pack_lv[lv], lv_src[lv].long(), lv_dslot[lv].long(), lv_evalid[lv] > 0,
            lv_upd[lv] > 0, lv_e_n[lv].long(), wkv_hf, w_ih, b_ih, b_hh, wa_k, with_residuals)
        hf[lv_nodes[lv].long()] = h_new
        if with_residuals:
            res_e[lv], res_n[lv] = re, rn
    if with_residuals:
        return hf, res_e, res_n
    return hf


def _reverse_sweep(ghf, residuals_of, pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd,
                   lv_e_n, wkv_hf, w_ih, b_hh, wa_k, num_levels: int):
    """The reverse sweep over levels with hf's cotangent ``ghf`` [N, D]
    carried back to the sources; ``residuals_of(lv)`` gives level lv's
    (res_e, res_n). Returns (d_pack [L, Ep, D+2], d_wkv, d_wih, d_bih,
    d_bhh, d_wak); the pack's expert column gets no gradient."""
    ghf = ghf.detach().clone()
    d_pack = torch.zeros_like(pack_lv)
    sums = [torch.zeros_like(t) for t in (wkv_hf, w_ih, b_hh, b_hh, wa_k)]
    for lv in reversed(range(num_levels)):
        g = torch.where((lv_upd[lv] > 0)[:, None], ghf[lv_nodes[lv].long()], 0.0)
        d_pack[lv], *grads, dhf_src = _level_backward(
            g, *residuals_of(lv), pack_lv[lv], lv_dslot[lv].long(),
            (lv_evalid[lv] > 0).to(ghf.dtype), lv_e_n[lv].long(), wkv_hf, w_ih, b_hh, wa_k)
        for acc, x in zip(sums, grads):
            acc += x
        ghf.index_add_(0, lv_src[lv].long(), dhf_src)
    return (d_pack, *sums)


def level_scan_bwd_reference(ghf, res_e, res_n, pack_lv, lv_src, lv_dslot, lv_evalid,
                             lv_nodes, lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k,
                             num_levels: int):
    """The fused backward's math: the reverse sweep over the saved
    residuals. Returns (d_pack [L, Ep, D+2], d_wkv, d_wih, d_bih, d_bhh,
    d_wak)."""
    return _reverse_sweep(ghf, lambda lv: (res_e[lv], res_n[lv]), pack_lv, lv_src, lv_dslot,
                          lv_evalid, lv_nodes, lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k,
                          num_levels)


def level_scan_giant_reference(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                               wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
                               num_levels: int) -> torch.Tensor:
    """The giant forward's math: hf [N, D] and nothing else. The same eager
    loop as ``level_scan_reference``; autograd differentiates it."""
    return level_scan_reference(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                                wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes, num_levels)


def level_scan_giant_bwd_reference(ghf, hf, pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes,
                                   lv_upd, lv_e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k,
                                   num_levels: int):
    """The giant backward's math: the reverse sweep with each level's
    residuals recomputed from the forward's final hf [N, D] (exact: a
    level's sources all lie at lower levels, and with one round their rows
    are final before it runs). Returns (d_pack [L, Ep, D+2], d_wkv, d_wih,
    d_bih, d_bhh, d_wak)."""
    def recompute(lv):
        with torch.no_grad():
            _, res_e, res_n = _level_forward(
                hf, pack_lv[lv], lv_src[lv].long(), lv_dslot[lv].long(), lv_evalid[lv] > 0,
                lv_upd[lv] > 0, lv_e_n[lv].long(), wkv_hf, w_ih, b_ih, b_hh, wa_k, True)
        return res_e, res_n

    return _reverse_sweep(ghf, recompute, pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes,
                          lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k, num_levels)


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
    per source."""
    g = torch.where((upd > 0)[:, None], g.detach(), 0.0)
    *grads, dhf_src = _level_backward(
        g, res_e, res_n, pack, dslot.long(), (evalid > 0).to(g.dtype), e_n.long(),
        wkv_hf, w_ih, b_hh, wa_k)
    d_hf = g.new_zeros((num_nodes, g.shape[1])).index_add_(0, src.long(), dhf_src)
    return (*grads, d_hf)


def level_scan(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
               wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
               num_levels: int) -> torch.Tensor:
    """Level recurrence over levels [0, num_levels) of the tables.

    pack_lv [L, Ep, D+2] f32: per edge [vhs | score_static | expert];
    lv_src / lv_dslot / lv_evalid [L, Ep] and lv_nodes / lv_upd / lv_e_n
    [L, Np] int32; wkv_hf [D, 2TD], w_ih [D, 3TD], b_ih / b_hh [T, 3D],
    wa_k [T, D] f32. Returns hf [num_nodes, D] f32, differentiable with
    respect to pack_lv, wkv_hf, w_ih, b_ih, b_hh and wa_k.
    """
    args = (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
            wkv_hf, w_ih, b_ih, b_hh, wa_k)
    _check(args, num_nodes, num_levels)
    dev = pack_lv.device
    if dev.type == "cpu":
        return level_scan_reference(*args, num_nodes, num_levels)
    if dev.type != "cuda":
        raise ValueError(f"level_scan: no kernel for device {dev}")
    if torch.is_grad_enabled() and any(args[i].requires_grad for i in FLOAT_ARGS):
        return _LevelScan.apply(num_nodes, num_levels, *args)
    return _forward_cuda(args, num_nodes, num_levels, residuals=False)


class _LevelScan(torch.autograd.Function):
    """CUDA only: the forward kernel with residuals, and the backward
    kernels. Counterpart of the JAX package's custom VJP
    ``pallas_level_scan``."""

    @staticmethod
    def forward(ctx, num_nodes, num_levels, *args):
        hf, res_e, res_n = _forward_cuda(args, num_nodes, num_levels, residuals=True)
        ctx.num_levels = num_levels
        ctx.save_for_backward(*args, res_e, res_n)
        return hf

    @staticmethod
    def backward(ctx, ghf):
        *args, res_e, res_n = ctx.saved_tensors
        grads = _backward_cuda(ghf, res_e, res_n, tuple(args), ctx.num_levels)
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak = grads
        # (num_nodes, num_levels, pack_lv, 6 int tables, wkv_hf, w_ih, b_ih, b_hh, wa_k)
        return (None, None, d_pack) + (None,) * 6 + (d_wkv, d_wih, d_bih, d_bhh, d_wak)


def _kernel_dims(pack_lv, wa_k):
    D, T = pack_lv.shape[-1] - 2, wa_k.shape[0]
    if D > MAX_DIM or T > MAX_EXPERTS:
        raise ValueError(f"the level kernels take D <= {MAX_DIM} and T <= "
                         f"{MAX_EXPERTS}, got D={D}, T={T}")
    return D, T


def _forward_cuda(args, num_nodes: int, num_levels: int, residuals: bool):
    global launches
    pack_lv, lv_nodes, wa_k = args[0], args[4], args[11]
    L, ep, _ = pack_lv.shape
    np_ = lv_nodes.shape[1]
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    hf = torch.zeros((num_nodes, D), **f32)
    score_buf = torch.empty((ep,), **f32)
    v_buf = torch.empty((ep, D), **f32)
    res_e = torch.zeros((L, ep, 3 * D + 1), **f32) if residuals else None
    res_n = torch.zeros((L, np_, 4 * D), **f32) if residuals else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_forward(
            *(t.data_ptr() for t in args), hf.data_ptr(), score_buf.data_ptr(),
            v_buf.data_ptr(), res_e.data_ptr() if residuals else None,
            res_n.data_ptr() if residuals else None, num_levels, ep, np_, D, T, stream)
    _build.check(lib, code, "level_scan kernel launch")
    launches += num_levels
    return (hf, res_e, res_n) if residuals else hf


def _backward_cuda(ghf, res_e, res_n, args, num_levels: int):
    global bwd_launches
    (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
     wkv_hf, w_ih, _, b_hh, wa_k) = args
    L, ep, pw = pack_lv.shape
    np_ = lv_nodes.shape[1]
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    # a contiguous working copy: autograd may hand over an expanded or shared
    # cotangent, and the kernel adds the sources' gradients into it
    g = torch.empty((ghf.shape[0], D), **f32)
    g.copy_(ghf)
    d_pack = torch.zeros((L, ep, pw), **f32)
    dkv = torch.zeros((L, ep, 2 * D), **f32)
    dg = torch.zeros((L, np_, 6 * D), **f32)
    dhf_buf = torch.empty((ep, D), **f32)
    dattn_buf = torch.empty((ep,), **f32)
    d_wkv, d_wih = torch.empty_like(wkv_hf), torch.empty_like(w_ih)
    d_bih, d_bhh = torch.empty_like(b_hh), torch.empty_like(b_hh)
    d_wak = torch.empty_like(wa_k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_backward(
            *(t.data_ptr() for t in (g, res_e, res_n, lv_src, lv_dslot, lv_evalid, lv_nodes,
                                     lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k, d_pack, dkv,
                                     dg, dhf_buf, dattn_buf, d_wkv, d_wih, d_bih, d_bhh,
                                     d_wak)),
            num_levels, ep, np_, D, T, stream)
    _build.check(lib, code, "level_scan_bwd kernel launch")
    bwd_launches += 2 * num_levels + 1
    return d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak


def level_scan_giant(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                     wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
                     num_levels: int) -> torch.Tensor:
    """Level recurrence over levels [0, num_levels) of one batch's tables at
    any size, keeping no residuals: arguments and result as ``level_scan``'s.
    Training saves hf alone; the backward recomputes each level from it."""
    args = (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
            wkv_hf, w_ih, b_ih, b_hh, wa_k)
    _check(args, num_nodes, num_levels, op="level_scan_giant")
    dev = pack_lv.device
    if dev.type == "cpu":
        return level_scan_giant_reference(*args, num_nodes, num_levels)
    if dev.type != "cuda":
        raise ValueError(f"level_scan_giant: no kernel for device {dev}")
    if torch.is_grad_enabled() and any(args[i].requires_grad for i in FLOAT_ARGS):
        return _LevelScanGiant.apply(num_nodes, num_levels, *args)
    return _giant_forward_cuda(args, num_nodes, num_levels)


class _LevelScanGiant(torch.autograd.Function):
    """CUDA only: the giant forward kernel, which saves its result hf and no
    residuals, and the giant backward kernels, which recompute from it.
    Counterpart of the JAX package's custom VJP ``pallas_level_scan_hbm``."""

    @staticmethod
    def forward(ctx, num_nodes, num_levels, *args):
        hf = _giant_forward_cuda(args, num_nodes, num_levels)
        ctx.num_levels = num_levels
        ctx.save_for_backward(*args, hf)
        return hf

    @staticmethod
    def backward(ctx, ghf):
        *args, hf = ctx.saved_tensors
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak = _giant_backward_cuda(
            ghf, hf, tuple(args), ctx.num_levels)
        # (num_nodes, num_levels, pack_lv, 6 int tables, wkv_hf, w_ih, b_ih, b_hh, wa_k)
        return (None, None, d_pack) + (None,) * 6 + (d_wkv, d_wih, d_bih, d_bhh, d_wak)


def _giant_forward_cuda(args, num_nodes: int, num_levels: int) -> torch.Tensor:
    global giant_launches
    pack_lv, lv_nodes, wa_k = args[0], args[4], args[11]
    ep, np_ = pack_lv.shape[1], lv_nodes.shape[1]
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    hf = torch.zeros((num_nodes, D), **f32)
    score_buf = torch.empty((ep,), **f32)
    v_buf = torch.empty((ep, D), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_giant_forward(
            *(t.data_ptr() for t in args), hf.data_ptr(), score_buf.data_ptr(),
            v_buf.data_ptr(), num_levels, ep, np_, D, T, stream)
    _build.check(lib, code, "level_scan_giant kernel launch")
    giant_launches += num_levels
    return hf


def _giant_backward_cuda(ghf, hf, args, num_levels: int):
    """Apart from its outputs (d_pack_lv is the only float buffer with a
    leading L axis) the working memory is ghf's copy and one level's
    scratch."""
    global giant_bwd_launches
    pack_lv, lv_nodes, wkv_hf, w_ih, b_hh, wa_k = (args[i] for i in (0, 4, 7, 8, 10, 11))
    ep, np_ = pack_lv.shape[1], lv_nodes.shape[1]
    D, T = _kernel_dims(pack_lv, wa_k)
    dev = pack_lv.device
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    # a contiguous working copy: autograd may hand over an expanded or shared
    # cotangent, and the kernel adds the sources' gradients into it
    g = torch.empty((hf.shape[0], D), **f32)
    g.copy_(ghf)
    d_pack = torch.zeros_like(pack_lv)
    # one level's recomputed residuals; rows a level does not write are only
    # ever multiplied by zeroed rows, so they are zeroed once
    res_e = torch.zeros((ep, 3 * D + 1), **f32)
    res_n = torch.zeros((np_, 4 * D), **f32)
    scratch = [torch.empty(shape, **f32) for shape in (
        (ep, 2 * D), (np_, 6 * D),              # dkv, dg: zeroed before each level by the callee
        (ep,), (ep, D), (ep, D), (ep,))]        # score_buf, v_buf, dhf_buf, dattn_buf
    # the weight gradients are added into, level by level
    grads = [torch.zeros_like(t) for t in (wkv_hf, w_ih, b_hh, b_hh, wa_k)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_scan_giant_backward(
            *(t.data_ptr() for t in (g, hf, *args, d_pack, res_e, res_n, *scratch, *grads)),
            num_levels, ep, np_, D, T, stream)
    _build.check(lib, code, "level_scan_giant_bwd kernel launch")
    giant_bwd_launches += 4 * num_levels
    return (d_pack, *grads)


def level_step(hf, pack, src, dslot, evalid, upd, e_n,
               wkv_hf, w_ih, b_ih, b_hh, wa_k) -> torch.Tensor:
    """One level from an explicit hf.

    hf [N, D] f32 (read only; a contiguous row range of a larger hf will
    do), pack [Ep, D+2] f32: per edge [vhs | score_static | expert];
    src / dslot / evalid [Ep] and upd / e_n [Np] int32, src indexing hf's
    rows; the weights as ``level_scan``'s. Returns h_new [Np, D] f32 in slot
    order, 0 where ``upd`` is 0, not scattered; differentiable with respect
    to hf (through the source gathers), pack and the weights.

    The JAX function's ``nodes`` argument only feeds its source windows and
    has no counterpart here.
    """
    args = (hf, pack, src, dslot, evalid, upd, e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k)
    _check_step(args)
    dev = pack.device
    if dev.type == "cpu":
        return level_step_reference(*args)
    if dev.type != "cuda":
        raise ValueError(f"level_step: no kernel for device {dev}")
    if torch.is_grad_enabled() and any(args[i].requires_grad for i in STEP_FLOAT_ARGS):
        return _LevelStep.apply(*args)
    return _step_forward_cuda(args, residuals=False)


class _LevelStep(torch.autograd.Function):
    """CUDA only: the step kernel with residuals, and its backward kernels.
    Counterpart of the JAX package's custom VJP ``pallas_level_step``.

    hf itself is not saved (res_e holds the gathered source rows), only its
    row count: the caller writes the new rows into hf in place between
    calls, and a saved hf would fail autograd's version check at the next
    write."""

    @staticmethod
    def forward(ctx, hf, *rest):
        h_new, res_e, res_n = _step_forward_cuda((hf, *rest), residuals=True)
        ctx.num_nodes = hf.shape[0]
        ctx.save_for_backward(*rest, res_e, res_n)
        return h_new

    @staticmethod
    def backward(ctx, g):
        *rest, res_e, res_n = ctx.saved_tensors
        grads = _step_backward_cuda(g, res_e, res_n, tuple(rest), ctx.num_nodes)
        d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, d_hf = grads
        # (hf, pack, 5 int tables, wkv_hf, w_ih, b_ih, b_hh, wa_k)
        return (d_hf, d_pack) + (None,) * 5 + (d_wkv, d_wih, d_bih, d_bhh, d_wak)


def _step_forward_cuda(args, residuals: bool):
    global step_launches
    hf, pack, src, dslot, evalid, upd, e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k = args
    ep, np_ = pack.shape[0], upd.shape[0]
    D, T = _kernel_dims(pack, wa_k)
    dev = pack.device
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    h_new = torch.zeros((np_, D), **f32)
    score_buf = torch.empty((ep,), **f32)
    v_buf = torch.empty((ep, D), **f32)
    res_e = torch.zeros((ep, 3 * D + 1), **f32) if residuals else None
    res_n = torch.zeros((np_, 4 * D), **f32) if residuals else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_step_forward(
            *(t.data_ptr() for t in args), h_new.data_ptr(), score_buf.data_ptr(),
            v_buf.data_ptr(), res_e.data_ptr() if residuals else None,
            res_n.data_ptr() if residuals else None, ep, np_, D, T, stream)
    _build.check(lib, code, "level_step kernel launch")
    step_launches += 1
    return (h_new, res_e, res_n) if residuals else h_new


def _step_backward_cuda(g, res_e, res_n, rest, num_nodes: int):
    """``rest``: level_step's arguments after hf."""
    global step_bwd_launches
    pack, src, dslot, evalid, upd, e_n, wkv_hf, w_ih, _, b_hh, wa_k = rest
    ep, pw = pack.shape
    np_ = upd.shape[0]
    D, T = _kernel_dims(pack, wa_k)
    dev = pack.device
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    g = g.contiguous()   # autograd may hand over an expanded cotangent; only read
    d_pack = torch.zeros((ep, pw), **f32)
    dkv = torch.zeros((ep, 2 * D), **f32)
    dg = torch.zeros((np_, 6 * D), **f32)
    d_hf = torch.zeros((num_nodes, D), **f32)
    dhf_buf = torch.empty((ep, D), **f32)
    dattn_buf = torch.empty((ep,), **f32)
    d_wkv, d_wih = torch.empty_like(wkv_hf), torch.empty_like(w_ih)
    d_bih, d_bhh = torch.empty_like(b_hh), torch.empty_like(b_hh)
    d_wak = torch.empty_like(wa_k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_level_step_backward(
            *(t.data_ptr() for t in (g, res_e, res_n, src, dslot, evalid, upd, e_n, wkv_hf, w_ih,
                                     b_hh, wa_k, d_pack, dkv, dg, dhf_buf, dattn_buf, d_wkv,
                                     d_wih, d_bih, d_bhh, d_wak, d_hf)),
            ep, np_, D, T, stream)
    _build.check(lib, code, "level_step_bwd kernel launch")
    step_bwd_launches += 3
    return d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, d_hf


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
    want = [((hf.shape[0], D), torch.float32), ((ep, pw), torch.float32),
            ((ep,), i32), ((ep,), i32), ((ep,), i32), ((np_,), i32), ((np_,), i32),
            ((D, 2 * T * D), torch.float32), ((D, 3 * T * D), torch.float32),
            ((T, 3 * D), torch.float32), ((T, 3 * D), torch.float32), ((T, D), torch.float32)]
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
    want = {
        "pack_lv": ((L, ep, pw), torch.float32),
        "lv_src": ((L, ep), torch.int32), "lv_dslot": ((L, ep), torch.int32),
        "lv_evalid": ((L, ep), torch.int32),
        "lv_nodes": ((L, np_), torch.int32), "lv_upd": ((L, np_), torch.int32),
        "lv_e_n": ((L, np_), torch.int32),
        "wkv_hf": ((D, 2 * T * D), torch.float32), "w_ih": ((D, 3 * T * D), torch.float32),
        "b_ih": ((T, 3 * D), torch.float32), "b_hh": ((T, 3 * D), torch.float32),
        "wa_k": ((T, D), torch.float32),
    }
    _check_tensors(op, names, args, [want[n] for n in names], pack_lv.device)
    if not 0 <= num_levels <= L:
        raise ValueError(f"{op}: num_levels {num_levels} outside [0, {L}]")
    if num_nodes < 1 or ep < 1 or np_ < 1:
        raise ValueError(f"{op}: empty node or level tables")


def _check_tensors(op: str, names, tensors, want, device) -> None:
    for name, t, (shape, dtype) in zip(names, tensors, want):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{op}: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
