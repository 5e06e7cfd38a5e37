"""Fused level recurrence, forward and backward: the CUDA kernels' wrappers
and their plain PyTorch versions.

Counterpart of ``mgvae_tpu/ops/pallas/level_kernel.py`` at C == 1, fp32:
``fused_level_scan`` (with and without residuals) is ``csrc/level_scan.cu``;
``fused_level_scan_bwd`` is ``csrc/level_scan_bwd.cu``; the custom VJP
``pallas_level_scan`` that joins them is the autograd Function behind
``level_scan``.

Dispatch, with no hidden fallback:
  * CUDA tensors: ``level_scan`` launches the forward kernel (one launch per
    level) or raises. When grad is enabled and a float input requires grad
    it goes through ``_LevelScan``: the forward kernel also writes the
    residuals, and the backward launches the backward kernels. Otherwise
    (serving) it takes the launch without residuals.
  * CPU tensors: ``level_scan`` runs ``level_scan_reference``; autograd
    differentiates it.

``level_scan_reference(..., with_residuals=True)`` and
``level_scan_bwd_reference`` are the plain versions of the two kernels that
the tests and ``chip_smoke.py`` hold them against; ``_forward_cuda`` and
``_backward_cuda`` are the kernels' wrappers (CUDA tensors only, arguments
as ``level_scan`` checks them).

``launches`` counts forward kernel launches (one per level),
``bwd_launches`` backward kernel launches (a slot and a source kernel per
level, then one weight-gradient kernel per call); a run shows that it went
through the kernels by resetting them to 0 and reading them afterwards.

Residual layout (the port's own, unpadded): res_e [L, Ep, 3D+1] =
hf_src | khf | v | attn per edge, res_n [L, Np, 4D] = msg | r | z | nw per
slot. Rows of padding levels, padding edges and slots that are not updated
are 0 and are never read.
"""
from __future__ import annotations

import torch

from . import _build
from .segment import segment_softmax, segment_sum

MAX_DIM = 128      # the kernels' limits (csrc/level_common.cuh)
MAX_EXPERTS = 5

launches = 0
bwd_launches = 0

# positions of the float (differentiable) arguments among level_scan's 12:
# pack_lv, wkv_hf, w_ih, b_ih, b_hh, wa_k
FLOAT_ARGS = (0, 7, 8, 9, 10, 11)


def select_expert(stacked: torch.Tensor, expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """stacked [M, T*W] -> each row's expert slice [M, W]."""
    m = stacked.shape[0]
    w = stacked.shape[1] // num_experts
    idx = expert.long().view(m, 1, 1).expand(m, 1, w)
    return stacked.view(m, num_experts, w).gather(1, idx).squeeze(1)


def level_scan_reference(pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
                         wkv_hf, w_ih, b_ih, b_hh, wa_k, num_nodes: int,
                         num_levels: int, with_residuals: bool = False):
    """Eager loop over levels with the math of the JAX package's
    ``_level_scan_fast`` (``mgvae_tpu/models/dg_ae.py``); returns hf [N, D],
    or with ``with_residuals`` (hf, res_e, res_n), the residuals detached.

    Every slot is written: ``h_new`` where ``lv_upd`` is set, else 0 (the
    padding slots all point at the dump row, which so stays 0). Autograd
    differentiates the loop: the in-place row write is legal because the
    earlier reads ``hf[src]`` save only their indices, not hf."""
    D = pack_lv.shape[2] - 2
    T = wa_k.shape[0]
    L, ep, _ = pack_lv.shape
    np_ = lv_nodes.shape[1]
    hf = pack_lv.new_zeros((num_nodes, D))
    if with_residuals:
        res_e = pack_lv.new_zeros((L, ep, 3 * D + 1))
        res_n = pack_lv.new_zeros((L, np_, 4 * D))
    for lv in range(num_levels):
        pk = pack_lv[lv]
        src = lv_src[lv].long()
        dslot = lv_dslot[lv].long()
        evalid = lv_evalid[lv] > 0
        e_edge = pk[:, D + 1].long()
        hf_src = hf[src]
        kv = hf_src @ wkv_hf                                    # [Ep, 2TD]
        khf = select_expert(kv[:, : T * D], e_edge, T)
        vhf = select_expert(kv[:, T * D :], e_edge, T)
        score = pk[:, D] + (khf * wa_k[e_edge]).sum(-1)
        v = pk[:, :D] + vhf
        attn = segment_softmax(score, dslot, np_, valid=evalid)
        msg = segment_sum(v * attn[:, None], dslot, np_)        # [Np, D]

        e_n = lv_e_n[lv].long()
        gi = select_expert(msg @ w_ih, e_n, T) + b_ih[e_n]
        gh = b_hh[e_n]                                          # h == 0
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n
        upd = (lv_upd[lv] > 0)[:, None]
        hf[lv_nodes[lv].long()] = torch.where(upd, h_new, 0.0)
        if with_residuals:
            live = (evalid & upd[dslot, 0])[:, None]
            res_e[lv] = torch.where(live, torch.cat([hf_src, khf, v, attn[:, None]], 1), 0.0)
            res_n[lv] = torch.where(upd, torch.cat([msg, r, z, n], 1), 0.0)
    if with_residuals:
        return hf, res_e.detach(), res_n.detach()
    return hf


def level_scan_bwd_reference(ghf, res_e, res_n, pack_lv, lv_src, lv_dslot, lv_evalid,
                             lv_nodes, lv_upd, lv_e_n, wkv_hf, w_ih, b_hh, wa_k,
                             num_levels: int):
    """The backward kernel's math, written out as the JAX package's
    ``_level_bwd_body`` (``level_kernel.py:645-778``): a reverse sweep over
    the saved residuals with hf's cotangent ``ghf`` [N, D] carried back to
    the sources. Returns (d_pack [L, Ep, D+2], d_wkv, d_wih, d_bih, d_bhh,
    d_wak); the pack's expert column gets no gradient."""
    L, ep, pw = pack_lv.shape
    D, T = pw - 2, wa_k.shape[0]
    np_ = lv_nodes.shape[1]
    ghf = ghf.detach().clone()
    d_pack = torch.zeros_like(pack_lv)
    d_wkv, d_wih = torch.zeros_like(wkv_hf), torch.zeros_like(w_ih)
    d_bih, d_bhh = torch.zeros_like(b_hh), torch.zeros_like(b_hh)
    d_wak = torch.zeros_like(wa_k)
    for lv in reversed(range(num_levels)):
        src = lv_src[lv].long()
        dslot = lv_dslot[lv].long()
        evf = (lv_evalid[lv] > 0).to(ghf.dtype)
        upd = lv_upd[lv] > 0
        e_n = lv_e_n[lv].long()
        hf_src, khf, v, attn = res_e[lv].split([D, D, D, 1], dim=1)
        attn = attn[:, 0]
        msg, r, z, nw = res_n[lv].split(D, dim=1)

        # cotangent of h_new = (1 - z) * nw on the updated slots
        g = torch.where(upd[:, None], ghf[lv_nodes[lv].long()], 0.0)
        dnw = g * (1.0 - z)
        dz = -g * nw
        dnu = dnw * (1.0 - nw * nw)                             # pre-tanh
        dr = dnu * b_hh[e_n][:, 2 * D :]
        dzeta = dz * z * (1.0 - z)                              # pre-sigmoid z
        drho = dr * r * (1.0 - r)                               # pre-sigmoid r
        dgi = torch.cat([drho, dzeta, dnu], 1)                  # [Np, 3D]
        dbh = torch.cat([drho, dzeta, dnu * r], 1)
        onehot_n = torch.nn.functional.one_hot(e_n, T).to(ghf.dtype)   # [Np, T]
        dgi_all = (onehot_n[:, :, None] * dgi[:, None, :]).reshape(np_, 3 * T * D)
        d_wih += msg.T @ dgi_all
        d_bih += onehot_n.T @ dgi
        d_bhh += onehot_n.T @ dbh
        dmsg = dgi_all @ w_ih.T                                 # [Np, D]

        # attention backward over the in-edges
        per_edge = dmsg[dslot] * evf[:, None]
        dv = attn[:, None] * per_edge
        dattn = (v * per_edge).sum(-1)
        s_grp = segment_sum(attn * dattn * evf, dslot, np_)
        dscore = attn * (dattn - s_grp[dslot]) * evf
        e_edge = pack_lv[lv, :, D + 1].long()
        onehot_e = torch.nn.functional.one_hot(e_edge, T).to(ghf.dtype) * evf[:, None]
        dkhf = dscore[:, None] * wa_k[e_edge]
        d_wak += onehot_e.T @ (dscore[:, None] * khf)
        dkv = torch.cat([(onehot_e[:, :, None] * dkhf[:, None, :]).reshape(ep, T * D),
                         (onehot_e[:, :, None] * dv[:, None, :]).reshape(ep, T * D)], 1)
        d_wkv += hf_src.T @ dkv
        dhf_src = dkv @ wkv_hf.T                                # [Ep, D]
        d_pack[lv, :, :D] = dv
        d_pack[lv, :, D] = dscore
        ghf.index_add_(0, src, dhf_src * evf[:, None])
    return d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak


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
    D, T = pack_lv.shape[2] - 2, wa_k.shape[0]
    if D > MAX_DIM or T > MAX_EXPERTS:
        raise ValueError(f"level_scan kernels take D <= {MAX_DIM} and T <= "
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


def _check(args, num_nodes: int, num_levels: int) -> None:
    """Device, dtype, shape and contiguity checks of ``level_scan``'s
    arguments, for both routes."""
    (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n,
     wkv_hf, w_ih, b_ih, b_hh, wa_k) = args
    names = ("pack_lv", "lv_src", "lv_dslot", "lv_evalid", "lv_nodes", "lv_upd",
             "lv_e_n", "wkv_hf", "w_ih", "b_ih", "b_hh", "wa_k")
    if pack_lv.dim() != 3 or pack_lv.shape[2] < 3:
        raise ValueError(f"level_scan: pack_lv must be [L, Ep, D+2], got {tuple(pack_lv.shape)}")
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
    for name, t in zip(names, args):
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"level_scan: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != pack_lv.device:
            raise ValueError(f"level_scan: {name} is on {t.device}, pack_lv on {pack_lv.device}")
        if not t.is_contiguous():
            raise ValueError(f"level_scan: {name} must be contiguous")
    if not 0 <= num_levels <= L:
        raise ValueError(f"level_scan: num_levels {num_levels} outside [0, {L}]")
    if num_nodes < 1 or ep < 1 or np_ < 1:
        raise ValueError("level_scan: empty node or level tables")
