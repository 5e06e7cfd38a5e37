"""Struct-encoder towers, forward and backward: the CUDA kernels' wrappers
and their plain PyTorch versions.

Counterpart of ``mgvae_tpu/ops/pallas/struct_kernel.py``, with fp32 or bf16
values (xi, the state and the residuals; registers and sums fp32, the
JAX kernels' rounding points mirrored, the gradients summed in fp32 and
rounded once):
``fused_struct_towers`` (with and without residuals) is
``csrc/struct_towers.cu``; ``fused_struct_towers_bwd`` is
``csrc/struct_towers_bwd.cu``; the custom VJP ``pallas_struct_core`` that
joins them is the autograd Function behind ``struct_core``; and
``struct_towers`` is ``struct_towers_pallas``: it folds AggConv into the GRU
input product in plain torch *outside* the core,

    gi = msg @ w_ihD + x_feat @ w_ihX + b_ih,  msg = nbr @ w_aggr + deg * b_aggr
       = nbr @ (w_aggr @ w_ihD) + XI,  XI = x_feat @ w_ihX + b_ih + (deg * b_aggr) @ w_ihD,

so autograd recovers the gradients of w_aggr, b_aggr, w_ih and b_ih from
those of W_fold and XI. These products run at the caller's matmul precision
(``ops.precision``; "highest" in ``api.Model``): the recurrence amplifies a
TF32 fold or XI over the half-rounds (``struct_kernel.py:453-459``).

Dispatch of ``struct_core``, with no hidden fallback:
  * CUDA tensors: the forward kernel (one launch per half-round) or raise.
    When grad is enabled and a float input requires grad it goes through
    ``_StructTowers``: the forward kernel also writes the residuals, and the
    backward launches the backward kernels. Otherwise (serving) it takes the
    launch without residuals.
  * CPU tensors: ``struct_towers_reference``; in fp32 autograd
    differentiates it, in bf16 training goes through ``_StructTowers`` with
    the plain versions of both kernels.

``struct_towers_reference(..., with_residuals=True)`` and
``struct_towers_bwd_reference`` are the plain versions of the two kernels
that the tests and ``chip_smoke.py`` hold them against; ``_forward_cuda``
and ``_backward_cuda`` are the kernels' wrappers (CUDA tensors only,
arguments as ``struct_core`` checks them).

``launches`` counts forward kernel launches (2 * num_rounds per call: one
per half-round over both towers, ``forward_layout`` blocks of 8 rows a
warp), ``bwd_launches`` backward kernel launches (4 * num_rounds + 1 per
call: a row launch and a weight-gradient partial launch per half-round, one
sum).

Layouts (dir 0 = forward edges, 1 = reversed; tower 0 = source, 1 = target):
xi [2 dir, 2 tower, N, 3D], wfold / w_hh [2, 2, D, 3D], b_hh [2, 2, 3D],
ln_w / ln_b [2 tower, D]. The neighbor lists (``struct_tables``) are
(src [2 dir, S], start [2 dir, N], count [2 dir, N]) int32: node v's
neighbors in direction d are ``src[d, start[d, v] : start[d, v] + count[d, v]]``.
Residuals [2R, 2, N, 7D] = nbr | state_in | r | z | nw | gh_n | pre-LN h.
"""
from __future__ import annotations

import functools

import torch

from ..data.batching import BLOCK_D
from . import _build
from .precision import bf16_flag, current_precision, matmul_precision, rounder

MAX_DIM = 128      # the kernels' limit (csrc/level_common.cuh kMaxDim)
SPLIT_ROWS = 512   # rows per partial sum of the backward's weight gradients, at most
MIN_SPLITS = 40    # ... and the splits a batch is cut into, at least, down to 128 rows
WARP_ROWS = 8      # rows a warp of the backward's row kernel owns (csrc kRows)
FWD_ROWS, FWD_WARPS = 8, 4   # the forward kernel's rows a warp and warps a block

launches = 0
bwd_launches = 0


def struct_tables(b: dict) -> tuple:
    """Neighbor lists of both directions from a device batch, no host sync.

    The batch's blocked tables group edges by 128-node block of the
    destination (``fa_src``: the sources of each block's in-edges) or of the
    source (``ra_src``: the destinations of its out-edges), and within a
    block by node, in edge order (``data/batching._blocked_tables``). So
    node v's list starts at its block's row plus the in- (out-) degrees of
    the block's earlier nodes; padding rows are never reached."""
    fa, ra = b["fa_src"], b["ra_src"]
    nb, n = fa.shape[0], b["deg_in"].shape[0]
    if n != nb * BLOCK_D or ra.shape[0] != nb:
        raise ValueError(f"struct_tables: {nb} blocks of fa/ra tables for {n} nodes")
    eb = max(fa.shape[1], ra.shape[1])
    pad = lambda a: torch.nn.functional.pad(a, (0, eb - a.shape[1]))
    src = torch.stack([pad(fa), pad(ra)]).reshape(2, nb * eb).to(torch.int32)
    count = torch.stack([b["deg_in"], b["deg_out"]]).to(torch.int32)       # [2, N]
    c = count.view(2, nb, BLOCK_D)
    base = torch.arange(nb, dtype=torch.int32, device=c.device)[:, None] * eb
    start = (c.cumsum(2, dtype=torch.int32) - c + base).view(2, n)
    return src.contiguous(), start.contiguous(), count.contiguous()


def struct_inputs(params, x_feat, b: dict, layernorm: bool) -> tuple:
    """(xi, wfold, w_hh, b_hh, ln_w, ln_b) of both towers and directions,
    with AggConv folded into the GRU input product (``struct_kernel.py:465-497``).
    ``params`` is the encoder tree with "source" / "target" towers."""
    st = {k: {n: torch.stack([params["source"][k][n], params["target"][k][n]])
              for n in params["source"][k]} for k in params["source"]}
    D = st["aggr"]["w"].shape[-1]
    deg = (b["deg_in"].to(x_feat.dtype), b["deg_out"].to(x_feat.dtype))
    xi, wfold, w_hh, b_hh = [], [], [], []
    for d, (aggr, gru) in enumerate(((st["aggr"], st["update"]), (st["aggr_r"], st["update_r"]))):
        w_ihD, w_ihX = gru["w_ih"][:, :D], gru["w_ih"][:, D:]     # [2, D, 3D], [2, F, 3D]
        wfold.append(aggr["w"] @ w_ihD)
        degb = deg[d][None, :, None] * aggr["b"][:, None, :]      # [2, N, D]
        xi.append(x_feat @ w_ihX + gru["b_ih"][:, None, :] + degb @ w_ihD)
        w_hh.append(gru["w_hh"])
        b_hh.append(gru["b_hh"])
    if layernorm:
        ln_w, ln_b = st["ln"]["w"], st["ln"]["b"]
    else:
        ln_w = x_feat.new_ones((2, D))
        ln_b = x_feat.new_zeros((2, D))
    return (torch.stack(xi), torch.stack(wfold), torch.stack(w_hh), torch.stack(b_hh),
            ln_w, ln_b)


def struct_towers(params, x_feat, b: dict, num_rounds: int, layernorm: bool):
    """Both towers over ``num_rounds`` rounds; returns (s, t), each [N, D].
    ``b`` is a device batch with fa_src / ra_src / deg_in / deg_out."""
    state = struct_core(*struct_inputs(params, x_feat, b, layernorm), struct_tables(b),
                        num_rounds, layernorm)
    return state[0], state[1]


def struct_core(xi, wfold, w_hh, b_hh, ln_w, ln_b, tables, num_rounds: int,
                layernorm: bool) -> torch.Tensor:
    """2 * num_rounds half-rounds of both towers; returns the state
    [2, N, D], differentiable with respect to the six float inputs."""
    floats = (xi, wfold, w_hh, b_hh, ln_w, ln_b)
    _check(floats, tables, num_rounds)
    dev = xi.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"struct_towers: no kernel for device {dev}")
    if dev.type == "cpu" and xi.dtype == torch.float32:
        return struct_towers_reference(*floats, tables, num_rounds, layernorm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in floats):
        return _StructTowers.apply(num_rounds, layernorm, *floats, *tables)
    if dev.type == "cpu":
        return struct_towers_reference(*floats, tables, num_rounds, layernorm)
    return _forward_cuda(floats, tables, num_rounds, layernorm, residuals=False)


def _neighbor_rows(start, count):
    """(row, node) of every list entry, nodes ascending, rows in list order."""
    cnt = count.long()
    node = torch.repeat_interleave(torch.arange(cnt.shape[0], device=cnt.device), cnt)
    first = start.long() - (cnt.cumsum(0) - cnt)
    rows = torch.repeat_interleave(first, cnt) + torch.arange(node.shape[0], device=cnt.device)
    return rows, node


def _neighbor_sum(x, src, rows, node):
    """out[:, v] = sum of x[:, u] over v's neighbors u; x [2, N, D]."""
    return torch.zeros_like(x).index_add_(1, node, x[:, src[rows].long()])


def _layernorm_stats(h):
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + 1e-5)


def struct_towers_reference(xi, wfold, w_hh, b_hh, ln_w, ln_b, tables, num_rounds: int,
                            layernorm: bool, with_residuals: bool = False):
    """The forward kernel's math, eager: returns the state [2, N, D], or
    with ``with_residuals`` (state, res [2R, 2, N, 7D]), res detached, both
    in xi's dtype (the value type). In bf16 the values are rounded where the
    JAX package's ``_struct_kernel`` rounds them (``struct_kernel.py:144``:
    nbr before its product; ``:158``: the residuals; ``:162``: the new
    state) and computed in fp32 between; the neighbor messages are bf16
    state rows already (``:91-99``)."""
    src, start, count = tables
    vdt = xi.dtype
    rnd = rounder(vdt)
    xi, wfold, w_hh, b_hh, ln_w, ln_b = (t.float() for t in (xi, wfold, w_hh, b_hh, ln_w, ln_b))
    D = wfold.shape[2]
    lists = [_neighbor_rows(start[d], count[d]) for d in (0, 1)]
    state = xi.new_ones((2, xi.shape[2], D))
    res = []
    for k in range(2 * num_rounds):
        d = k % 2
        nbr = _neighbor_sum(state, src[d], *lists[d])
        gi = rnd(nbr) @ wfold[d] + xi[d]
        gh = state @ w_hh[d] + b_hh[d][:, None, :]
        r = torch.sigmoid(gi[..., :D] + gh[..., :D])
        z = torch.sigmoid(gi[..., D : 2 * D] + gh[..., D : 2 * D])
        gh_n = gh[..., 2 * D :]
        nw = torch.tanh(gi[..., 2 * D :] + r * gh_n)
        h = (1.0 - z) * nw + z * state
        if with_residuals:
            res.append(torch.cat([nbr, state, r, z, nw, gh_n, h], dim=-1).to(vdt))
        if layernorm:
            mean, rstd = _layernorm_stats(h)
            h = (h - mean) * rstd * ln_w[:, None, :] + ln_b[:, None, :]
        state = rnd(h)
    if with_residuals:
        return state.to(vdt), torch.stack(res).detach()
    return state.to(vdt)


def _bwd_types(res, wfold, w_hh, ln_w):
    """(the dtypes of the six gradients: dxi the value type's, the weights'
    their own; the value type's rounder; the four inputs detached, in fp32)."""
    primal = (res.dtype, wfold.dtype, w_hh.dtype, w_hh.dtype, ln_w.dtype, ln_w.dtype)
    return primal, rounder(res.dtype), [t.detach().float() for t in (res, wfold, w_hh, ln_w)]


def struct_towers_bwd_reference(dstate, res, wfold, w_hh, ln_w, tables, num_rounds: int,
                                layernorm: bool):
    """The backward kernels' math, written out as the JAX package's
    ``_struct_bwd_kernel`` (``struct_kernel.py:234-335``): a reverse sweep over
    the residuals with the state's cotangent carried back, the transposed
    neighbor sum over the opposite direction's lists. Returns (dxi, dwfold,
    dwhh, dbhh, dlnw, dlnb) in the forward's layouts (dlnw / dlnb zero
    without LayerNorm): dxi and the weight gradients summed in fp32 and
    rounded once, dxi to the value type (res's dtype) and the weight
    gradients to their weights' dtypes (``struct_kernel.py:437-439``; the
    JAX kernel's dxi accumulator is an fp32 output, ``:388``, so its
    ``dxi_ref += dgi.astype(dxi_ref.dtype)`` at ``:308`` adds in fp32). In
    bf16 the state's cotangent is rounded as the JAX package carries it
    (``:335``)."""
    src, start, count = tables
    primal, rnd, (res, wfold, w_hh, ln_w) = _bwd_types(res, wfold, w_hh, ln_w)
    D = wfold.shape[2]
    lists = [_neighbor_rows(start[d], count[d]) for d in (0, 1)]
    dh = dstate.detach().float().clone()
    dxi = dh.new_zeros((2, 2, dh.shape[1], 3 * D))
    dwfold, dwhh = torch.zeros_like(wfold), torch.zeros_like(w_hh)
    dbhh = dh.new_zeros((2, 2, 3 * D))
    dlnw, dlnb = dh.new_zeros((2, D)), dh.new_zeros((2, D))
    for k in reversed(range(2 * num_rounds)):
        d = k % 2
        nbr, state_in, r, z, nw, gh_n, pre = res[k].split(D, dim=-1)
        if layernorm:
            mean, rstd = _layernorm_stats(pre)
            xhat = (pre - mean) * rstd
            dlnw += (dh * xhat).sum(1)
            dlnb += dh.sum(1)
            dxh = dh * ln_w[:, None, :]
            dh = rstd * (dxh - dxh.mean(-1, keepdim=True)
                         - xhat * (dxh * xhat).mean(-1, keepdim=True))
        # h = (1 - z) * nw + z * state_in
        dz = dh * (state_in - nw)
        dnw = dh * (1.0 - z)
        dnu = dnw * (1.0 - nw * nw)                   # pre-tanh
        drho = dnu * gh_n * r * (1.0 - r)             # pre-sigmoid r
        dzeta = dz * z * (1.0 - z)                    # pre-sigmoid z
        dgi = torch.cat([drho, dzeta, dnu], dim=-1)
        dgh = torch.cat([drho, dzeta, dnu * r], dim=-1)
        dxi[d] += dgi
        dwfold[d] += nbr.transpose(1, 2) @ dgi
        dwhh[d] += state_in.transpose(1, 2) @ dgh
        dbhh[d] += dgh.sum(1)
        if k > 0:   # the initial state is a constant
            dnbr = dgi @ wfold[d].transpose(1, 2)
            dh = dh * z + dgh @ w_hh[d].transpose(1, 2)
            dh.index_add_(1, lists[1 - d][1], dnbr[:, src[1 - d][lists[1 - d][0]].long()])
            dh = rnd(dh)
    return tuple(x.to(t) for x, t in zip((dxi, dwfold, dwhh, dbhh, dlnw, dlnb), primal))


def struct_towers_bwd_inplace(dstate, res, wfold, w_hh, ln_w, tables, num_rounds: int,
                              layernorm: bool, split_rows: int | None = None):
    """``struct_towers_bwd_reference``'s math in the backward kernel's order:
    one half-round's dgi / dgh / LayerNorm terms at a time, the weight
    gradients' partials per split of ``split_rows`` rows (by default
    ``partial_rows(N)``, as the kernel's wrapper takes them) accumulated in
    place into [2 dir, 2 tower, splits, ...] over the half-rounds, and
    summed over the splits in order at the end. Same arguments and returns."""
    src, start, count = tables
    primal, rnd, (res, wfold, w_hh, ln_w) = _bwd_types(res, wfold, w_hh, ln_w)
    N, D = dstate.shape[1], wfold.shape[2]
    rows = split_rows or partial_rows(N)
    splits = -(-N // rows)
    by_split = lambda x: torch.nn.functional.pad(x, (0, 0, 0, splits * rows - N)).view(
        2, splits, rows, x.shape[-1])
    lists = [_neighbor_rows(start[d], count[d]) for d in (0, 1)]
    dh = dstate.detach().float().clone()
    dxi = dh.new_zeros((2, 2, N, 3 * D))
    p_wf, p_wh = dh.new_zeros((2, 2, splits, D, 3 * D)), dh.new_zeros((2, 2, splits, D, 3 * D))
    p_bh, p_ln = dh.new_zeros((2, 2, splits, 3 * D)), dh.new_zeros((2, 2, splits, 2 * D))
    for k in reversed(range(2 * num_rounds)):
        d = k % 2
        nbr, state_in, r, z, nw, gh_n, pre = res[k].split(D, dim=-1)
        if layernorm:
            mean, rstd = _layernorm_stats(pre)
            xhat = (pre - mean) * rstd
            p_ln[d] += by_split(torch.cat([dh * xhat, dh], dim=-1)).sum(2)
            dxh = dh * ln_w[:, None, :]
            dh = rstd * (dxh - dxh.mean(-1, keepdim=True)
                         - xhat * (dxh * xhat).mean(-1, keepdim=True))
        dz = dh * (state_in - nw)
        dnu = dh * (1.0 - z) * (1.0 - nw * nw)
        drho = dnu * gh_n * r * (1.0 - r)
        dzeta = dz * z * (1.0 - z)
        dgi = torch.cat([drho, dzeta, dnu], dim=-1)
        dgh = torch.cat([drho, dzeta, dnu * r], dim=-1)
        dxi[d] += dgi
        p_wf[d] += by_split(nbr).mT @ by_split(dgi)
        p_wh[d] += by_split(state_in).mT @ by_split(dgh)
        p_bh[d] += by_split(dgh).sum(2)
        if k > 0:
            dnbr = dgi @ wfold[d].transpose(1, 2)
            dh = dh * z + dgh @ w_hh[d].transpose(1, 2)
            dh.index_add_(1, lists[1 - d][1], dnbr[:, src[1 - d][lists[1 - d][0]].long()])
            dh = rnd(dh)
    in_order = lambda p: functools.reduce(torch.add, p.unbind(2))   # over the splits
    ln = in_order(p_ln)
    ln = ln[0] + ln[1]
    out = (dxi, in_order(p_wf), in_order(p_wh), in_order(p_bh), ln[:, :D], ln[:, D:])
    return tuple(x.to(t) for x, t in zip(out, primal))


class _StructTowers(torch.autograd.Function):
    """The forward with residuals and the backward from them: on CUDA
    tensors the kernels, on CPU tensors (bf16 only) their plain versions.
    Counterpart of the JAX package's custom VJP ``pallas_struct_core``. The
    backward runs in the forward's matmul precision."""

    @staticmethod
    def forward(ctx, num_rounds, layernorm, xi, wfold, w_hh, b_hh, ln_w, ln_b, *tables):
        floats = (xi, wfold, w_hh, b_hh, ln_w, ln_b)
        ctx.precision = current_precision()
        if xi.is_cuda:
            state, res = _forward_cuda(floats, tables, num_rounds, layernorm, residuals=True)
        else:
            state, res = struct_towers_reference(*floats, tables, num_rounds, layernorm,
                                                 with_residuals=True)
        ctx.num_rounds, ctx.layernorm = num_rounds, layernorm
        ctx.save_for_backward(res, wfold, w_hh, ln_w, *tables)
        return state

    @staticmethod
    def backward(ctx, dstate):
        res, wfold, w_hh, ln_w, *tables = ctx.saved_tensors
        bwd = _backward_cuda if dstate.is_cuda else struct_towers_bwd_reference
        with matmul_precision(ctx.precision):
            grads = bwd(dstate, res, wfold, w_hh, ln_w, tuple(tables), ctx.num_rounds,
                        ctx.layernorm)
        # (num_rounds, layernorm, xi, wfold, w_hh, b_hh, ln_w, ln_b, src, start, count)
        return (None, None, *grads, None, None, None)


def _forward_cuda(floats, tables, num_rounds: int, layernorm: bool, residuals: bool):
    global launches
    xi, wfold, w_hh, b_hh, ln_w, ln_b = floats
    src, start, count = tables
    N, D = xi.shape[2], wfold.shape[2]
    _kernel_dim(D)
    dev = xi.device
    lib = _build.library()
    # the value type: xi, the state and the residuals; the weights go as fp32
    # copies (exact), which the kernel stages as it does fp32 weights
    vdt = dict(dtype=xi.dtype, device=dev)
    wfold, w_hh, b_hh, ln_w, ln_b = (t.float().contiguous()
                                     for t in (wfold, w_hh, b_hh, ln_w, ln_b))
    state = torch.ones((2, N, D), **vdt)
    scratch = torch.empty((2, N, D), **vdt)
    res = torch.empty((2 * num_rounds, 2, N, 7 * D), **vdt) if residuals else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_struct_towers_forward(
            *(t.data_ptr() for t in (xi, wfold, w_hh, b_hh)),
            ln_w.data_ptr() if layernorm else None, ln_b.data_ptr() if layernorm else None,
            *(t.data_ptr() for t in (src, start, count, state, scratch)),
            res.data_ptr() if residuals else None, num_rounds, N, D, src.shape[1],
            bf16_flag(xi), stream)
    _build.check(lib, code, "struct_towers kernel launch")
    launches += 2 * num_rounds
    return (state, res) if residuals else state


def _backward_cuda(dstate, res, wfold, w_hh, ln_w, tables, num_rounds: int, layernorm: bool):
    global bwd_launches
    src, start, count = tables
    N, D = dstate.shape[1], wfold.shape[2]
    _kernel_dim(D)
    dev = dstate.device
    lib = _build.library()
    f32 = dict(dtype=torch.float32, device=dev)
    primal = (res.dtype, wfold.dtype, w_hh.dtype, w_hh.dtype, ln_w.dtype, ln_w.dtype)
    # a contiguous fp32 copy (autograd may hand over an expanded cotangent),
    # which the kernels overwrite; in bf16 they round the state's cotangent
    # where it is complete, as the JAX package carries it in bf16
    g = torch.empty((2, N, D), **f32)
    g.copy_(dstate)
    # W_fold^T and W_hh^T [2, 2 dir, 2 tower, 3D, D]: the row products read a row of D a step
    wt = torch.stack((wfold, w_hh)).transpose(-1, -2).float().contiguous()
    ln_w = ln_w.float().contiguous()
    dxi = torch.empty((2, 2, N, 3 * D), **f32)
    dwfold, dwhh = (torch.empty((2, 2, D, 3 * D), **f32) for _ in range(2))
    dbhh = torch.empty((2, 2, 3 * D), **f32)
    dlnw, dlnb = torch.empty((2, D), **f32), torch.empty((2, D), **f32)
    dg, colsum, carry, part = (torch.empty(s, **f32) for s in bwd_scratch_shapes(N, D).values())
    rows = partial_rows(N)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_struct_towers_backward(
            g.data_ptr(), res.data_ptr(), wt.data_ptr(), ln_w.data_ptr() if layernorm else None,
            *(t.data_ptr() for t in (src, start, count, dxi, dwfold, dwhh, dbhh, dlnw, dlnb,
                                     dg, colsum, carry, part)),
            num_rounds, N, D, src.shape[1], rows, bf16_flag(res), stream)
    _build.check(lib, code, "struct_towers_bwd kernel launch")
    bwd_launches += 4 * num_rounds + 1
    # dxi and the weight gradients are summed in fp32, then rounded once
    return tuple(x.to(t) for x, t in zip((dxi, dwfold, dwhh, dbhh, dlnw, dlnb), primal))


def bwd_scratch_shapes(N: int, D: int) -> dict[str, tuple[int, ...]]:
    """The backward kernels' scratch: one half-round's whatever num_rounds.
    dg [drho | dzeta | dnu | dhn] and each warp's column sums; the next
    half-round's d nbr in two slots (the cotangent's copy carries the rest);
    the weight gradients' partials per direction, tower and split."""
    return {"dg": (2, N, 4 * D), "colsum": (2, -(-N // WARP_ROWS), 5 * D),
            "carry": (2, 2, N, D), "part": (2, 2, -(-N // partial_rows(N)), 6 * D * D + 5 * D)}


def partial_rows(N: int) -> int:
    """Rows per weight-gradient partial for N rows: ``SPLIT_ROWS``, halved
    down to 128 while that leaves fewer than ``MIN_SPLITS`` splits, so that
    a small batch still gives the partial launch enough blocks (a multiple
    of ``WARP_ROWS``: a split sums whole warps' column sums)."""
    rows = SPLIT_ROWS
    while rows > 128 and -(-N // rows) < MIN_SPLITS:
        rows //= 2
    return rows


def forward_layout(N: int, D: int) -> dict:
    """The forward kernel's launch at (N, D), as ``csrc/struct_towers.cu``
    computes it (its ``mgvae_struct_towers_forward_layout``): a block of
    ``FWD_WARPS`` warps owns ``FWD_ROWS`` rows a warp of one tower (grid y);
    its shared memory holds two buffers of ``chunk_rows`` rows of W_fold and
    W_hh, each gate padded to 32 * ceil(D / 32) columns, and each warp's
    nbr and state rows k-major."""
    _kernel_dim(D)
    cpt = -(-D // 32)
    dp, chunk = 32 * cpt, 16 if cpt <= 2 else 8
    floats = 2 * (2 * chunk * 3 * dp) + FWD_WARPS * 2 * dp * FWD_ROWS
    return {"grid": (-(-N // (FWD_ROWS * FWD_WARPS)), 2), "threads": 32 * FWD_WARPS,
            "smem_bytes": 4 * floats, "chunk_rows": chunk, "rows_per_warp": FWD_ROWS}


def _kernel_dim(D: int) -> None:
    if D > MAX_DIM:
        raise ValueError(f"struct_towers kernels take D <= {MAX_DIM}, got D={D} (a kernel "
                         f"limit: wider models take the eager towers, models/encoder)")


def _check(floats, tables, num_rounds: int) -> None:
    """Device, dtype, shape and contiguity checks of ``struct_core``'s
    arguments, for both routes."""
    xi = floats[0]
    if xi.dim() != 4 or xi.shape[:2] != (2, 2) or xi.shape[3] % 3:
        raise ValueError(f"struct_towers: xi must be [2, 2, N, 3D], got {tuple(xi.shape)}")
    N, D = xi.shape[2], xi.shape[3] // 3
    S = tables[0].shape[-1]
    vdt = torch.bfloat16 if xi.dtype == torch.bfloat16 else torch.float32
    want = {
        "xi": (2, 2, N, 3 * D), "wfold": (2, 2, D, 3 * D), "w_hh": (2, 2, D, 3 * D),
        "b_hh": (2, 2, 3 * D), "ln_w": (2, D), "ln_b": (2, D),
        "src": (2, S), "start": (2, N), "count": (2, N),
    }
    for (name, shape), t in zip(want.items(), (*floats, *tables)):
        dtype = vdt if name not in ("src", "start", "count") else torch.int32
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"struct_towers: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != xi.device:
            raise ValueError(f"struct_towers: {name} is on {t.device}, xi on {xi.device}")
        if not t.is_contiguous():
            raise ValueError(f"struct_towers: {name} must be contiguous")
    if num_rounds < 1 or N < 1 or S < 1:
        raise ValueError(f"struct_towers: num_rounds {num_rounds}, N {N}, table width {S}")
