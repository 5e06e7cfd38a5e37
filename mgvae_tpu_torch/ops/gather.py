"""Row gathers whose index repeats: ``table[index]`` for one or more tables
that share the index, with a backward that sums every run of equal
indices across the card in an order fixed by the index.

Replaces no TPU kernel: it is the backward of XLA's gather, which the JAX
package's model leaves to XLA. On the card that backward would otherwise
be PyTorch's index backward, whose warp walks each run of equal indices
serially (one read-modify-write of the gradient row per entry), so that
it takes as long as the longest run; the model's gathers have runs of tens
of thousands (``csrc/gather_rows_bwd.cu``'s note).

``gather_rows(index, *tables)`` returns ``tuple(t[index] for t in
tables)``, the same values bit for bit. Without grad (serving, the val
phase) it is that and nothing else. With grad it goes through
``_GatherRows``, whose backward builds ``plan(index)`` (a stable sort: the
sorted keys, the permutation, each row's first sorted position) and then:

  * CUDA tensors: ``csrc/gather_rows_bwd.cu``, two launches for all the
    tables of the call (``bwd_launches``), or raise;
  * CPU tensors: ``gather_rows_bwd_reference``, ``zeros(R, W).index_add_(0,
    index, grad)`` a table: the serial sum in index order that the CPU's
    autograd of ``table[index]`` takes, bit for bit.

Nothing in the backward reads a size back to the host: the plan is torch
on the card, and both launches take a warp per ``chunk_len(n)`` sorted
positions, so a CUDA graph captures it. The index must lie in
[0, R) (the model's sites clamp theirs): an entry past the table's rows
gets no gradient. Tables are fp32 or bf16 of one dtype, at most
``MAX_TABLES`` a call, with any trailing shape (a 1-d table is width 1).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .precision import bf16_flag

MAX_TABLES = 4     # tables one call takes (csrc/gather_rows_bwd.cu kMaxTables)
LAYOUTS = {1: 4, 2: 2, 4: 2}   # values a lane loads at once -> most groups of them (csrc)

bwd_launches = 0


def gather_rows(index: torch.Tensor, *tables: torch.Tensor) -> tuple:
    """``tuple(t[index] for t in tables)``, differentiable with respect to
    the tables by ``_GatherRows``' backward."""
    if not tables or len(tables) > MAX_TABLES:
        raise ValueError(f"gather_rows takes 1 to {MAX_TABLES} tables, got {len(tables)}")
    if len({t.shape[0] for t in tables}) != 1:
        raise ValueError(f"gather_rows: the tables must have the same rows, got "
                         f"{[tuple(t.shape) for t in tables]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _GatherRows.apply(index, *tables)
    return tuple(t[index] for t in tables)


class _GatherRows(torch.autograd.Function):
    """``table[index]`` for each table; the backward of all of them from one
    plan of the index: on CUDA tensors the kernels, on CPU tensors the
    plain version."""

    @staticmethod
    def forward(ctx, index, *tables):
        ctx.save_for_backward(index)
        ctx.shapes = [t.shape for t in tables]
        return tuple(t[index] for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (index,) = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        flat = index.reshape(-1)
        rows = ctx.shapes[0][0]
        # autograd may hand over an expanded cotangent
        gs = [g.reshape(flat.shape[0], math.prod(s[1:])).contiguous()
              for g, s, n in zip(grads, ctx.shapes, need) if n]
        bwd = _backward_cuda if flat.is_cuda else gather_rows_bwd_reference
        got = iter(bwd(flat, gs, rows))
        return (None, *(next(got).reshape(s) if n else None for s, n in zip(ctx.shapes, need)))


def gather_rows_bwd_reference(index: torch.Tensor, grads: list, rows: int) -> list:
    """The plain version: each table's gradient [R, W] as the serial sum in
    index order, in the gradient's dtype, which is what the CPU's autograd
    of ``table[index]`` (``index_put_`` with accumulate) computes. fp32 goes
    through ``index_add_``, which sums in index order on any number of
    threads, where ``index_put_``'s threaded fp32 path adds atomically;
    bf16 through ``index_put_`` itself, which rounds at every add as
    autograd does (``index_add_`` with an int64 index sums bf16 in fp32)."""
    return [g.new_zeros((rows, g.shape[1])).index_add_(0, index, g) if g.dtype == torch.float32
            else g.new_zeros((rows, g.shape[1])).index_put_((index,), g, accumulate=True)
            for g in grads]


def gather_rows_bwd_fp32(index: torch.Tensor, grads: list, rows: int) -> list:
    """The plain version at the kernels' rounding points: each table's
    gradient summed in fp32 in index order and rounded once to the
    gradient's dtype (fp32 gradients: ``gather_rows_bwd_reference`` bit for
    bit). The card's bf16 gradients are held against this one: the CPU's
    autograd of ``table[index]`` rounds a bf16 sum at every add, which over
    a run of thousands of entries moves it further from the exact sum than
    the card's one rounding."""
    return [g.new_zeros((rows, g.shape[1]), dtype=torch.float32)
            .index_add_(0, index, g.float()).to(g.dtype) for g in grads]


def chunk_len(n: int) -> int:
    """Sorted positions a warp of the kernels sums, for n entries: 32 to
    128, so that a small batch still gives the card hundreds of warps and a
    large one keeps its longest run's partial sums few. A function of n
    alone, so the order of every sum is fixed by the index."""
    c = 32
    while c < 128 and c * 2048 < n:
        c *= 2
    return c


def gather_rows_bwd_chunks(index: torch.Tensor, grads: list, rows: int) -> list:
    """The kernels' arithmetic in their order, in plain torch on any device
    (a host sync for the largest count of partial sums): the sorted
    positions cut into chunks of ``chunk_len(n)``, each chunk's entries of a
    row summed in fp32 from 0 in sorted order, then each row's partial sums
    in chunk order, rounded once to the gradient's dtype. Every add is one
    fp32 add, so the kernels equal it bit for bit; a row inside one chunk
    equals the serial sum in index order."""
    keys, perm, _ = plan(index, rows)
    n = index.shape[0]
    size = chunk_len(n)
    chunks = -(-n // size)
    pos = torch.arange(n, device=index.device)
    new_key = keys != torch.cat([keys[:1] - 1, keys[:-1]])
    start = (pos % size == 0) | new_key                    # a segment starts
    end = torch.cat([new_key[1:], new_key.new_ones(min(n, 1))]) | (pos % size == size - 1)
    part_rows = keys[end]
    first = torch.searchsorted(part_rows, torch.arange(rows, dtype=keys.dtype,
                                                       device=keys.device))
    count = torch.searchsorted(part_rows, torch.arange(1, rows + 1, dtype=keys.dtype,
                                                       device=keys.device)) - first
    outs = []
    for g in grads:
        g32 = g.float()
        acc = g32.new_zeros((chunks, g.shape[1]))
        seg = g32.new_empty((n, g.shape[1]))
        for k in range(min(size, n)):
            i = torch.arange(k, n, size, device=index.device)
            m = i.shape[0]
            acc[:m] = torch.where(start[i, None], 0.0, acc[:m]) + g32[perm[i]]
            seg[i] = acc[:m]
        part = seg[end]
        out = g32.new_zeros((rows, g.shape[1]))
        for q in range(int(count.max()) if n else 0):
            live = (q < count)[:, None]
            out = torch.where(live, out + part[(first + q).clamp(max=part.shape[0] - 1)], out)
        outs.append(out.to(g.dtype))
    return outs


def plan(index: torch.Tensor, rows: int) -> tuple:
    """(keys, perm, offsets) of a flat index over ``rows`` rows on the
    index's device, without a host sync: the stable sort's keys (int32) and
    permutation (int64), and each row's first sorted position (int64,
    [rows + 1]): row r's entries are ``perm[offsets[r] : offsets[r + 1]]``,
    in index order."""
    keys, perm = torch.sort(index.to(torch.int32), stable=True)
    offsets = torch.searchsorted(keys, torch.arange(rows + 1, dtype=keys.dtype,
                                                    device=keys.device))
    return keys, perm, offsets


def _layout(grads: list, outs: list) -> tuple:
    """(values a lane loads at once, groups of them a lane): the widest load
    (4, 2 or 1 values) that divides every width, aligns every row and that
    the widest row fills across a warp, then enough groups (at most
    ``LAYOUTS[vec]``) that one walk over the entries covers it."""
    width = max(g.shape[1] for g in grads)
    vec = 1
    for v in (4, 2):
        nbytes = v * grads[0].element_size()
        if (all(g.shape[1] % v == 0 for g in grads) and width >= 32 * v
                and all(t.data_ptr() % nbytes == 0 for t in (*grads, *outs))):
            vec = v
            break
    return vec, min(LAYOUTS[vec], -(-width // (32 * vec)))


def _backward_cuda(index: torch.Tensor, grads: list, rows: int) -> list:
    """The kernels' wrapper: checks, the plan, scratch, two launches."""
    global bwd_launches
    _check(index, grads)
    dev, dtype, n = index.device, grads[0].dtype, index.shape[0]
    if n == 0 or rows == 0:
        return [g.new_zeros((rows, g.shape[1])) for g in grads]
    if rows >= 2**31 or n >= 2**31:
        raise ValueError(f"gather_rows: {rows} rows, {n} entries: past the kernels' int32")
    keys, perm, offsets = plan(index, rows)
    outs = [torch.empty((rows, g.shape[1]), dtype=dtype, device=dev) for g in grads]
    size = chunk_len(n)
    scratch = [torch.empty((-(-n // size), 2, g.shape[1]), dtype=torch.float32, device=dev)
               for g in grads]
    pad = MAX_TABLES - len(grads)
    ptrs = lambda ts: [t.data_ptr() for t in ts] + [None] * pad
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mgvae_gather_rows_backward(
            keys.data_ptr(), perm.data_ptr(), offsets.data_ptr(), *ptrs(grads), *ptrs(outs),
            *ptrs(scratch), len(grads), n, rows, *[g.shape[1] for g in grads], *[0] * pad,
            *_layout(grads, outs), size, bf16_flag(grads[0]), stream)
    _build.check(lib, code, "gather_rows_bwd kernel launch")
    bwd_launches += 2
    return outs


def _check(index: torch.Tensor, grads: list) -> None:
    """Device, dtype, shape and contiguity checks of the kernels' arguments."""
    if index.dtype not in (torch.int32, torch.int64) or index.dim() != 1:
        raise ValueError(f"gather_rows: the index must be a flat int32 / int64 tensor, got "
                         f"{index.dtype} {tuple(index.shape)}")
    if not 1 <= len(grads) <= MAX_TABLES:
        raise ValueError(f"gather_rows: 1 to {MAX_TABLES} tables, got {len(grads)}")
    for g in grads:
        if g.device != index.device:
            raise ValueError(f"gather_rows: a gradient is on {g.device}, the index on "
                             f"{index.device}")
        if g.dtype not in (torch.float32, torch.bfloat16) or g.dtype != grads[0].dtype:
            raise ValueError(f"gather_rows: the tables must be float32 or bfloat16, all alike; "
                             f"got {[x.dtype for x in grads]}")
        if g.dim() != 2 or g.shape[0] != index.shape[0] or g.shape[1] < 1:
            raise ValueError(f"gather_rows: a gradient of shape {tuple(g.shape)} for "
                             f"{index.shape[0]} entries")
        if not g.is_contiguous():
            raise ValueError("gather_rows: the gradients must be contiguous")
