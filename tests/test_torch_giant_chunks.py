"""The giant backward's chunks of levels (``ops.level_kernel``): K from its
byte budget (``giant_chunk_levels``), the chunks' order (``giant_chunks``),
the launches they cost (``giant_bwd_launch_count``), and the plain version in
the kernel's order, ``level_scan_giant_bwd_reference(..., chunk_levels=K)``:
recompute K levels, sweep them, sum their weight gradients, add the sums.

It is held against the per-level order (``chunk_levels=None``), against
autograd through the plain forward, and against the JAX package's
``pallas_level_scan_hbm`` VJP in interpret mode, its HBM kernels called
directly on the same tables.

Tolerances: chunked against per-level order within RECOMPUTE_TOL =
1e-5 * max(scale, 1) (only the order of the weight gradients' sums differs;
d_pack, summed in the same order, equal bit for bit); against autograd
1e-5 * scale; against JAX 1e-4 * max(scale, 1) for the gradients and
rtol 1e-4 / atol 1e-5 for hf, the JAX package's bounds for this route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgvae_tpu.ops.pallas.level_kernel as JK
from mgvae_tpu_torch.ops import level_kernel
from test_torch_giant import _port_case

torch.set_num_threads(1)
FLOAT_ARGS = level_kernel.FLOAT_ARGS
RECOMPUTE_TOL = 1e-5
MiB = 1 << 20


def _scratch_bytes(k, ep, np_, dim, experts):
    per_level, fixed = level_kernel._giant_scratch_floats(ep, np_, dim, experts)
    return 4 * (k * per_level + fixed)


def _budget(ep, np_, dim, levels, nodes):
    held = 4 * (2 * nodes * dim + levels * ep * (dim + 2))
    return max(level_kernel.SCRATCH_FLOOR, level_kernel.SCRATCH_SHARE * held)


# ---- K from the byte budget ---------------------------------------------------

@pytest.mark.parametrize("ep,np_,dim,levels,nodes,experts", [
    (1280, 512, 64, 224, 114_688, 4),      # the giant example (chip_smoke.py phases 15-18)
    (1280, 512, 64, 2016, 1_026_560, 4),   # its depth-2004 run
    (2560, 1024, 128, 64, 200_000, 5),     # wide levels at the largest D and T
    (40, 16, 16, 9, 200, 3),               # the CPU tests' mini scale: everything fits
    (1280, 512, 64, 3, 114_688, 4),        # fewer levels than the budget holds
    (400_000, 200_000, 128, 2, 500_000, 5),  # one level past the budget: K stays 1
])
def test_giant_chunk_levels_keeps_its_scratch_within_budget(ep, np_, dim, levels, nodes,
                                                            experts):
    k = level_kernel.giant_chunk_levels(ep, np_, dim, levels, nodes, experts)
    budget = _budget(ep, np_, dim, levels, nodes)
    assert 1 <= k <= levels
    assert k == 1 or _scratch_bytes(k, ep, np_, dim, experts) <= budget
    # as many levels as fit: one more would pass the budget, unless K is all of them
    assert k == levels or _scratch_bytes(k + 1, ep, np_, dim, experts) > budget
    if _scratch_bytes(levels, ep, np_, dim, experts) <= budget:
        assert k == levels


def test_giant_chunk_levels_leaves_phase_17s_check_room():
    """At the giant batch K is 4 to 8 levels, and its scratch leaves the
    level recurrence under 1.25 x (hf + ghf's copy + d_pack_lv) with the
    3% the route holds besides (lists, weight copies; 135.58 MiB against
    128.19 MiB on the card before chunking, with one level's scratch)."""
    ep, np_, dim, levels, nodes, experts = 1280, 512, 64, 224, 114_688, 4
    k = level_kernel.giant_chunk_levels(ep, np_, dim, levels, nodes, experts)
    law = 4 * (2 * nodes * dim + levels * ep * (dim + 2))
    assert 4 <= k <= 8
    assert 1.03 * law + _scratch_bytes(k, ep, np_, dim, experts) <= 1.25 * law - 4 * MiB


# ---- the chunks and their launches --------------------------------------------

@pytest.mark.parametrize("levels,k", [(200, 6), (5, 2), (5, 3), (5, 8), (7, 1), (1, 1),
                                      (0, 3)])
def test_giant_chunks_walk_the_levels_from_the_top(levels, k):
    chunks = level_kernel.giant_chunks(levels, k)
    covered = [lv for begin, end in chunks for lv in reversed(range(begin, end))]
    assert covered == list(reversed(range(levels)))          # each level once, from the top
    assert all(end - begin == k for begin, end in chunks[:-1])  # only the last is ragged
    assert all(1 <= end - begin <= k for begin, end in chunks)
    want = sum(3 + (end - begin > 1) for begin, end in chunks)
    assert level_kernel.giant_bwd_launch_count(levels, k) == want
    assert want <= 4 * len(chunks) and (levels == 0 or want < 4 * levels or k == 1)
    with pytest.raises(ValueError):
        level_kernel.giant_chunks(levels, 0)


# ---- the plain version in the kernel's order -----------------------------------

@pytest.mark.parametrize("k", [1, 3, "L"])
@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_chunked_bwd_reference_matches_the_per_level_order(modality, k):
    args, N, n_lv = _port_case(modality, seed=17)
    D = args[0].shape[2] - 2
    k = n_lv if k == "L" else k
    ghf = torch.tensor(np.random.default_rng(18).normal(size=(N, D)).astype(np.float32))
    hf = level_kernel.level_scan_giant_reference(*args, num_nodes=N, num_levels=n_lv)
    per_level = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *args, num_levels=n_lv)
    chunked = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *args, num_levels=n_lv,
                                                          chunk_levels=k)
    assert n_lv > 3 and len(level_kernel.giant_chunks(n_lv, k)) == -(-n_lv // k)
    assert torch.equal(chunked[0], per_level[0])              # d_pack: the same sums
    for c, p in zip(chunked, per_level):
        scale = max(float(p.abs().max()), 1.0)
        assert float(p.abs().max()) > 0
        assert float((c - p).abs().max()) <= RECOMPUTE_TOL * scale
        if k == 1:
            assert torch.equal(c, p)
    live = [a.clone().requires_grad_(i in FLOAT_ARGS) for i, a in enumerate(args)]
    auto = torch.autograd.grad(
        level_kernel.level_scan_giant_reference(*live, num_nodes=N, num_levels=n_lv),
        [live[i] for i in FLOAT_ARGS], ghf)
    for c, a in zip(chunked, auto):
        assert float((c - a).abs().max()) <= 1e-5 * float(a.abs().max())


@pytest.mark.parametrize("modality", ["mig", "xmg"])
def test_chunked_bwd_reference_matches_jax_hbm_vjp(modality):
    """K = 3 against the JAX package's giant route: ``pallas_level_scan_hbm``
    and its custom VJP (``fused_level_scan_hbm_bwd``, which recomputes from
    hf) in interpret mode on the same tables and weights."""
    args, N, n_lv = _port_case(modality, seed=23)
    D, T = args[0].shape[2] - 2, args[11].shape[0]
    ghf = np.random.default_rng(24).normal(size=(N, D)).astype(np.float32)
    hf = level_kernel.level_scan_giant_reference(*args, num_nodes=N, num_levels=n_lv)
    ours = level_kernel.level_scan_giant_bwd_reference(torch.tensor(ghf), hf, *args,
                                                       num_levels=n_lv, chunk_levels=3)
    tables = [jnp.asarray(a.numpy()) for a in args]

    def scan(*floats):
        full = list(tables)
        for i, x in zip(FLOAT_ARGS, floats):
            full[i] = x
        return JK.pallas_level_scan_hbm(*full, N, D, T, True)

    hf_j, vjp = jax.vjp(scan, *(tables[i] for i in FLOAT_ARGS))
    grads_j = vjp(jnp.asarray(ghf))
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_j), rtol=1e-4, atol=1e-5)
    for o, j in zip(ours, grads_j):
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1.0)
        assert float(np.abs(j).max()) > 0
        assert float(np.abs(o.numpy() - j).max()) <= 1e-4 * scale
