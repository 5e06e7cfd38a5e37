"""The index lists that the level kernels read (``ops.level_kernel.level_lists``)
and the expert-major weight copy (``repack_expert_major``), on the CPU.

The lists are held against a numpy oracle on random tables in arbitrary row
order, and a plain walk that finds its work in the lists alone, the way the
CUDA kernels do (a slot at a time from ``slot_rows`` / ``in_rows``, the
sources' sums from ``src_rows``, the weight gradients over an expert's live
rows in chunks of levels with pairwise-summed partials), must reproduce
``level_scan_reference`` and ``level_scan_bwd_reference``.
"""
import numpy as np
import pytest
import torch

from mgvae_tpu_torch.ops import level_kernel as LK

torch.set_num_threads(1)

D, T = 8, 5
L, REAL, EP, NP, INPUTS = 6, 5, 64, 12, 6
EMPTY_LEVEL, BUSY_LEVEL, BUSY_FAN_IN = 2, 3, 40


def random_tables(seed: int, dim: int = D, experts: int = T):
    """level_scan's 12 arguments and the node count: level tables of ``L``
    levels (the last a padding level whose flags are set all the same:
    nothing past ``REAL`` may be read) in arbitrary row order: padding rows,
    edges into slots that are not updated, sources shared by several slots,
    slots with 0 and with 40 in-edges, a level with no updated slot. Node
    N - 1 is the dump row of the slots not updated."""
    rng = np.random.default_rng(seed)
    n = INPUTS + L * NP + 1
    src = np.zeros((L, EP), np.int32)
    dslot = np.zeros((L, EP), np.int32)
    evalid = np.zeros((L, EP), np.int32)
    nodes = np.full((L, NP), n - 1, np.int32)
    upd = np.zeros((L, NP), np.int32)
    e_n = rng.integers(0, experts, (L, NP)).astype(np.int32)
    known = list(range(INPUTS))
    for lv in range(L):
        if lv != EMPTY_LEVEL:
            upd[lv] = rng.random(NP) < 0.7
            upd[lv, :2] = 1
        ids = INPUTS + lv * NP + np.arange(NP)
        nodes[lv] = np.where(upd[lv] > 0, ids, n - 1)
        evalid[lv] = rng.random(EP) < 0.8
        dslot[lv] = rng.integers(1, NP, EP)              # slot 0 gets no in-edge ...
        if lv == BUSY_LEVEL:                             # ... and slot 1 of this level 40
            rows = rng.permutation(EP)[:BUSY_FAN_IN]
            dslot[lv] = np.where(dslot[lv] == 1, 2, dslot[lv])
            dslot[lv, rows], evalid[lv, rows] = 1, 1
        src[lv] = rng.choice(known[-2 * NP:], EP)        # few sources: many are shared
        known += [int(i) for i in ids[upd[lv] > 0]]
    pack = rng.standard_normal((L, EP, dim + 2)).astype(np.float32)
    pack[..., dim + 1] = np.take_along_axis(e_n, dslot, 1)
    scale = np.float32(1.2 / np.sqrt(dim))
    weights = [scale * rng.standard_normal(s).astype(np.float32) for s in (
        (dim, 2 * experts * dim), (dim, 3 * experts * dim), (experts, 3 * dim),
        (experts, 3 * dim), (experts, dim))]
    tensors = [torch.from_numpy(a) for a in (pack, src, dslot, evalid, nodes, upd, e_n, *weights)]
    return tensors, n


def oracle_lists(src, dslot, evalid, upd, e_n):
    """One level's lists by loops: (slot_rows, slot_off, in_rows, in_off,
    src_rows), each only as far as it is defined."""
    slots = sorted(np.flatnonzero(upd > 0), key=lambda s: (e_n[s], s))
    slot_off = [sum(1 for s in slots if e_n[s] < e) for e in range(T + 1)]
    in_rows, in_off = [], [0]
    for s in slots:
        in_rows += [j for j in range(len(src)) if evalid[j] > 0 and dslot[j] == s]
        in_off.append(len(in_rows))
    src_rows = sorted(in_rows, key=lambda j: (src[j], j))
    return slots, slot_off, in_rows, in_off, src_rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_level_lists_match_the_oracle(seed):
    args, _ = random_tables(seed)
    lists = LK.level_lists(args[1], args[2], args[3], args[5], args[6], T)
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in lists)
    assert [tuple(t.shape) for t in lists] == [(L, NP), (L, T + 1), (L, EP), (L, NP + 1), (L, EP)]
    tabs = [a.numpy() for a in args[1:7]]
    fan_in = []
    for lv in range(L):
        src, dslot, evalid, _, upd, e_n = (t[lv] for t in tabs)
        slots, slot_off, in_rows, in_off, src_rows = oracle_lists(src, dslot, evalid, upd, e_n)
        got = [t[lv].numpy() for t in lists]
        assert got[0][:len(slots)].tolist() == slots
        assert sorted(got[0].tolist()) == list(range(NP))            # a permutation of the slots
        assert got[1].tolist() == slot_off
        assert got[2][:len(in_rows)].tolist() == in_rows
        assert got[3][:len(in_off)].tolist() == in_off
        assert (got[3][len(in_off):] == len(in_rows)).all()          # in_off[Np]: the live rows
        assert got[4][:len(src_rows)].tolist() == src_rows
        fan_in += np.diff(in_off).tolist()
        if lv == EMPTY_LEVEL:
            assert slot_off == [0] * (T + 1) and in_rows == []
    assert 0 in fan_in and max(fan_in) >= BUSY_FAN_IN
    # one level's tables give that level's row of the lists
    one = LK.level_lists(*(args[i][1] for i in (1, 2, 3, 5, 6)), T)
    assert all(torch.equal(a, b) for a, b in zip(one, lists.rows(1, 2)))


def test_expert_major_repack_holds_each_experts_slices():
    """Expert e's slices, zero-padded from D = 8 to 32 rows and columns, and
    their transposes; laid side by side again they are the stacked matrices."""
    args, _ = random_tables(3)
    wkv_hf, w_ih = args[7], args[8]
    P = 32
    wkv_e, wih_e, wvt_e, wiht_e = LK.repack_expert_major(wkv_hf, w_ih, T, backward=True)
    assert [tuple(t.shape) for t in (wkv_e, wih_e, wvt_e, wiht_e)] == [
        (T, 2, P, P), (T, P, 3 * P), (T, P, P), (T, 3 * P, P)]
    assert all(t.is_contiguous() for t in (wkv_e, wih_e, wvt_e, wiht_e))
    gates = wih_e.view(T, P, 3, P)
    for e in range(T):
        assert torch.equal(wkv_e[e, 0, :D, :D], wkv_hf[:, e * D:(e + 1) * D])
        assert torch.equal(wkv_e[e, 1, :D, :D], wkv_hf[:, (T + e) * D:(T + e + 1) * D])
        for g in range(3):
            assert torch.equal(gates[e, :D, g, :D], w_ih[:, (3 * e + g) * D:(3 * e + g + 1) * D])
    assert int(wkv_e.count_nonzero()) == int(wkv_hf.count_nonzero())   # the padding is 0
    assert int(wih_e.count_nonzero()) == int(w_ih.count_nonzero())
    assert torch.equal(wvt_e, wkv_e[:, 1].transpose(1, 2))
    assert torch.equal(wiht_e, wih_e.transpose(1, 2))
    # and back: the slices laid side by side are the stacked matrices again
    assert torch.equal(wkv_e[:, :, :D, :D].permute(2, 1, 0, 3).reshape(D, 2 * T * D), wkv_hf)
    assert torch.equal(gates[:, :D, :, :D].permute(1, 0, 2, 3).reshape(D, 3 * T * D), w_ih)
    # a width that is a multiple of 32 is not padded
    wide, _ = random_tables(3, dim=32, experts=4)
    packed = LK.repack_expert_major(wide[7], wide[8], 4, backward=True)
    assert [tuple(t.shape) for t in packed] == [(4, 2, 32, 32), (4, 32, 96), (4, 32, 32),
                                                (4, 96, 32)]
    assert all(t.is_contiguous() for t in packed)
    assert torch.equal(packed[1][2], wide[8][:, 2 * 96:3 * 96])


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def unpadded(args):
    """(wkv_e [T, 2, D, D], wih_e [T, D, 3D]) of level_scan's arguments: the
    expert-major weights without their padding."""
    wkv_e, wih_e = LK.repack_expert_major(args[7], args[8], T)
    gates = wih_e.view(T, wih_e.shape[1], 3, -1)[:, :D, :, :D]
    return wkv_e[:, :, :D, :D].numpy(), gates.reshape(T, D, 3 * D).numpy()


def walk_forward(args, lists, n):
    """The forward as the kernels walk it: per level and expert, the
    expert's slots from the lists, each slot's in-edges in list order, the
    expert's own weight slices. Returns (hf, res_e, res_n), rows that no
    slot owns left at NaN."""
    pack, src, _, _, nodes, _, _, _, _, b_ih, b_hh, wa_k = (a.numpy() for a in args)
    wkv_e, wih_e = unpadded(args)
    slot_rows, slot_off, in_rows, in_off, _ = (t.numpy() for t in lists)
    hf = np.zeros((n, D), np.float32)
    res_e = np.full((L, EP, 3 * D + 1), np.nan, np.float32)
    res_n = np.full((L, NP, 4 * D), np.nan, np.float32)
    for lv in range(REAL):
        for e in range(T):
            for p in range(slot_off[lv, e], slot_off[lv, e + 1]):
                slot = slot_rows[lv, p]
                rows = in_rows[lv, in_off[lv, p]:in_off[lv, p + 1]]
                h = hf[src[lv, rows]]
                k, v = h @ wkv_e[e, 0], h @ wkv_e[e, 1] + pack[lv, rows, :D]
                score = pack[lv, rows, D] + k @ wa_k[e]
                ex = np.exp(np.clip(score - score.max(initial=-1e30), -80.0, 0.0))
                den = ex.sum(dtype=np.float32) + np.float32(1e-16)
                msg = (ex[:, None] * v).sum(0, dtype=np.float32) / den
                gi = msg @ wih_e[e] + b_ih[e]
                r = sigmoid(gi[:D] + b_hh[e, :D])
                z = sigmoid(gi[D:2 * D] + b_hh[e, D:2 * D])
                nw = np.tanh(gi[2 * D:] + r * b_hh[e, 2 * D:])
                hf[nodes[lv, slot]] = (1.0 - z) * nw
                res_e[lv, rows] = np.concatenate([h, k, v, (ex / den)[:, None]], 1)
                res_n[lv, slot] = np.concatenate([msg, r, z, nw])
    return hf, res_e, res_n


def pairwise(parts):
    """Sum of the partials as the bits of a binary counter carry."""
    stack = []
    for c, v in enumerate(parts):
        b = c
        while b & 1:
            v = stack.pop() + v
            b >>= 1
        stack.append(v)
    v = stack.pop()
    while stack:
        v = stack.pop() + v
    return v


def walk_backward(ghf, res_e, res_n, args, lists, per_block):
    """The backward as the kernels walk it: the reverse sweep (slot phase,
    then the sources' sums from ``src_rows``), then the weight gradients over
    each expert's live rows, ``per_block`` levels to a partial."""
    src, nodes, b_hh, wa_k = (args[i].numpy() for i in (1, 4, 10, 11))
    wkv_e, wih_e = unpadded(args)
    slot_rows, slot_off, in_rows, in_off, src_rows = (t.numpy() for t in lists)
    g = ghf.numpy().copy()
    d_pack = np.zeros((L, EP, D + 2), np.float32)
    dkv = np.full((L, EP, 2 * D), np.nan, np.float32)
    dg = np.full((L, NP, 6 * D), np.nan, np.float32)
    for lv in reversed(range(REAL)):
        dhf = np.full((EP, D), np.nan, np.float32)
        for e in range(T):
            for p in range(slot_off[lv, e], slot_off[lv, e + 1]):
                slot = slot_rows[lv, p]
                rows = in_rows[lv, in_off[lv, p]:in_off[lv, p + 1]]
                _, r, z, nw = np.split(res_n[lv, slot], 4)
                go = g[nodes[lv, slot]]
                dnu = go * (1.0 - z) * (1.0 - nw * nw)
                dzeta = -go * nw * z * (1.0 - z)
                drho = dnu * b_hh[e, 2 * D:] * r * (1.0 - r)
                dgi = np.concatenate([drho, dzeta, dnu])
                dg[lv, slot] = np.concatenate([dgi, drho, dzeta, dnu * r])
                dmsg = wih_e[e] @ dgi
                v, a = res_e[lv, rows, 2 * D:3 * D], res_e[lv, rows, 3 * D]
                dattn = v @ dmsg
                dscore = a * (dattn - (a * dattn).sum(dtype=np.float32))
                dv, dk = a[:, None] * dmsg, dscore[:, None] * wa_k[e]
                d_pack[lv, rows, :D], d_pack[lv, rows, D] = dv, dscore
                dkv[lv, rows] = np.concatenate([dk, dv], 1)
                dhf[rows] = dk @ wkv_e[e, 0].T + dv @ wkv_e[e, 1].T
        live = src_rows[lv, :in_off[lv, NP]]
        for i, j in enumerate(live):                 # a source's group starts where it changes
            if i == 0 or src[lv, live[i - 1]] != src[lv, j]:
                group = [t for t in live[i:] if src[lv, t] == src[lv, j]]
                g[src[lv, j]] += dhf[group].sum(0, dtype=np.float32)
    chunks = [range(c, min(c + per_block, REAL)) for c in range(0, REAL, per_block)]
    sums = [np.zeros(s, np.float32) for s in ((D, 2 * T * D), (D, 3 * T * D), (T, 3 * D),
                                              (T, 3 * D), (T, D))]
    d_wkv, d_wih, d_bih, d_bhh, d_wak = sums
    for e in range(T):
        parts = []
        for chunk in chunks:
            slots = [(lv, s) for lv in chunk
                     for s in slot_rows[lv, slot_off[lv, e]:slot_off[lv, e + 1]]]
            edges = [(lv, j) for lv in chunk for j in in_rows[
                lv, in_off[lv, slot_off[lv, e]]:in_off[lv, slot_off[lv, e + 1]]]]
            sl = tuple(np.array(slots, int).reshape(-1, 2).T)
            ed = tuple(np.array(edges, int).reshape(-1, 2).T)
            parts.append((res_e[ed][:, :D].T @ dkv[ed], d_pack[ed][:, D] @ res_e[ed][:, D:2 * D],
                          res_n[sl][:, :D].T @ dg[sl][:, :3 * D], dg[sl][:, :3 * D].sum(0),
                          dg[sl][:, 3 * D:].sum(0)))
        wkv, wak, wih, bih, bhh = (pairwise([p[i] for p in parts]) for i in range(5))
        d_wkv[:, e * D:(e + 1) * D] = wkv[:, :D]
        d_wkv[:, (T + e) * D:(T + e + 1) * D] = wkv[:, D:]
        d_wih[:, e * 3 * D:(e + 1) * 3 * D] = wih
        d_bih[e], d_bhh[e], d_wak[e] = bih, bhh, wak
    return (d_pack, *sums)


@pytest.mark.parametrize("seed", [0, 1])
def test_a_walk_over_the_lists_reproduces_the_plain_scan(seed):
    args, n = random_tables(seed)
    lists = LK.level_lists(args[1], args[2], args[3], args[5], args[6], T)
    hf_r, re_r, rn_r = LK.level_scan_reference(*args, num_nodes=n, num_levels=REAL,
                                               with_residuals=True)
    hf_w, re_w, rn_w = walk_forward(args, lists, n)
    assert float(hf_r.abs().max()) > 0.01
    np.testing.assert_allclose(hf_w, hf_r.numpy(), rtol=0, atol=1e-6)
    # the walk wrote exactly the rows of live edges and updated slots of the real levels
    e_live, s_live = (m.numpy().copy() for m in LK.live_rows(args[2], args[3], args[5]))
    e_live[REAL:], s_live[REAL:] = False, False
    assert (np.isnan(re_w).any(-1) == ~e_live).all() and (np.isnan(rn_w).any(-1) == ~s_live).all()
    np.testing.assert_allclose(re_w[e_live], re_r.numpy()[e_live], rtol=0, atol=1e-6)
    np.testing.assert_allclose(rn_w[s_live], rn_r.numpy()[s_live], rtol=0, atol=1e-6)
    assert (re_r.numpy()[~e_live] == 0).all() and (rn_r.numpy()[~s_live] == 0).all()


@pytest.mark.parametrize("seed,per_block", [(0, 1), (0, 2), (1, 4), (1, 8)])
def test_a_walk_over_the_lists_reproduces_the_plain_backward(seed, per_block):
    args, n = random_tables(seed)
    lists = LK.level_lists(args[1], args[2], args[3], args[5], args[6], T)
    _, res_e, res_n = LK.level_scan_reference(*args, num_nodes=n, num_levels=REAL,
                                              with_residuals=True)
    ghf = torch.from_numpy(np.random.default_rng(seed + 7).standard_normal((n, D))
                           .astype(np.float32))
    want = LK.level_scan_bwd_reference(ghf, res_e, res_n, *args[:9], args[10], args[11],
                                       num_levels=REAL)
    got = walk_backward(ghf, res_e.numpy(), res_n.numpy(), args, lists, per_block)
    for name, w, r in zip(("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak"), got, want):
        scale = max(float(r.abs().max()), 1.0)
        assert float(r.abs().max()) > 0, name
        np.testing.assert_allclose(w, r.numpy(), rtol=0, atol=1e-6 * scale, err_msg=name)


def test_wrappers_take_the_plain_versions_on_cpu_tensors_whatever_the_lists():
    """On CPU tensors ``level_scan`` / ``level_scan_giant`` / ``level_step``
    run the plain versions; ``lists`` is only ever read by the kernels."""
    args, n = random_tables(4)
    lists = LK.level_lists(args[1], args[2], args[3], args[5], args[6], T)
    want = LK.level_scan_reference(*args, num_nodes=n, num_levels=REAL)
    for scan in (LK.level_scan, LK.level_scan_giant):
        assert torch.equal(scan(*args, num_nodes=n, num_levels=REAL, lists=lists), want)
    step = (want, *(args[i][REAL - 1] for i in (0, 1, 2, 3, 5, 6)), *args[7:])
    assert torch.equal(LK.level_step(*step, lists=lists.rows(REAL - 1, REAL)),
                       LK.level_step_reference(*step))
