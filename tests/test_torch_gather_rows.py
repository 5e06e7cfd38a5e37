"""``ops.gather.gather_rows``: the model's row gathers whose index repeats,
with a backward that sums each run across the card in an order fixed by
the index (``csrc/gather_rows_bwd.cu``).

On the CPU: the forward and the gradients bit for bit against autograd of
``table[index]`` (one thread: the CPU's threaded fp32 index backward adds
atomically, in no fixed order), the plan against numpy, the kernels'
arithmetic in their order (``gather_rows_bwd_chunks``) against the plain
version, and the model's gradients with the op bit for bit those with
plain indexing. The cases marked ``cuda`` need a card and skip without
one; on a machine with one:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_rows.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from mgvae_tpu_torch.ops import gather

F32_EPS = 2.0 ** -24   # fp32's unit roundoff


def _index(case: str, seed: int = 0):
    """(index, rows) of one index case."""
    rng = np.random.default_rng(seed)
    if case == "one_value":
        return np.full(700, 3), 6
    if case in ("experts_t4", "experts_t5"):
        t = int(case[-1])
        return rng.integers(0, t, 900), t
    if case == "padding_runs":   # the level tables: padding slots name the last row
        idx = rng.integers(0, 199, (8, 100))
        idx[:, 60:] = 199
        return idx, 200
    if case == "unnamed_rows":   # odd rows named by no entry: gradient 0
        return 2 * rng.integers(0, 25, 400), 50
    if case == "empty":
        return np.zeros(0, np.int64), 7
    raise ValueError(case)


CASES = ("one_value", "experts_t4", "experts_t5", "padding_runs", "unnamed_rows", "empty")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(rows: int, widths, dtype, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((rows,) if w == 1 else (rows, w), generator=gen).to(dtype).requires_grad_()
            for w in widths]


def _cotangents(index, tables, seed: int = 2):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(tuple(index.shape) + tuple(t.shape[1:]), generator=gen).to(t.dtype)
            for t in tables]


def _against_autograd(index, tables):
    got = gather.gather_rows(index, *tables)
    want = tuple(t[index] for t in tables)
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    cot = _cotangents(index, tables)
    g_got = torch.autograd.grad(got, tables, cot)
    g_want = torch.autograd.grad(want, tables, cot)
    for a, b in zip(g_got, g_want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("width", [1, 64, 66])
@pytest.mark.parametrize("case", CASES)
def test_forward_and_gradients_equal_autograd_bit_for_bit(case, width, dtype, one_thread):
    idx, rows = _index(case)
    _against_autograd(torch.as_tensor(idx), _tables(rows, [width], dtype))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", CASES)
def test_tables_sharing_an_index_equal_autograd(case, index_dtype, one_thread):
    """bq, wa_q and ba by each node's expert: two wide tables and one of
    width 1 through one call."""
    idx, rows = _index(case)
    _against_autograd(torch.as_tensor(idx, dtype=index_dtype), _tables(rows, [64, 64, 1],
                                                                        torch.float32))


def test_only_the_tables_that_need_a_gradient_get_one(one_thread):
    idx, rows = _index("experts_t5")
    a, b = _tables(rows, [64, 64], torch.float32)
    b.requires_grad_(False)
    out = gather.gather_rows(torch.as_tensor(idx), a, b)
    (ga,) = torch.autograd.grad(out[0].sum() + out[1].sum(), [a])
    assert torch.equal(ga, torch.autograd.grad(a[torch.as_tensor(idx)].sum(), [a])[0])


def test_without_grad_it_is_plain_indexing():
    idx, rows = _index("experts_t4")
    idx = torch.as_tensor(idx)
    tables = _tables(rows, [64, 1], torch.float32)
    with torch.no_grad():
        out = gather.gather_rows(idx, *tables)
    assert all(o.grad_fn is None and torch.equal(o, t.detach()[idx])
               for o, t in zip(out, tables))
    with torch.inference_mode():
        assert torch.equal(gather.gather_rows(idx, tables[0])[0], tables[0][idx])


@pytest.mark.parametrize("case", CASES)
def test_plan_against_numpy(case):
    idx, rows = _index(case)
    flat = idx.reshape(-1)
    keys, perm, offsets = (t.numpy() for t in gather.plan(torch.as_tensor(flat), rows))
    want_perm = np.argsort(flat, kind="stable")
    assert keys.dtype == np.int32 and np.array_equal(keys, flat[want_perm])
    assert np.array_equal(perm, want_perm)
    assert np.array_equal(offsets, np.searchsorted(flat[want_perm], np.arange(rows + 1)))


def _order_against_plain(flat, rows, dtype, widths=(66, 1)):
    """``gather_rows_bwd_chunks`` (the kernels' sums in their order)
    against the plain version: bit for bit in fp32 on every row whose
    entries lie in one chunk of ``chunk_len(n)`` sorted positions; a row across chunks
    is summed in partial sums, so it differs by fp32 rounding only: at most
    (its entries) x 2^-24 x the sum of its |entries|. bf16 sums in fp32 and
    rounds once, where the plain version rounds at every add: within the
    plain version's own rounding of each add, 2^-8 relative."""
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn((flat.shape[0], w), generator=gen).to(dtype) for w in widths]
    got = gather.gather_rows_bwd_chunks(flat, grads, rows)
    want = gather.gather_rows_bwd_reference(flat, grads, rows)
    count = torch.bincount(flat, minlength=rows)
    first = torch.searchsorted(torch.sort(flat).values, torch.arange(rows))
    size = gather.chunk_len(flat.shape[0])
    one_chunk = (first // size) == ((first + count - 1).clamp(min=0) // size)
    for g, a, b in zip(grads, got, want):
        assert a.dtype == dtype and a.shape == b.shape
        scale = torch.zeros(rows, g.shape[1]).index_add_(0, flat, g.float().abs())
        if dtype == torch.float32:
            assert torch.equal(a[one_chunk], b[one_chunk])
            bound = count[:, None] * F32_EPS * scale
        else:
            bound = count[:, None] * 2.0 ** -8 * scale
        assert bool(((a.float() - b.float()).abs() <= bound).all())


@pytest.mark.parametrize("runs", [1, 127, 128, 129, 300, 1000])
def test_kernels_order_at_every_run_length(runs):
    """Rows of ``runs`` entries each, and one of the remainder, whose runs
    start and end inside chunks, on their edges and across many."""
    flat = torch.as_tensor(np.repeat(np.arange(7), runs)[: 6 * runs + 5])
    _order_against_plain(flat, 9, torch.float32)


@pytest.mark.parametrize("n,size", [(0, 32), (10240, 32), (65536, 32), (65537, 64),
                                    (114688, 64), (131073, 128), (286720, 128), (10**7, 128)])
def test_chunk_len(n, size):
    assert gather.chunk_len(n) == size


@pytest.mark.parametrize("n", [70000, 140000])
def test_kernels_order_at_every_chunk_len(n):
    """Indices long enough for chunks of 64 and 128: a third of the entries
    on one row (the padding), the rest over 5,000 rows."""
    rng = np.random.default_rng(n)
    flat = torch.as_tensor(np.where(rng.random(n) < 0.33, 4999, rng.integers(0, 5000, n)))
    _order_against_plain(flat, 5001, torch.float32, widths=(8, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES + ("long_runs",))
def test_kernels_order_against_the_plain_version(case, dtype):
    if case == "long_runs":
        idx, rows = np.where(np.arange(3000) % 3 == 0, 4, np.arange(3000) % 50), 60
    else:
        idx, rows = _index(case)
    _order_against_plain(torch.as_tensor(idx.reshape(-1)), rows, dtype)


@pytest.mark.parametrize("case", CASES + ("long_runs",))
def test_fp32_rounding_plain_version(case):
    """``gather_rows_bwd_fp32``, what the card's bf16 gradients are held
    against: fp32 bit for bit the plain version; bf16 the kernels' order
    (``gather_rows_bwd_chunks``) to within one bf16 rounding of the row,
    both sums in fp32 and rounded once."""
    if case == "long_runs":
        idx, rows = np.where(np.arange(3000) % 3 == 0, 4, np.arange(3000) % 50), 60
    else:
        idx, rows = _index(case)
    flat = torch.as_tensor(idx.reshape(-1))
    gen = torch.Generator().manual_seed(8)
    grads = [torch.randn((flat.shape[0], 66), generator=gen)]
    assert torch.equal(gather.gather_rows_bwd_fp32(flat, grads, rows)[0],
                       gather.gather_rows_bwd_reference(flat, grads, rows)[0])
    g16 = [grads[0].to(torch.bfloat16)]
    got = gather.gather_rows_bwd_fp32(flat, g16, rows)[0]
    order = gather.gather_rows_bwd_chunks(flat, g16, rows)[0]
    assert got.dtype == order.dtype == torch.bfloat16
    assert bool(((got.float() - order.float()).abs() <= 2.0 ** -8 * order.float().abs()).all())


def test_argument_checks():
    t = torch.zeros(5, 4, requires_grad=True)
    with pytest.raises(ValueError, match="same rows"):
        gather.gather_rows(torch.zeros(3, dtype=torch.long), t, torch.zeros(6, 4))
    with pytest.raises(ValueError, match="1 to 4 tables"):
        gather.gather_rows(torch.zeros(3, dtype=torch.long), *[t] * 5)
    idx = torch.zeros(3, dtype=torch.long)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather._check(idx, [torch.zeros(3, 4, dtype=torch.float16)])
    with pytest.raises(ValueError, match="contiguous"):
        gather._check(idx, [torch.zeros(4, 3).t()])
    with pytest.raises(ValueError, match="flat int32"):
        gather._check(idx.float(), [torch.zeros(3, 4)])
    with pytest.raises(ValueError, match="shape"):
        gather._check(idx, [torch.zeros(2, 4)])


def _model_grads(monkeypatch, plain: bool):
    from mgvae_tpu_torch import collate, random_circuit
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.train import losses, step

    if plain:
        for module in (dg_ae, losses):
            monkeypatch.setattr(module, "gather_rows", lambda i, *ts: tuple(t[i] for t in ts))
    calls = []
    real = gather._GatherRows.apply
    monkeypatch.setattr(gather._GatherRows, "apply",
                        lambda *a: calls.append(len(a) - 1) or real(*a))
    cfg = dg_ae.DGConfig(modality="xmg", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
    params, state = dg_ae.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    batch = collate([random_circuit(rng, "xmg", num_inputs=6, num_gates=40) for _ in range(3)])
    leaves = step.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    gen = torch.Generator().manual_seed(5)
    total, _ = step.loss_and_metrics(params, state, batch, gen, [1.0, 4.0, 4.0, 0.0], cfg, True)
    return torch.autograd.grad(total, leaves, allow_unused=True), calls


def test_model_gradients_equal_plain_indexing_bit_for_bit(monkeypatch, one_thread):
    """A DG_AE train step's loss on the CPU: every parameter's gradient
    with the op at the model's sites equals the one with plain indexing,
    bit for bit; the sites are the five gathers of ``level_statics`` (the
    experts' tables by node and by edge, hs by src, aq_n by dst), the
    pack by the level tables and the positive edges' s and t."""
    got, calls = _model_grads(monkeypatch, plain=False)
    with monkeypatch.context() as m:
        want, plain_calls = _model_grads(m, plain=True)
    assert sorted(calls) == [1, 1, 1, 1, 1, 3, 3] and plain_calls == []
    for a, b in zip(got, want, strict=True):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cell_sites(dev):
    from mgvae_tpu_torch.examples import gather_profile

    for tag, (modality, batch) in gather_profile.batches().items():
        for name, index, shapes in gather_profile.sites(modality, batch, dev)[:7]:
            yield f"{tag}: {name}", index, shapes


@pytest.mark.cuda
def test_kernels_at_the_cells_shapes_on_card(cuda):
    """Every site of a bs16 MIG and of the giant XMG train step: the kernels
    bit for bit their order in plain torch on the card, twice the same, and
    within fp32 rounding of the plain version on the CPU (a row across
    chunks of ``chunk_len(n)`` sorted positions is summed in partial sums: at most its
    entries x 2^-24 x the sum of its |entries|); 2 launches a call."""
    for name, index, shapes in _cell_sites(cuda):
        flat = index.reshape(-1)
        gen = torch.Generator(device=cuda).manual_seed(9)
        grads = [torch.randn((flat.shape[0], int(np.prod(s[1:]))), generator=gen, device=cuda)
                 for s in shapes]
        rows = shapes[0][0]
        before = gather.bwd_launches
        got = gather._backward_cuda(flat, grads, rows)
        again = gather._backward_cuda(flat, grads, rows)
        assert gather.bwd_launches - before == 4, name
        order = gather.gather_rows_bwd_chunks(flat, grads, rows)
        want = gather.gather_rows_bwd_reference(flat.cpu(), [g.cpu() for g in grads], rows)
        count = torch.bincount(flat.cpu(), minlength=rows)
        for g, a, b, o, w in zip(grads, got, again, order, want):
            assert torch.equal(a, b) and torch.equal(a, o), name
            scale = torch.zeros(rows, g.shape[1]).index_add_(0, flat.cpu(), g.cpu().abs())
            assert bool(((a.cpu() - w).abs() <= count[:, None] * F32_EPS * scale).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 64, 66, 128, 200, 300])
def test_kernels_bf16_and_layouts_on_card(cuda, width):
    """fp32 and bf16 (summed in fp32, rounded once) at every lane layout:
    a table of ``width`` alone (one to four values a lane load, one or two
    groups of them, 300 in two walks) and beside a table of width 1 (one
    value a load, up to four groups): bit for bit the kernels' order in
    plain torch."""
    rng = np.random.default_rng(width)
    flat = torch.as_tensor(np.where(rng.random(50000) < 0.4, 99, rng.integers(0, 120, 50000)),
                           device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=cuda).manual_seed(4)
        grads = [torch.randn((flat.shape[0], width), generator=gen, device=cuda).to(dtype),
                 torch.randn((flat.shape[0], 1), generator=gen, device=cuda).to(dtype)]
        for tables in (grads[:1], grads):
            got = gather._backward_cuda(flat, tables, 120)
            order = gather.gather_rows_bwd_chunks(flat, tables, 120)
            assert all(a.dtype == dtype and torch.equal(a, o) for a, o in zip(got, order))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take_on_card(cuda):
    idx = torch.zeros(8, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather._backward_cuda(idx, [torch.zeros(8, 4, dtype=torch.float16, device=cuda)], 3)
    out = gather._backward_cuda(idx[:0], [torch.zeros(0, 4, device=cuda)], 3)
    assert torch.equal(out[0], torch.zeros(3, 4, device=cuda))


@pytest.mark.cuda
def test_op_captured_and_replayed_in_a_cuda_graph_on_card(cuda):
    """Forward and backward of one call captured in a CUDA graph: a replay
    equals the eager call bit for bit, with new cotangents copied in."""
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(np.where(rng.random(20000) < 0.3, 4, rng.integers(0, 5, 20000)),
                          device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    tables = [torch.randn(5, 64, generator=gen, device=cuda).requires_grad_(),
              torch.randn(5, generator=gen, device=cuda).requires_grad_()]
    cot = [torch.randn(20000, 64, generator=gen, device=cuda),
           torch.randn(20000, generator=gen, device=cuda)]

    def call():
        out = gather.gather_rows(idx, *tables)
        return torch.autograd.grad(out, tables, cot)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for seed in (5, 6):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        for c in cot:
            c.copy_(torch.randn(c.shape, generator=gen, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, call()))


@pytest.mark.cuda
def test_launches_counted_in_eager_steps_and_replays_on_card(cuda):
    """Two K = 2 train and eval calls (each layout's first step eager, then
    a capture and replays) against the same steps eagerly and against a
    second run of the same calls: the same parameters bit for bit and the
    same ``gather.bwd_launches``: two a call of the op, seven calls a train
    step, none in eval."""
    from mgvae_tpu_torch import random_circuit
    from mgvae_tpu_torch.data import batching
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.train import step

    rng = np.random.default_rng(7)
    shards = [[random_circuit(rng, "mig", num_inputs=8, num_gates=100) for _ in range(4)]
              for _ in range(2)]
    dims: dict = {}
    for sh in shards:
        for k, v in batching.natural_dims(sh).items():
            dims[k] = max(dims.get(k, 0), v)
    sb = batching.collate_shards(shards, dims=dims)
    weights = [1.0, 4.0, 4.0, 0.0]

    def run(grouped):
        cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2,
                             layernorm=True, matmul_precision="highest")
        params, state = dg_ae.init_params(cfg, seed=1, device="cuda")
        opt = step.make_optimizer(params, 1e-3)
        gen = torch.Generator(device="cuda").manual_seed(2)
        multi, multi_eval = step.make_multi_step(cfg, opt), step.make_multi_eval(cfg)
        train_step, eval_step = step.make_train_step(cfg, opt)
        before = gather.bwd_launches
        for _ in range(2):
            if grouped:
                state, _ = multi(params, state, sb, gen, weights)
                multi_eval(params, state, sb, gen, weights)
            else:
                for k in range(2):
                    state, _ = train_step(params, state, step.step_of(sb, k), gen, weights)
                for k in range(2):
                    eval_step(params, state, step.step_of(sb, k), gen, weights)
        torch.cuda.synchronize()
        captures = multi.captures + multi_eval.captures
        return step.param_leaves(params), gather.bwd_launches - before, captures

    graph, eager, again = run(True), run(False), run(True)
    assert graph[2] == again[2] == 2
    for other in (eager, again):
        assert all(torch.equal(a, b) for a, b in zip(graph[0], other[0], strict=True))
    assert graph[1] == eager[1] == again[1] == 4 * 7 * 2
