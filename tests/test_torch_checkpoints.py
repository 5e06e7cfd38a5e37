"""Foreign checkpoints in the port: reference ``.pth`` state dicts
(``utils/torch_compat``), the JAX package's flax msgpack checkpoints read
without flax or msgpack (``utils/msgpack_read``), ``Model.load`` /
``load_pretrained`` and a trainer resumed from a JAX run.

Reference files come from ``benchmarks/torch_reference.ReferenceModel``
(the reference's parameter names); their encode must equal that model's
own forward and the JAX package's ``Model.load`` of the same file, at the
tolerances of tests/test_model_parity.py:41-42 (hs rtol 1e-4 / atol 1e-5,
hf atol 1e-4). The msgpack reader must give back what
``flax.serialization.msgpack_restore`` and ``msgpack.unpackb`` give, leaf
for leaf and bit for bit. A resumed step is held to one JAX step from the
same file as tests/test_torch_train_step.py holds an Adam step.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import mgvae_tpu
from benchmarks.torch_reference import ReferenceModel
from mgvae_tpu.data.batching import collate
from mgvae_tpu.data.synthetic import random_circuit as jrandom_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu.train import trainer as jtrainer
from mgvae_tpu.utils import checkpoint as jckpt
import mgvae_tpu_torch
from mgvae_tpu_torch.data.graph import build_graph
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train import trainer as ptrainer
from mgvae_tpu_torch.utils import checkpoint as pckpt
from mgvae_tpu_torch.utils import msgpack_read
from mgvae_tpu_torch.utils.params import params_to_numpy
from mgvae_tpu_torch.utils.torch_compat import params_from_torch_state

torch.set_num_threads(1)
D = 32
KW = dict(dim_hidden=D, s_rounds=2, t_rounds=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference(modality, layernorm, seed=0):
    torch.manual_seed(seed)
    ref = ReferenceModel(modality, layernorm=layernorm, **KW)
    ref.eval()
    return ref


def _circuit(modality, seed=42):
    return jrandom_circuit(np.random.default_rng(seed), modality, num_inputs=5, num_gates=30)


# ---- reference state dicts -------------------------------------------------------

@pytest.mark.parametrize("layernorm", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_reference_pth_encodes_as_reference_and_jax(modality, layernorm, tmp_path):
    """A reference model's state dict through ``Model.load`` (wrapped as
    the reference trainer saves it with layernorm, bare without): the
    encode equals the reference model's forward and the JAX package's
    ``Model.load`` of the same file."""
    ref = _reference(modality, layernorm)
    sd = ref.state_dict()
    path = str(tmp_path / "ref.pth")
    torch.save({"epoch": 3, "state_dict": sd} if layernorm else sd, path)
    assert pckpt._read_any(path, "cpu")[0] == "reference"
    g = _circuit(modality)
    with torch.no_grad():
        hs_t, hf_t = ref(torch.from_numpy(g.gate).long(), torch.from_numpy(g.edge_index),
                         torch.from_numpy(g.forward_level).long())
    model = mgvae_tpu_torch.Model(modality=modality, layernorm=layernorm, device="cpu",
                                  **KW).load(path)
    hs, hf = model(build_graph(g.name, g.gate, g.edge_index))
    np.testing.assert_allclose(hs.numpy(), hs_t.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), hf_t.numpy(), rtol=1e-4, atol=1e-4)
    hs_j, hf_j = mgvae_tpu.Model(modality=modality, layernorm=layernorm, **KW).load(path)(g)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_j), rtol=0, atol=1e-4)
    epoch, params, _ = pckpt.load_torch_checkpoint(path, model.cfg, "cpu")
    assert epoch == (3 if layernorm else 0)
    for a, c in zip(PS.param_leaves(params), PS.param_leaves(model.params), strict=True):
        assert a.dtype == torch.float32 and torch.equal(a, c)


def test_module_prefix_and_inner_fc_names(tmp_path):
    """A DDP-saved file (``module.`` prefixes) whose readout keeps the MLP's
    inner ``fc`` Sequential converts to the same params and state as the
    plain names, as in the JAX package."""
    sd = _reference("xmg", True).state_dict()
    odd = {"module." + k.replace("readout_prob.", "readout_prob.fc."): v for k, v in sd.items()}
    cfg = P.DGConfig(modality="xmg", layernorm=True, **KW)
    got, want = (params_from_torch_state(x, cfg, device="cpu") for x in (odd, sd))
    for a, c in zip(PS.param_leaves(got), PS.param_leaves(want), strict=True):
        assert torch.equal(a, c)
    from mgvae_tpu.utils.torch_compat import params_from_torch_state as jconvert
    jgot = jconvert(odd, J.DGConfig(modality="xmg", layernorm=True, **KW))
    for a, c in zip(PS.param_leaves(params_to_numpy(got)), PS.param_leaves(_np(jgot)), strict=True):
        np.testing.assert_array_equal(a, c)


def test_variational_heads_load(tmp_path):
    """DG_VAE's heads ``fc_{s,t}_{mu,logstd}`` come from the file where it
    holds them; a file without them leaves the model's own."""
    sd = _reference("mig", True).state_dict()
    gen = torch.Generator().manual_seed(1)
    heads = {f"{h}.{p}": torch.randn((D, D) if p == "weight" else (D,), generator=gen)
             for h in ("fc_s_mu", "fc_s_logstd", "fc_t_mu", "fc_t_logstd") for p in ("weight", "bias")}
    path = str(tmp_path / "vae.pth")
    torch.save({"epoch": 1, "state_dict": {**sd, **heads}}, path)
    m = mgvae_tpu_torch.Model(modality="mig", layernorm=True, variational=True, device="cpu",
                              **KW)
    m.load(path)
    for h in ("fc_s_mu", "fc_s_logstd", "fc_t_mu", "fc_t_logstd"):
        assert torch.equal(m.params[h]["w"], heads[f"{h}.weight"].T)
        assert torch.equal(m.params[h]["b"], heads[f"{h}.bias"])
    _, loaded, _ = pckpt.load_torch_checkpoint(path, m.cfg, "cpu")
    assert set(loaded) == set(m.params)
    torch.save(sd, path)
    fresh = mgvae_tpu_torch.Model(modality="mig", layernorm=True, variational=True, seed=5,
                                  device="cpu", **KW)
    own = fresh.params["fc_s_mu"]["w"].clone()
    fresh.load(path)
    assert torch.equal(fresh.params["fc_s_mu"]["w"], own)
    assert torch.equal(fresh.params["hs_linear"]["w"], sd["hs_linear.weight"].T)


def test_a_reference_file_of_another_width_raises_value_error(tmp_path):
    """A D = 64 file read under D = 256 is refused with the leaf, both
    shapes and the config named, before any kernel sees it."""
    torch.manual_seed(0)
    path = str(tmp_path / "d64.pth")
    torch.save({"state_dict": ReferenceModel("mig", dim_hidden=64, layernorm=True).state_dict()},
               path)
    model = mgvae_tpu_torch.Model(modality="mig", dim_hidden=256, layernorm=True, device="cpu")
    with pytest.raises(ValueError, match=r"params\.struct\.source\.aggr\.w: shape \(64, 64\)"):
        model.load(path)


class _Code:
    """An object whose unpickling runs code, as torch.save pickles it."""


def test_files_needing_pickled_code_are_refused(tmp_path):
    path = str(tmp_path / "code.pth")
    torch.save({"epoch": 1, "state_dict": _reference("aig", False).state_dict(),
                "extra": _Code()}, path)
    with pytest.raises(ValueError, match="code.pth.*weights_only=True"):
        mgvae_tpu_torch.Model(modality="aig", device="cpu", **KW).load(path)


@pytest.mark.parametrize("content", [b"", b"\x00\x01\x02", b"PK\x03\x04broken zip",
                                     b"\x81\xa1a\xc1", b"\x81\xa6params\xc7\x01\x09x",
                                     b"\x92\x01\x02"],
                         ids=["empty", "bytes", "bad_zip", "reserved_byte", "unknown_ext",
                              "msgpack_array"])
def test_unknown_bytes_raise_value_error(content, tmp_path):
    path = str(tmp_path / "x.pth")
    with open(path, "wb") as f:
        f.write(content)
    m = mgvae_tpu_torch.Model(device="cpu", **KW)
    with pytest.raises(ValueError):
        m.load(path)
    with pytest.raises(ValueError):
        pckpt.load_torch_checkpoint(path, m.cfg, "cpu")


def test_load_pretrained(tmp_path):
    """Without weights in the package ``load_pretrained()`` raises
    FileNotFoundError naming the path; with a path it loads the file."""
    m = mgvae_tpu_torch.Model(modality="mig", layernorm=True, device="cpu", **KW)
    want = os.path.join(os.path.dirname(mgvae_tpu_torch.__file__), "pretrained", "model.pth")
    with pytest.raises(FileNotFoundError, match=want):
        m.load_pretrained()
    sd = _reference("mig", True).state_dict()
    path = str(tmp_path / "model.pth")
    torch.save({"epoch": 2, "state_dict": sd}, path)
    assert m.load_pretrained(path) is m
    assert torch.equal(m.params["hs_linear"]["b"], sd["hs_linear.bias"])


# ---- the JAX package's msgpack checkpoints ----------------------------------------

def _same(got, want, path="root"):
    """Leaf for leaf and bit for bit: types, dtypes, shapes and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, c) in enumerate(zip(got, want)):
            _same(a, c, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, np.ndarray) == isinstance(want, np.ndarray), path
        if np.asarray(want).dtype.name != "bfloat16":
            assert type(got) is type(want), (path, type(got), type(want))
        want_a = np.asarray(want)
        if want_a.dtype.name == "bfloat16":
            want_a = want_a.astype(np.float32)    # exact: the reader widens bf16 to f32
        assert np.asarray(got).dtype == want_a.dtype and np.shape(got) == want_a.shape, path
        assert np.asarray(got).tobytes() == want_a.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX ``Trainer``'s model_last.pth after one epoch of stage-3 training."""
    tmp_path = tmp_path_factory.mktemp("jax_run")
    cfg = J.DGConfig(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
    rng = np.random.default_rng(0)
    graphs = [jrandom_circuit(rng, "mig", num_inputs=4, num_gates=16, num_tt_pairs=8)
              for _ in range(8)]
    jt = jtrainer.Trainer(None, cfg, save_dir=str(tmp_path), training_id="j", batch_size=4,
                          distributed=False, seed=1, fixed_dims=False, steps_per_call=1,
                          thin_wire=False)
    jt.set_training_args(rc_prob_func_weight=[1.0, 4.0, 4.0], lr=1e-3, lr_step=50)
    jt.train(1, graphs, graphs[:4])
    return cfg, jt, graphs, str(tmp_path / "j" / "model_last.pth")


def test_jax_checkpoints_decode_bit_for_bit(jax_run, tmp_path):
    """``save_checkpoint`` (params, state and an Adam state after two steps)
    and a JAX Trainer's model_last.pth decode as flax's own reader decodes
    them."""
    cfg = J.DGConfig(modality="xag", dim_hidden=8, layernorm=True, variational=True)
    params, state = J.init_params(jax.random.PRNGKey(0), cfg)
    opt = JS.make_optimizer(1e-3)
    opt_state = opt.init(params)
    grads = jax.tree.map(lambda x: jnp.ones_like(x) * 0.5, params)
    update = jax.jit(opt.update)
    for _ in range(2):
        _, opt_state = update(grads, opt_state, params)
    path = str(tmp_path / "a.pth")
    jckpt.save_checkpoint(path, 7, params, state, opt_state, 2.5e-4)
    *_, trainer_path = jax_run
    for p in (path, trainer_path):
        with open(p, "rb") as f:
            want = serialization.msgpack_restore(f.read())
        assert pckpt._read_any(p, "cpu")[0] == "jax"
        _same(msgpack_read.read(p), want)


@pytest.mark.parametrize("value", [
    0, 127, -1, -32, -33, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    1.5, -0.0, 3.0e38, None, True, False, "", "é" * 40, "x" * 300, "y" * 70000,
    b"", b"\x00" * 5, b"z" * 300, b"w" * 70000,
    [], [1, [2, [3, None]]], list(range(20)), list(range(70000)),
    {}, {"a": 1, "b": {"c": [1.25, "d"]}}, {f"k{i}": i for i in range(20)},
], ids=lambda v: type(v).__name__ + (str(len(v)) if hasattr(v, "__len__") else repr(v)))
def test_msgpack_reader_matches_msgpack(value):
    """Every type and width of the format (fixint to int64 and uint64, both
    float widths, fix/8/16/32 str and bin, fix/16/32 arrays and maps) as the
    msgpack package decodes it."""
    for single in (False, True):
        data = msgpack.packb(value, use_bin_type=True, use_single_float=single)
        assert msgpack_read.loads(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "uint8", "bool",
                                   "float16", "bfloat16"])
def test_msgpack_reader_reads_flax_arrays_and_scalars(dtype):
    """flax's ndarray and numpy-scalar extensions of every common dtype,
    0-d to 3-d (bfloat16 widened to float32, exactly)."""
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s).astype(jnp.dtype(dtype)) for s in ((), (3,), (2, 0), (2, 3, 4))]
    tree = {"arrays": {str(i): a for i, a in enumerate(arrays)},
            "scalar": arrays[1][0], "n": np.int64(7), "lr": np.float64(0.1)}
    data = serialization.msgpack_serialize(tree)
    _same(msgpack_read.loads(data), serialization.msgpack_restore(data))


def test_msgpack_reader_joins_flax_chunked_arrays(monkeypatch):
    """Leaves past flax's chunk size come as chunked maps; they are joined
    back, as ``msgpack_restore`` joins them."""
    import flax.serialization as fs

    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "nested": {"x": np.arange(40, dtype=np.int64)}, "small": np.ones(3, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_read.loads(data)
    _same(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


@pytest.mark.parametrize("data", [
    msgpack.packb([1, 2])[:-1],                                  # truncated
    msgpack.packb({"a": 1}) + b"\x00",                           # trailing bytes
    b"\xc1",                                                     # the reserved type byte
    msgpack.packb(msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))),  # flax's complex scalar
    msgpack.packb(msgpack.ExtType(9, b"x")),                     # an unknown extension
    msgpack.packb(msgpack.ExtType(1, msgpack.packb(([2], "float32", b"\x00" * 4)))),  # short
    msgpack.packb(msgpack.ExtType(1, msgpack.packb(([1], "object", b"\x00" * 8)))),
    msgpack.packb({1: 2}, strict_types=False),                  # a non-string map key
], ids=["truncated", "trailing", "reserved", "complex", "unknown_ext", "short_buffer",
        "object_dtype", "int_key"])
def test_msgpack_reader_refuses_what_it_does_not_read(data):
    with pytest.raises(ValueError):
        msgpack_read.loads(data)


def test_jax_model_save_loads_into_the_port(tmp_path):
    """The JAX ``Model.save`` (no optimizer state) through the port's
    ``Model.load``: the params and the BatchNorm state bit for bit."""
    jm = mgvae_tpu.Model(modality="mig", layernorm=True, **KW)
    path = str(tmp_path / "m.pth")
    jm.save(path)
    pm = mgvae_tpu_torch.Model(modality="mig", layernorm=True, seed=3, device="cpu", **KW)
    pm.load(path)
    for a, c in zip(PS.param_leaves(params_to_numpy(pm.params)) + PS.param_leaves(
            params_to_numpy(pm.state)), PS.param_leaves(_np(jm.params)) + PS.param_leaves(
            _np(jm.state)), strict=True):
        np.testing.assert_array_equal(a, c)


def test_resume_from_a_jax_trainer_steps_as_jax(jax_run, tmp_path):
    """A port ``Trainer`` resumed from a JAX Trainer's model_last.pth holds
    its params, BatchNorm state, epoch, lr and Adam state (count, mu, nu as
    step, exp_avg, exp_avg_sq); its next step equals one JAX step from the
    same file with the same draws."""
    jcfg, jt, graphs, path = jax_run
    os.makedirs(tmp_path / "j")
    shutil.copy(path, tmp_path / "j" / "model_last.pth")
    pcfg = P.DGConfig(**{f: getattr(jcfg, f) for f in ("modality", "dim_hidden", "s_rounds",
                                                        "t_rounds", "layernorm")})
    pt = ptrainer.Trainer(None, pcfg, save_dir=str(tmp_path), training_id="j", batch_size=4,
                          distributed=False, steps_per_call=1, device="cpu")
    assert pt.resume()
    # the JAX side of the same file, through the JAX package's own reader
    epoch, lr, jp, js, jo = jckpt.load_checkpoint(path, jt.params, jt.state, jt.opt_state)
    assert pt.model_epoch == epoch == 0 and pt.lr == lr == 1e-3
    assert pt.optimizer.param_groups[0]["lr"] == lr
    for a, c in zip(PS.param_leaves(params_to_numpy(pt.params)), PS.param_leaves(_np(jp)),
                    strict=True):
        np.testing.assert_array_equal(a, c)
    inner = jo.inner_state[0]
    opt = pt.optimizer.state_dict()["state"]
    for i, (m, v) in enumerate(zip(jax.tree.leaves(inner.mu), jax.tree.leaves(inner.nu))):
        np.testing.assert_array_equal(opt[i]["exp_avg"].numpy(), np.asarray(m))
        np.testing.assert_array_equal(opt[i]["exp_avg_sq"].numpy(), np.asarray(v))
        assert float(opt[i]["step"]) == int(inner.count) == 2

    weights = [1.0, 4.0, 4.0, 0.0]
    hb = collate(graphs[:4])
    key = jax.random.PRNGKey(11)
    j_step, _ = JS.make_train_step(jcfg, JS.make_optimizer(lr), mesh=None, donate=False)
    p1_j, s1_j, _, m_j = j_step(jp, js, jo, jax.tree.map(jnp.asarray, hb), key,
                                jnp.asarray(weights))
    _, k_neg, k_drop = jax.random.split(key, 3)
    neg = tuple(torch.tensor(np.asarray(x)) for x in
                JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0],
                                         jax.tree.map(jnp.asarray, hb)))
    keep = [torch.tensor(np.asarray(jax.random.bernoulli(k, 0.8, (hb["gate"].shape[0],
                                                                  pcfg.dim_mlp))))
            for k in jax.random.split(k_drop, 2)]
    pt.state, m_p = pt.train_step(pt.params, pt.state, hb, None, weights, neg_edges=neg,
                                  drop_keep=keep)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    for a, c in zip(PS.param_leaves(params_to_numpy(pt.state)), PS.param_leaves(_np(s1_j))):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    # the updates agree wherever the step's gradient is well away from 0
    # (elsewhere Adam's ratio of two rounding-sized numbers may differ)
    grad = jax.jit(jax.grad(lambda p: JS.loss_and_metrics(
        p, js, jax.tree.map(jnp.asarray, hb), key, jnp.asarray(weights), jcfg, True)[0]))(jp)
    g = PS.param_leaves(_np(grad))
    scale = max(float(np.abs(x).max()) for x in g)
    moved = 0
    for a, c, gj, x0 in zip(PS.param_leaves(params_to_numpy(pt.params)),
                            PS.param_leaves(_np(p1_j)), g, PS.param_leaves(_np(jp)), strict=True):
        d = np.abs(a - c)
        assert d.max() <= 2 * lr
        assert (d[np.abs(gj) > 1e-5 * scale] <= 1e-3 * lr).all()
        moved += int((np.abs(c - x0) > 0.1 * lr).sum())
    assert moved > 0
