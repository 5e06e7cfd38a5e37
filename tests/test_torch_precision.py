"""The port's matmul precision scope (``mgvae_tpu_torch.ops.precision``):
the names' mapping onto torch's TF32 flags, the restore on exit and on an
exception, unknown names; every autograd Function's backward running in its
forward's mode also when ``backward()`` is called outside the forward's
scope; ``train_step`` / ``eval_step`` and ``Model`` running under
``cfg.matmul_precision`` and restoring the flags after.

Kernels the CPU cannot run are replaced by fakes that record the mode they
see (the Functions' own code is what is under test)."""
import numpy as np
import pytest
import torch

import mgvae_tpu_torch
from mgvae_tpu_torch.data.batching import collate
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel, struct_kernel
from mgvae_tpu_torch.ops.precision import current_precision, matmul_precision
from mgvae_tpu_torch.train import step as PS

torch.set_num_threads(1)


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def ambient():
    """Start every test from known flags (TF32 off for matmuls, on for
    convolutions: torch's defaults) and put the caller's back after."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    yield (False, True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("name, tf32", [("default", True), ("high", True), ("highest", False),
                                        ("float32", False)])
def test_scope_sets_both_flags_and_restores_them(name, tf32, ambient):
    with matmul_precision(name):
        assert _flags() == (tf32, tf32)
        assert current_precision() == ("default" if tf32 else "highest")
        with matmul_precision("highest" if tf32 else "default"):   # nested
            assert _flags() == (not tf32, not tf32)
        assert _flags() == (tf32, tf32)
    assert _flags() == ambient


def test_scope_restores_on_exception_and_refuses_unknown_names(ambient):
    with pytest.raises(RuntimeError, match="inside"):
        with matmul_precision("default"):
            raise RuntimeError("inside")
    assert _flags() == ambient
    for bad in ("medium", "tf32", "", "HIGHEST"):
        with pytest.raises(ValueError, match="matmul_precision"):
            with matmul_precision(bad):
                pass
    assert _flags() == ambient
    with pytest.raises(ValueError, match="matmul_precision"):
        P.check_supported(P.DGConfig(matmul_precision="bf16x3"))


# ---- the autograd Functions --------------------------------------------------

def _level_args(T=4, D=8, L=3, ep=6, np_=4, N=24, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(*s, generator=g).to(dtype)
    i = lambda hi, *s: torch.randint(0, hi, s, generator=g, dtype=torch.int32)
    pack = f(L, ep, D + 2)
    pack[..., D + 1] = i(T, L, ep).to(dtype)
    return (pack, i(N // 2, L, ep), i(np_, L, ep), torch.ones((L, ep), dtype=torch.int32),
            i(N, L, np_), torch.ones((L, np_), dtype=torch.int32), i(T, L, np_),
            f(D, 2 * T * D), f(D, 3 * T * D), f(T, 3 * D), f(T, 3 * D), f(T, D))


def _grads_like(args, idx):
    return [torch.zeros_like(args[i]) for i in idx]


def _fake_level(monkeypatch, seen):
    """The CUDA wrappers of the level Functions, and the plain backwards
    they take on CPU tensors, replaced by CPU fakes; the backward ones
    record ``current_precision()``."""
    def fwd(args, *a, residuals=True, **k):
        pack, lv_nodes = args[0], args[4]
        L, ep, pw = pack.shape
        D = pw - 2
        hf = torch.zeros((64, D))
        return hf, torch.zeros((L, ep, 3 * D + 1)), torch.zeros((L, lv_nodes.shape[1], 4 * D))

    def bwd(ghf, res_e, res_n, args, *a, **k):
        seen.append(current_precision())
        return (torch.zeros_like(args[0]), *_grads_like(args, (7, 8, 9, 10, 11)))

    monkeypatch.setattr(level_kernel, "_forward_cuda", fwd)
    monkeypatch.setattr(level_kernel, "_backward_cuda", bwd)
    # _LevelScan takes its plain versions on CPU tensors
    monkeypatch.setattr(level_kernel, "level_scan_bwd_reference",
                        lambda ghf, res_e, res_n, *args: bwd(ghf, res_e, res_n,
                                                             (*args[:9], args[9], *args[9:11])))
    monkeypatch.setattr(level_kernel, "_giant_forward_cuda", lambda args, *a, **k: fwd(args)[0])
    monkeypatch.setattr(level_kernel, "_giant_backward_cuda",
                        lambda ghf, hf, args, *a, **k: bwd(ghf, None, None, args))
    monkeypatch.setattr(level_kernel, "_step_route_forward_cuda",
                        lambda args, *a, **k: fwd(args))
    monkeypatch.setattr(level_kernel, "_step_route_backward_cuda",
                        lambda ghf, res_e, res_n, args, *a, **k: bwd(ghf, res_e, res_n, args))

    def step_fwd(args, residuals=True, **k):
        hf, pack = args[0], args[1]
        ep, D = pack.shape[0], pack.shape[1] - 2
        return torch.zeros((4, D)), torch.zeros((ep, 3 * D + 1)), torch.zeros((4, 4 * D))

    def step_bwd(g, res_e, res_n, rest, num_nodes, **k):
        seen.append(current_precision())
        D = rest[0].shape[1] - 2
        return (torch.zeros_like(rest[0]), *_grads_like(rest, (6, 7, 8, 9, 10)),
                torch.zeros((num_nodes, D)))

    monkeypatch.setattr(level_kernel, "_step_forward_cuda", step_fwd)
    monkeypatch.setattr(level_kernel, "_step_backward_cuda", step_bwd)
    # the giant and step Functions take their plain versions on CPU tensors
    # too (bf16 training on the CPU): their backwards record it the same way
    monkeypatch.setattr(level_kernel, "level_scan_giant_bwd_reference",
                        lambda ghf, hf, *args, **k: bwd(ghf, None, None, args))
    monkeypatch.setattr(level_kernel, "level_scan_step_bwd_reference",
                        lambda ghf, res_e, res_n, *a, **k: bwd(ghf, res_e, res_n,
                                                               (*a[:9], a[9], *a[9:11])))
    monkeypatch.setattr(level_kernel, "level_step_bwd_reference",
                        lambda g, res_e, res_n, *a: step_bwd(g, res_e, res_n,
                                                             (*a[:8], a[8], *a[8:10]), a[10]))


def _apply(function, args):
    """Forward of one level Function on CPU tensors with grad, under
    "highest"; returns a scalar to differentiate."""
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    with matmul_precision("highest"):
        if function == "scan":
            out = level_kernel._LevelScan.apply(64, 3, (None, None), *leaves)
        elif function == "giant":
            out = level_kernel._LevelScanGiant.apply(64, 3, (None, None), *leaves)
        elif function == "scan_step":
            out = level_kernel._LevelScanStep.apply((3,), 64, (None, None), *leaves)
        else:
            hf = torch.zeros((24, args[0].shape[2] - 2), requires_grad=True)
            out = level_kernel._LevelStep.apply((None, None), hf, leaves[0][0],
                                                *(t[0] for t in leaves[1:4]), leaves[5][0],
                                                leaves[6][0], *leaves[7:])
    return out.sum()


@pytest.mark.parametrize("function", ["scan", "giant", "step", "scan_step", "struct"])
def test_backward_runs_in_the_forward_mode_outside_its_scope(function, monkeypatch, ambient):
    """Each Function saves its forward's mode and re-enters it in its
    backward, called here outside the forward's scope and inside another;
    the flags are back to the caller's after."""
    seen = []
    if function == "struct":
        real = struct_kernel.struct_towers_bwd_reference

        def bwd(*a, **k):
            seen.append(current_precision())
            return real(*a, **k)

        monkeypatch.setattr(struct_kernel, "struct_towers_bwd_reference", bwd)
        rng = np.random.default_rng(0)
        hb = collate([random_circuit(rng, "mig", num_inputs=4, num_gates=12)])
        cfg = P.DGConfig(dim_hidden=8, s_rounds=1, t_rounds=1, compute_dtype="bfloat16")
        params, _ = P.init_params(cfg, device="cpu")
        b = P.batch_to_device(hb, "cpu")
        x = P.struct_input(b["gate"], cfg).float()
        floats = [f.to(torch.bfloat16).detach().requires_grad_(True)
                  for f in struct_kernel.struct_inputs(params["struct"], x, b, False)]
        with matmul_precision("highest"):
            loss = struct_kernel.struct_core(*floats, struct_kernel.struct_tables(b), 1,
                                             False).float().sum()
    else:
        _fake_level(monkeypatch, seen)
        loss = _apply(function, _level_args())
    assert _flags() == ambient
    with matmul_precision("default"):
        loss.backward()
    assert seen == ["highest"]
    assert _flags() == ambient
    if function == "scan":   # the plain versions on CPU tensors (bf16) save it too
        seen.clear()
        monkeypatch.undo()
        real = level_kernel.level_scan_bwd_reference

        def bwd(*a, **k):
            seen.append(current_precision())
            return real(*a, **k)

        monkeypatch.setattr(level_kernel, "level_scan_bwd_reference", bwd)
        args = [a.clone().requires_grad_(a.is_floating_point())
                for a in _level_args(dtype=torch.bfloat16)]
        with matmul_precision("default"):
            hf = level_kernel.level_scan(*args, num_nodes=24, num_levels=3)
        with matmul_precision("highest"):
            hf.float().sum().backward()
        assert seen == ["default"]


# ---- the train step and Model ---------------------------------------------------

@pytest.mark.parametrize("precision", ["default", "highest"])
def test_train_and_eval_step_run_in_the_config_mode(precision, monkeypatch, ambient):
    seen = {}
    real = P.level_recurrence

    def spy(*a, **k):
        seen["forward"] = current_precision()
        return real(*a, **k)

    monkeypatch.setattr(P, "level_recurrence", spy)
    cfg = P.DGConfig(modality="aig", dim_hidden=8, s_rounds=1, t_rounds=1,
                     matmul_precision=precision)
    params, state = P.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    hb = collate([random_circuit(rng, "aig", num_inputs=4, num_gates=16) for _ in range(2)])
    train_step, eval_step = PS.make_train_step(cfg, PS.make_optimizer(params, 1e-3))
    gen = torch.Generator().manual_seed(0)
    leaf = PS.param_leaves(params)[0]
    hook = leaf.register_hook(lambda g: seen.__setitem__("backward", current_precision()))
    state, m = train_step(params, state, hb, gen, [1.0, 1.0, 1.0, 0.0])
    hook.remove()
    assert np.isfinite(float(m["loss"]))
    assert seen == {"forward": precision, "backward": precision}
    assert _flags() == ambient
    seen.clear()
    eval_step(params, state, hb, gen, [1.0, 1.0, 1.0, 0.0])
    assert seen == {"forward": precision}
    assert _flags() == ambient


def test_model_runs_highest_and_restores_the_flags(monkeypatch, ambient):
    """``Model`` is the parity surface: "highest" in every call, whatever the
    caller's flags, and the caller's flags after."""
    seen = []
    real = P.level_recurrence
    monkeypatch.setattr(P, "level_recurrence",
                        lambda *a, **k: seen.append(current_precision()) or real(*a, **k))
    model = mgvae_tpu_torch.Model(modality="mig", dim_hidden=8, s_rounds=1, t_rounds=1,
                                  device="cpu")
    assert model.cfg.matmul_precision == "highest"
    g = random_circuit(np.random.default_rng(3), "mig", num_inputs=4, num_gates=10)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    hs, hf = model(g)
    model.encode_many([g, g], batch_size=2)
    model.pred_prob(hf)
    model.recon_loss(hs, g.edge_index)
    assert seen == ["highest", "highest"]
    assert _flags() == (True, True)
