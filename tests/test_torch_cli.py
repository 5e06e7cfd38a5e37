"""The port's 3-stage CLI (``python -m mgvae_tpu_torch.train``,
``mgvae_tpu_torch/cli.py``) on the CPU: its parser against the root
``config.py``, the recipe of the JAX package's ``train.py`` in-process
(files, epoch lines, ``--resume`` bit for bit), what it refuses before any
data is built, and the package's independence from jax."""
import os
import re
import subprocess
import sys

import pytest
import torch

import config as root_config
from mgvae_tpu_torch import cli
from mgvae_tpu_torch.config import get_parse_args
from mgvae_tpu_torch.train import step as pstep

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = ["--exp_id", "v", "--model", "DG_AE", "--type", "mig", "--batch_size", "4",
          "--layernorm", "--dim_hidden", "32", "--s_rounds", "1", "--t_rounds", "1",
          "--stage_epochs", "1,1,1", "--synthetic_circuits", "24"]
# the reference epoch line (mgvae_tpu/train/trainer.py:910-915), no KL field
EPOCH_LINE = re.compile(r"^(train|val)\| Epoch: 0/1 \|Recon: \d+\.\d{4} \|ACC: \d+\.\d{2} "
                        r"\|Prob: \d+\.\d{4} \|Func: \d+\.\d{4}\|Net: \d+\.\d{2}s$")


@pytest.mark.parametrize("argv", [
    ["--type", "mig"],
    RECIPE,
    ["--type", "aig", "--model", "AE", "--distributed", "--resume", "--split", "2",
     "--no_fixed_dims", "--matmul_precision", "highest", "--lr", "0.5", "--local-rank", "3"],
    ["--type", "xmg", "--data_dir", "/d", "--kl_weight", "0.1", "--steps_per_call", "1",
     "--neg_collision_mask", "--no_input_quirk", "--num_devices", "2", "--log_every", "5",
     "--seed", "7", "--num_epochs", "3", "--dim_feature", "4"],
], ids=["defaults", "recipe", "flags", "more_flags"])
def test_parser_matches_root_config(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    assert vars(get_parse_args(argv)) == vars(root_config.get_parse_args())


@pytest.mark.parametrize("argv, want", [([], "default"), (["--matmul_precision", "high"], "high"),
                                         (["--matmul_precision", "highest"], "highest")])
def test_matmul_precision_goes_into_the_config(argv, want):
    """``--matmul_precision`` reaches ``DGConfig`` as in ``train.py:66``;
    the parser's default is the JAX package's, TF32 on the card."""
    cfg = cli.model_config(get_parse_args(["--type", "mig"] + argv))
    assert cfg.matmul_precision == want and cfg.compute_dtype == "float32"


def test_parser_rejects_unknown_type():
    with pytest.raises(SystemExit):
        get_parse_args(["--type", "foo"])


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_three_stage_recipe_and_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("MGVAE_PLATFORM", "cpu")
    save = ["--save_dir", str(tmp_path)]
    trainer = cli.main(RECIPE + save)
    run = tmp_path / "v"
    for name in ("stage_1.pth", "stage_2.pth", "stage_3.pth", "model_0.pth", "model_last.pth"):
        assert (run / name).is_file(), name
    assert trainer.model_epoch == 3 and trainer.rc_prob_func_weight == [1.0, 4.0, 4.0]
    (log,) = run.glob("log-*.txt")
    lines = [ln for ln in log.read_text().splitlines() if "| Epoch:" in ln]
    assert len(lines) == 6 and all(EPOCH_LINE.match(ln) for ln in lines), lines
    assert [ln.split("|")[0] for ln in lines] == ["train", "val"] * 3

    # --resume with no epochs: stage_1.pth then holds exactly what was restored
    last = _payload(run / "model_last.pth")
    resumed = cli.main(RECIPE[:-4] + ["--stage_epochs", "0,0,0", "--synthetic_circuits", "24",
                                      "--resume"] + save)
    again = _payload(run / "stage_1.pth")
    assert resumed.model_epoch == last["epoch"] == again["epoch"] == 0
    assert again["lr"] == last["lr"]
    for key in ("params", "state", "optimizer"):
        a, b = _tensors(last[key]), _tensors(again[key])
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), key
    assert last["optimizer"]["state"][0]["step"].item() == 5      # 21 graphs, bs4: 5 steps
    leaves = pstep.param_leaves(resumed.params)
    assert all(torch.equal(x, y) for x, y in zip(leaves, _tensors(last["params"])))


@pytest.mark.parametrize("argv, env, match", [
    (["--type", "mig", "--model", "DG_AE", "--distributed", "--num_devices", "2"], {},
     "ROADMAP 1.7"),
    (["--type", "mig", "--model", "DG_AE"], {"WORLD_SIZE": "2"}, "ROADMAP 1.7"),
], ids=["num_devices", "world_size"])
def test_unported_modes_raise_before_any_data(argv, env, match, monkeypatch, tmp_path):
    monkeypatch.setenv("MGVAE_PLATFORM", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def no_data(args):
        raise AssertionError("data built before the check")

    monkeypatch.setattr(cli, "load_dataset", no_data)
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv + ["--save_dir", str(tmp_path)])


# the epoch line with DG_VAE's KL field
KL_LINE = re.compile(r"^(train|val)\| Epoch: 0/1 \|Recon: \d+\.\d{4} \|ACC: \d+\.\d{2} "
                     r"\|Prob: \d+\.\d{4} \|Func: \d+\.\d{4} \|KL: -?\d+\.\d{4}"
                     r"\|Net: \d+\.\d{2}s$")
# the recipe at the parser's own --model (DG_VAE) with a val split of a batch
DEFAULT_MODEL = [a for a in RECIPE if a not in ("--model", "DG_AE")][:-1] + ["44"]


@pytest.mark.parametrize("kl_weight", ["0.1", "0"])
def test_default_model_dg_vae_runs_the_three_stages(kl_weight, tmp_path, monkeypatch):
    """``--model`` left at the parser's default, DG_VAE: the variational
    head and its KL term; the epoch lines carry the KL field whenever a
    nonzero KL was metered, which DG_VAE computes whatever its weight."""
    monkeypatch.setenv("MGVAE_PLATFORM", "cpu")
    assert "--model" not in DEFAULT_MODEL
    trainer = cli.main(DEFAULT_MODEL + ["--kl_weight", kl_weight, "--save_dir", str(tmp_path)])
    assert trainer.model_cfg.variational and trainer.model_cfg.struct_encoder == "multigcn"
    assert trainer.weights == [1.0, 4.0, 4.0, float(kl_weight)]
    assert {"fc_s_mu", "fc_s_logstd", "fc_t_mu", "fc_t_logstd"} <= set(trainer.params)
    run = tmp_path / "v"
    for name in ("stage_1.pth", "stage_2.pth", "stage_3.pth", "model_0.pth", "model_last.pth"):
        assert (run / name).is_file(), name
    assert "fc_s_logstd" in _payload(run / "stage_3.pth")["params"]
    (log,) = run.glob("log-*.txt")
    lines = [ln for ln in log.read_text().splitlines() if "| Epoch:" in ln]
    assert len(lines) == 6 and all(KL_LINE.match(ln) for ln in lines), lines


def test_model_ae_runs_the_three_stages(tmp_path, monkeypatch):
    """``--model AE``: the gcn struct encoder, no KL field."""
    monkeypatch.setenv("MGVAE_PLATFORM", "cpu")
    argv = [a if a != "DG_AE" else "AE" for a in RECIPE]
    trainer = cli.main(argv + ["--kl_weight", "0.1", "--save_dir", str(tmp_path)])
    assert trainer.model_cfg.struct_encoder == "gcn" and not trainer.model_cfg.variational
    assert set(trainer.params["struct"]["source"]) == {"conv1", "conv2"}
    run = tmp_path / "v"
    for name in ("stage_1.pth", "stage_2.pth", "stage_3.pth", "model_0.pth", "model_last.pth"):
        assert (run / name).is_file(), name
    (log,) = run.glob("log-*.txt")
    lines = [ln for ln in log.read_text().splitlines() if "| Epoch:" in ln]
    assert len(lines) == 6 and all(EPOCH_LINE.match(ln) for ln in lines), lines


def test_no_card_and_no_cpu_request_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    monkeypatch.delenv("MGVAE_PLATFORM", raising=False)
    monkeypatch.setattr(cli, "load_dataset", lambda args: pytest.fail("data built"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(RECIPE + ["--save_dir", str(tmp_path)])


def test_port_imports_no_jax_and_no_root_module():
    code = ("import sys; import mgvae_tpu_torch, mgvae_tpu_torch.cli, "
            "mgvae_tpu_torch.train.__main__; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'mgvae_tpu', 'config', 'train')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
