"""The port's feature-extraction examples (``mgvae_tpu_torch/examples``:
``feature_extract``, ``feature_extract_bench``, ``extract_all_modalities``)
run in-process with ``--device cpu``, each against what the same model
gives when called directly."""
import numpy as np
import pytest
import torch

import mgvae_tpu_torch
from mgvae_tpu_torch.examples import extract_all_modalities, feature_extract, feature_extract_bench

torch.set_num_threads(1)

AAG = "aag 5 2 0 1 3\n2\n4\n11\n6 4 2\n8 5 3\n10 9 7\n"
BENCH = """INPUT(a)
INPUT(b)
INPUT(c)
OUTPUT(f)
d = AND(a, b)
e = XOR(b, c)
g = NOT(d)
f = AND(g, e)
"""


def test_feature_extract_encodes_an_aiger_file(tmp_path, capsys):
    path = tmp_path / "t.aag"
    path.write_text(AAG)
    hs, hf = feature_extract.main([str(path), "--device", "cpu"])
    g = mgvae_tpu_torch.AigParser().read_aiger(str(path))
    assert hs.shape == hf.shape == (g.num_nodes, 64)
    want = mgvae_tpu_torch.Model(modality="aig", device="cpu")(g)
    assert torch.equal(hs, want[0]) and torch.equal(hf, want[1])
    assert f"torch.Size([{g.num_nodes}, 64])" in capsys.readouterr().out


def test_feature_extract_bench_times_and_loads_weights(tmp_path, capsys):
    path = tmp_path / "t.bench"
    path.write_text(BENCH)
    hs, hf, seconds = feature_extract_bench.main([str(path), "--device", "cpu"])
    assert hs.shape == hf.shape == (7, 64) and seconds > 0
    assert "Time: " in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="nothing.pth"):
        feature_extract_bench.main([str(path), "--device", "cpu", "--pretrained",
                                    str(tmp_path / "nothing.pth")])
    weights = tmp_path / "w.pth"
    mgvae_tpu_torch.Model(seed=4, device="cpu").save(str(weights))
    hs2, _, _ = feature_extract_bench.main([str(path), "--device", "cpu", "--pretrained",
                                            str(weights)])
    graph = mgvae_tpu_torch.BenchParser().read_bench(str(path))
    assert torch.equal(hs2, mgvae_tpu_torch.Model(seed=4, device="cpu")(graph)[0])


def test_extract_all_modalities(capsys):
    out = extract_all_modalities.main(["--device", "cpu"])
    assert list(out) == ["aig", "mig", "xmg", "xag"]
    for hs, hf in out.values():
        assert hs.shape == hf.shape and hs.shape[1] == 64
        assert np.isfinite(hs.numpy()).all() and float(hf.abs().mean()) > 0
    assert capsys.readouterr().out.count("|hf| mean") == 4
