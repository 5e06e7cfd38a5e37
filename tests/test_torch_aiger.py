"""The port's AIGER front-end (``mgvae_tpu_torch/data/aiger.py``) against
the JAX package's: ``aig_to_xdata`` and ``AigParser`` on ASCII and binary
AIGER, with inverted fanins and inverted outputs (the NOT nodes they
materialise, shared per variable), as tests/test_parsers.py:72-104 builds
them; and an AIGER circuit through ``Model(modality="aig")``. The graphs
must be equal array for array."""
import numpy as np
import pytest
import torch

from mgvae_tpu.data import aiger as jaiger
import mgvae_tpu_torch
from mgvae_tpu_torch.data import aiger as paiger

torch.set_num_threads(1)
FIELDS = ("gate", "edge_index", "forward_level", "backward_level", "prob", "tt_pair_index",
          "tt_dis")


def _varint(x: int) -> bytes:
    out = b""
    while x >= 0x80:
        out += bytes([(x & 0x7F) | 0x80])
        x >>= 7
    return out + bytes([x])


def _circuit(rng, num_inputs: int, num_ands: int, num_outputs: int):
    """A random combinational AIG: (outputs, ands) literals in AIGER's
    order, each AND's fanins earlier literals, some inverted."""
    ands = []
    for k in range(num_ands):
        lhs = 2 * (num_inputs + k + 1)
        r0, r1 = sorted(rng.choice(np.arange(2, lhs), size=2, replace=False), reverse=True)
        ands.append((lhs, int(r0), int(r1)))
    top = 2 * (num_inputs + num_ands)
    outputs = [int(x) for x in rng.integers(2, top + 2, size=num_outputs)]
    return outputs, ands


def _write(tmp_path, name, num_inputs, outputs, ands):
    """The circuit as .aag (ASCII) and .aig (binary, delta-coded ANDs)."""
    m, a = num_inputs + len(ands), len(ands)
    head = f"{m} {num_inputs} 0 {len(outputs)} {a}\n"
    aag = "aag " + head + "".join(f"{2 * (i + 1)}\n" for i in range(num_inputs))
    aag += "".join(f"{o}\n" for o in outputs) + "".join(f"{l} {r0} {r1}\n" for l, r0, r1 in ands)
    blob = ("aig " + head + "".join(f"{o}\n" for o in outputs)).encode()
    blob += b"".join(_varint(l - r0) + _varint(r0 - r1) for l, r0, r1 in ands)
    p_aag, p_aig = tmp_path / f"{name}.aag", tmp_path / f"{name}.aig"
    p_aag.write_text(aag)
    p_aig.write_bytes(blob)
    return str(p_aag), str(p_aig)


def test_half_adder_as_the_jax_parser_test_builds_it(tmp_path):
    """tests/test_parsers.py's half adder: 2 PIs, 3 ANDs, 4 NOT nodes; ASCII
    and binary agree with each other and with the JAX package."""
    aag, aig = _write(tmp_path, "t", 2, [10], [(6, 4, 2), (8, 5, 3), (10, 9, 7)])
    xa, ea = paiger.aig_to_xdata(aag)
    xb, eb = paiger.aig_to_xdata(aig)
    assert xa == xb and ea == eb
    assert (xa, ea) == jaiger.aig_to_xdata(aag)
    g = paiger.AigParser().read_aiger(aig)
    assert g.num_nodes == 9 and (g.gate == 2).sum() == 4 and (g.gate == 1).sum() == 3


@pytest.mark.parametrize("seed,inputs,ands,outputs", [(0, 4, 12, 3), (1, 8, 60, 6),
                                                      (2, 3, 200, 1), (3, 16, 150, 9)])
def test_aig_parser_matches_jax(seed, inputs, ands, outputs, tmp_path):
    """Random AIGs, inverted outputs included: the port's graphs from both
    encodings equal the JAX package's field for field."""
    rng = np.random.default_rng(seed)
    outs, and_lits = _circuit(rng, inputs, ands, outputs)
    outs[0] |= 1                                   # at least one inverted output
    aag, aig = _write(tmp_path, f"c{seed}", inputs, outs, and_lits)
    for path in (aag, aig):
        got = mgvae_tpu_torch.AigParser().read_aiger(path)
        want = jaiger.AigParser().read_aiger(path)
        assert got.name == want.name == f"c{seed}"
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
            assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert paiger.aig_to_xdata(aag) == paiger.aig_to_xdata(aig)


@pytest.mark.parametrize("content,match", [
    (b"aag 3 1 1 1 1\n2\n4 6\n6\n6 2 4\n", "latches"),
    (b"aig 3 1 1 1 1\n4\n6\n", "latches"),
    (b"aog 1 1 0 1 0\n2\n2\n", "not an ASCII AIGER file"),
    (b"\n\n", "not an ASCII AIGER file"),
], ids=["ascii_latch", "binary_latch", "bad_header", "empty"])
def test_malformed_aiger_is_refused(content, match, tmp_path):
    """Sequential circuits and files that are not AIGER raise ValueError
    (the JAX package asserts on a bad header; the port checks)."""
    path = tmp_path / "x.aig"
    path.write_bytes(content)
    with pytest.raises(ValueError, match=match):
        paiger.AigParser().read_aiger(str(path))


def test_aiger_circuit_encodes_through_model(tmp_path):
    """The feature-extraction path: an AIGER file through ``AigParser`` into
    ``Model(modality="aig")`` on the CPU; finite embeddings of the parsed
    graph's size, and the same as the graph collated by hand."""
    rng = np.random.default_rng(5)
    outs, and_lits = _circuit(rng, 6, 40, 4)
    _, aig = _write(tmp_path, "m", 6, outs, and_lits)
    g = mgvae_tpu_torch.AigParser().read_aiger(aig)
    model = mgvae_tpu_torch.Model(modality="aig", dim_hidden=16, s_rounds=1, t_rounds=1,
                                  device="cpu")
    hs, hf = model(g)
    assert hs.shape == hf.shape == (g.num_nodes, 16)
    assert torch.isfinite(hs).all() and torch.isfinite(hf).all()
    (hs2, hf2), = model.encode_many([g])
    np.testing.assert_array_equal(hs.numpy(), hs2)
    np.testing.assert_array_equal(hf.numpy(), hf2)
