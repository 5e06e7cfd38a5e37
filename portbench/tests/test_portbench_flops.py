"""The copied roofline arithmetic against PERF.md's Bound column (as the
smoke script printed it, to its digits), and the model's operation count
independent of the layout a step takes."""
import numpy as np
import pytest

from portbench import flops

D = 64
# bs16 MIG (PERF.md section 4): N = 5120 padded rows, 45 real levels of Ep
# = 320 and Np = 160, 16 x 528 edges and 16 x 264 gates, the struct tables
# 40 blocks of 320
BS16 = dict(rows=5120, levels=45, ep=320, np_=160, e=16 * 528, u=16 * 264, tables=40 * 320)


def close(x, printed: float) -> bool:
    """x rounds to the printed value (4 decimals of a ms)."""
    return abs(x - printed) <= 0.5e-4


def test_rows_1_2_7_8_at_bs16():
    s = BS16
    slots = (s["levels"] * s["ep"], s["levels"] * s["np_"])
    r1 = flops.level_bound(*slots, s["e"], s["u"], s["rows"], D, 4, residuals=True)
    assert close(r1["bytes_ms"], 0.0072) and close(r1["operations_ms"], 0.0037)
    r2 = flops.level_bound(*slots, s["e"], s["u"], s["rows"], D, 4, True, backward=True)
    assert close(r2["bound_ms"], 0.0073) and r2["bound_by"] == "bytes"
    r7 = flops.struct_bound(s["rows"], s["e"], s["tables"], D, 4, residuals=False)
    assert close(r7["operations_ms"], 0.0602) and close(r7["bytes_ms"], 0.0057)
    assert close(flops.struct_bound(s["rows"], s["e"], s["tables"], D, 4, True)["bytes_ms"],
                 0.0495)
    r8 = flops.struct_bound(s["rows"], s["e"], s["tables"], D, 4, True, backward=True)
    assert close(r8["bound_ms"], 0.1159) and r8["bound_by"] == "operations"


def test_rows_3_4_at_the_giant_shape():
    """The smoke script's giant batch: layered_circuit(default_rng(0), "mig",
    512, 200, num_tt_pairs=512), its real edges and gates, L = 200 of Ep =
    1280 and Np = 512, N = 114,688 rows."""
    from mgvae_tpu_torch.data.batching import collate
    from mgvae_tpu_torch.data.synthetic import layered_circuit

    g = layered_circuit(np.random.default_rng(0), "mig", width=512, depth=200,
                        num_tt_pairs=512)
    e, u = g.num_edges, g.num_nodes - 512
    b = collate([g])
    tables = b["fa_src"].shape[0] * max(b["fa_src"].shape[1], b["ra_src"].shape[1])
    slots = (200 * 1280, 200 * 512)
    r3 = flops.level_bound(*slots, e, u, 114688, D, 4, residuals=False)
    assert close(r3["bound_ms"], 0.0901) and r3["bound_by"] == "operations"
    r4 = flops.giant_bwd_bound(*slots, e, u, 114688, D, 4)
    assert close(r4["bound_ms"], 0.2656) and r4["bound_by"] == "operations"
    r7 = flops.struct_bound(114688, e, tables, D, 4, residuals=False)
    assert close(r7["operations_ms"], 1.3493) and close(r7["bytes_ms"], 0.1242)


@pytest.mark.parametrize("layout", ["plain", "chunked", "split"])
def test_step_flops_do_not_depend_on_the_route(layout):
    """The count reads a step's real nodes, gates, edges and pairs; the
    padding and the chunks of each layout change none of them."""
    from mgvae_tpu_torch.data import batching
    from portbench import circuits
    from portbench.cell import program_graphs

    cfg = {"dim_hidden": 64, "dim_feature": 6, "dim_mlp": 32, "s_rounds": 4, "t_rounds": 4}
    cs = circuits.random_circuits(np.random.default_rng(3), "mig", 16, 16, 264, 64)
    want = sum(flops.train_flops(cfg, c.num_nodes, int((c.gate != 0).sum()), c.num_edges,
                                 c.tt_dis.shape[0]) for c in cs)
    graphs = program_graphs(cs)
    b = {"plain": lambda: batching.collate(graphs),
         "chunked": lambda: batching.collate_chunked(graphs, 2),
         "split": lambda: batching.collate_split(graphs, 2)}[layout]()
    valid = np.asarray(b["node_valid"]).reshape(-1)
    gates = valid & (np.asarray(b["gate"]).reshape(-1) != 0)
    got = flops.train_flops(cfg, int(valid.sum()), int(gates.sum()),
                            int(np.asarray(b["edge_valid"]).sum()),
                            int(np.asarray(b["tt_valid"]).sum()))
    assert got == pytest.approx(want, rel=1e-12)


def test_peaks_are_the_h100_sheets():
    assert flops.PEAK_FLOP_S == 67e12 and flops.PEAK_BYTES_S == 3.35e12
