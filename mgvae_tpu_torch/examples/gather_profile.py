"""The backward of the model's row gathers, site by site, on the card.

Every gather of ``models/dg_ae.level_statics``, ``level_scan_inputs``,
``decode_edges`` and the losses' pair gathers, at the shapes of two
batches: bs16 MIG (16 circuits of 16 inputs and 264 gates, collated
together) and the giant XMG circuit (one layered circuit, width 512 x depth
200). D = 64. A site is one index and the tables gathered by it; the
tables hold random values and the gathered rows random cotangents, so the
backward does the work of a train step's but computes nothing of the
model.

For each site it prints the index's runs (entries, distinct rows, the
duplicates a serial walk visits, the longest run) and

  * ``torch``: autograd of ``table[index]``, one gather a table as the
    model wrote them before ``ops.gather``: PyTorch's index backward (a
    sort, then ``indexing_backward_kernel``, whose warp walks each run of
    equal indices in turn);
  * ``op``: the backward of ``ops.gather.gather_rows(index, *tables)``:
    its plan (a stable sort and the row offsets) and ``csrc/gather_rows_bwd.cu``'s
    two launches, skipped where the package has no ``ops.gather``;
  * ``plain``: ``zeros(R, W).index_add_(0, index, grad)`` a table, the
    plain version's arithmetic (on the card: atomic adds);

each by CUDA events (mean of ``REPS`` calls), with the device time of the
index backward's kernels by name under ``torch.profiler``, and the bound
of the site's bytes: each cotangent row read once and each table
gradient written once, at 3.35 TB/s. The numbers go to stdout and, as
JSON, to OUT (default ``exp/gather_profile.json``).

    python -m mgvae_tpu_torch.examples.gather_profile [OUT]

Needs one CUDA card and raises without one.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..data.batching import collate
from ..data.synthetic import layered_circuit, random_circuit
from ..models import dg_ae

DIM, REPS, HBM_BYTES_PER_S = 64, 20, 3.35e12


def event_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int) -> dict:
    """Device microseconds per call of each device-side event, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us() / reps
    return dict(us)


def bs16_graphs() -> list:
    """The bs16 MIG batch's 16 circuits."""
    rng = np.random.default_rng(0)
    return [random_circuit(rng, "mig", num_inputs=16, num_gates=264, num_tt_pairs=64)
            for _ in range(16)]


def batches() -> dict:
    bs16 = collate(bs16_graphs())
    giant = collate([layered_circuit(np.random.default_rng(0), "xmg", width=512, depth=200,
                                     num_tt_pairs=512)])
    return {"bs16 MIG": ("mig", bs16), "giant XMG 512 x 200": ("xmg", giant)}


def sites(modality: str, host_batch: dict, dev) -> list:
    """(name, index, table shapes) of every gather site of a train step."""
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=DIM, s_rounds=4, t_rounds=4,
                         layernorm=True, matmul_precision="highest")
    b = dg_ae.batch_to_device(host_batch, dev)
    D, T = DIM, cfg.num_experts
    N, E = b["gate"].shape[0], b["edge_src"].shape[0]
    expert = cfg.expert_of_gate(dev)[b["gate"].long()]
    src, dst = b["edge_src"].long(), b["edge_dst"].long()
    tabs, _, _ = dg_ae.lv_views(b)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = torch.as_tensor(max(int(host_batch["n_nodes"].sum()), 2), device=dev)
    neg = (torch.rand(E, generator=gen, device=dev) * n).long()
    return [
        ("e_dst: bk, bv, wa_k", expert[dst].clamp(min=0), [(T, D)] * 3),
        ("e_node: bq, wa_q, ba", expert.clamp(min=0), [(T, D), (T, D), (T,)]),
        ("lv_edge_id: pack", tabs["lv_edge_id"].long(), [(E, D + 2)]),
        ("src: hs", src, [(N, D)]),
        ("dst: aq_n", dst, [(N,)]),
        ("positive src: s", src, [(N, D)]),
        ("positive dst: t", dst, [(N, D)]),
        ("negative src: s (random)", neg, [(N, D)]),
        ("tt_pair_a: hf (random)", b["tt_pair_a"].long(), [(N, D)]),
        ("tt_pair_b: hf (random)", b["tt_pair_b"].long(), [(N, D)]),
    ]


def runs(index: torch.Tensor) -> dict:
    counts = torch.bincount(index.flatten()).cpu().numpy()
    return {"entries": int(index.numel()), "rows_named": int((counts > 0).sum()),
            "duplicates": int(index.numel() - (counts > 0).sum()),
            "longest_run": int(counts.max(initial=0))}


def site_bytes(index: torch.Tensor, shapes: list) -> int:
    width = sum(int(np.prod(s[1:])) for s in shapes)
    return 4 * (index.numel() * width + sum(int(np.prod(s)) for s in shapes))


def time_site(index: torch.Tensor, shapes: list, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(7)
    tables = [torch.randn(s, generator=gen, device=dev).requires_grad_() for s in shapes]
    cot = [torch.randn(index.shape + s[1:], generator=gen, device=dev) for s in shapes]
    calls = {}
    outs = [t[index] for t in tables]
    calls["torch"] = lambda: torch.autograd.grad(outs, tables, cot, retain_graph=True)
    flat = index.flatten()
    calls["plain"] = lambda: [g.new_zeros(s if len(s) > 1 else (s[0], 1)).index_add_(
        0, flat, g.reshape(flat.shape[0], -1)) for g, s in zip(cot, shapes)]
    try:
        from ..ops import gather
    except ImportError:
        gather = None
    if gather is not None:
        op_outs = gather.gather_rows(index, *tables)
        calls["op"] = lambda: torch.autograd.grad(op_outs, tables, cot, retain_graph=True)
    out = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        us = device_us(fn, REPS)
        out[name] = {
            "ms": event_ms(fn, REPS),
            "index_bwd_us": sum(v for k, v in us.items() if "indexing_backward" in k),
            "device_us": sum(us.values()),
            "top": sorted(((round(v, 2), k[:90]) for k, v in us.items()), reverse=True)[:4],
        }
    if gather is not None:
        got = torch.autograd.grad(op_outs, tables, cot)
        want = [g.new_zeros(s if len(s) > 1 else (s[0], 1)).index_add_(
            0, flat.cpu(), g.reshape(flat.shape[0], -1)).reshape(s)
            for g, s in zip((c.cpu() for c in cot), shapes)]
        out["op"]["max_abs_err_vs_cpu"] = max(float((a.cpu() - w).abs().max())
                                              for a, w in zip(got, want))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("gather_profile needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    report = {"card": smi, "batches": {}}
    for tag, (modality, host_batch) in batches().items():
        rows, total = [], collections.Counter()
        for name, index, shapes in sites(modality, host_batch, dev):
            row = {"site": name, "index_shape": list(index.shape),
                   "tables": [list(s) for s in shapes], **runs(index),
                   "bound_ms": site_bytes(index, shapes) / HBM_BYTES_PER_S * 1e3}
            row.update(time_site(index, shapes, dev))
            rows.append(row)
            for k in ("torch", "op", "plain"):
                if k in row:
                    total[f"{k}_ms"] += row[k]["ms"]
                    total[f"{k}_index_bwd_us"] += row[k]["index_bwd_us"]
            total["bound_ms"] += row["bound_ms"]
            total["duplicates"] += row["duplicates"]
            op = (f"; op {row['op']['ms']:.4f} ms (max|d| vs CPU "
                  f"{row['op']['max_abs_err_vs_cpu']:.2e})" if "op" in row else "")
            print(f"[{tag}] {name}: index {tuple(index.shape)}, {row['duplicates']} duplicates, "
                  f"longest run {row['longest_run']}; torch {row['torch']['ms']:.4f} ms "
                  f"(indexing_backward {row['torch']['index_bwd_us']:.1f} us){op}; plain "
                  f"{row['plain']['ms']:.4f} ms; bound {row['bound_ms']:.5f} ms", flush=True)
            for k in ("torch", "op"):
                if k in row:
                    print(f"[{tag}]     {k} top kernels (us): {row[k]['top']}", flush=True)
        print(f"[{tag}] all sites: {json.dumps(dict(total))}", flush=True)
        report["batches"][tag] = {"sites": rows, "total": dict(total)}
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "exp/gather_profile.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
