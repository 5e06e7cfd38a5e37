"""The level-recurrence kernels' share of their roofline (rows 1-4 of
PERF.md's table: the fused scan and its backward, the giant route's
forward and its recompute-from-hf backward, and the list kernel): the least
time the traced window's steps need of them (``portbench.flops``, from
each step's real nodes, edges and gates) over their measured device time,
by kernel name, in percent."""
from portbench import flops

NAMES = ("level_lists_kernel", "level_scan_kernel", "level_scan_bwd_kernel",
         "level_recompute_kernel", "expert_gemm_kernel", "weight_reduce_kernel",
         "level_fwd_kernel", "level_bwd_slot_kernel", "level_bwd_source_kernel")


def read(run):
    spent = sum(s for n, s in run["kernels"].items() if any(k in n for k in NAMES))
    if spent <= 0 or not run["shapes"]:
        return None
    giant = any("level_recompute_kernel" in n for n in run["kernels"])
    least = sum(flops.step_bounds_ms(run["cfg"], phase, giant, n, e, u)["level"]
                for phase, n, e, u, _ in run["shapes"])
    return least / (spent * 1e3) * 100.0
