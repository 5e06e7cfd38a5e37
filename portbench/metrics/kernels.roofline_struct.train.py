"""The struct-tower kernels' share of their roofline (rows 7 and 8 of
PERF.md's table: both towers' forward and its backward): the least time
the traced window's steps need of them (``portbench.flops``, from each
step's real nodes and edges) over their measured device time, by kernel
name, in percent."""
from portbench import flops

NAMES = ("struct_fwd_kernel", "struct_bwd_row_kernel", "struct_grad_partial_kernel",
         "struct_grad_sum_kernel")


def read(run):
    spent = sum(s for n, s in run["kernels"].items() if any(k in n for k in NAMES))
    if spent <= 0 or not run["shapes"]:
        return None
    least = sum(flops.step_bounds_ms(run["cfg"], phase, False, n, e, u)["struct"]
                for phase, n, e, u, _ in run["shapes"])
    return least / (spent * 1e3) * 100.0
