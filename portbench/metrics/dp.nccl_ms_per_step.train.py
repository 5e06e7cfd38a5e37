"""NCCL's device milliseconds a train step on rank 0 (kernels named
``ncclDevKernel*``: the all-reduce each replayed step holds, which lasts
from this rank's arrival to the slowest rank's), over the traced window's
train steps. Nothing to read on one card."""


def read(run):
    steps = run["steps"]["train"]
    spent = sum(s for n, s in run["kernels"].items() if "nccl" in n.lower())
    if not steps or spent <= 0:
        return None
    return spent / steps * 1e3
