"""The whole step's share of the card's fp32 peak while the card works:
the model operations of rank 0's steps in the traced window
(``portbench.flops``: each train step's ``train_flops``, each val step's
forward, from the steps' real nodes, gates, edges and pairs) over the
device's busy time in the profiler's trace (the union of its kernels,
copies and sets) at 67 TFLOP/s, in percent. It bounds every kernel's gain:
a kernel taken off the path leaves its roofline silent, not this; the
card's idle time is ``device.idle_share.train``'s."""
from portbench import flops

COUNT = {"train": flops.train_flops, "val": flops.model_flops}


def read(run):
    work = sum(COUNT[phase](run["cfg"], n, u, e, p) for phase, n, e, u, p in run["shapes"])
    if work <= 0 or run["busy_s"] <= 0:
        return None
    return work / (run["busy_s"] * flops.PEAK_FLOP_S) * 100.0
