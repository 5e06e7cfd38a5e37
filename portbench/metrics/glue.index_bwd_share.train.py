"""The share of the device's busy time in PyTorch's index backward
(kernels named ``indexing_backward*``: the gradients of the model's gathers
in ``level_statics``, ``level_scan_inputs``, ``decode_edges`` and the
losses), over rank 0's traced window, in percent."""


def read(run):
    if run["busy_s"] <= 0:
        return None
    spent = sum(s for n, s in run["kernels"].items() if "indexing_backward" in n)
    return spent / run["busy_s"] * 100.0
