"""The share of rank 0's traced window in which nothing ran on its card
(1 - the union of kernels, copies and sets over the window), in percent."""


def read(run):
    if run["window_s"] <= 0:
        return None
    return (1.0 - run["busy_s"] / run["window_s"]) * 100.0
