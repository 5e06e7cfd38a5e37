"""The port's kernel and collective launches a train step, by its own
counters (``train.step.launch_counts``: the level and struct kernels and
the all-reduce; a replayed K-step graph adds what it enqueues), over the
traced window's train calls (rank 0's) and divided by their steps. Level
counts walked are not launches and are left out."""


def read(run):
    steps = run["steps"]["train"]
    if not steps:
        return None
    launched = sum(v for k, v in run["launches"]["train"].items() if "levels" not in k)
    return launched / steps
