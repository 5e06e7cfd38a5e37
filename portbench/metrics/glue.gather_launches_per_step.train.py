"""The backward launches of the model's row gathers a train step: the
program's counter ``gather.bwd_launches`` (``ops.gather``: two launches of
``csrc/gather_rows_bwd.cu`` a ``gather_rows`` call that trains; a replayed
K-step graph adds what it enqueues) over the traced window's train calls
(rank 0's), divided by their steps. Nothing to read from a program
without the counter, or from a window without train steps."""


def read(run):
    steps = run["steps"]["train"]
    launched = run["launches"]["train"].get("gather.bwd_launches")
    if not steps or launched is None:
        return None
    return launched / steps
