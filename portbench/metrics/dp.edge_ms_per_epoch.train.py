"""Host milliseconds an epoch spends at its phases' edges: the program's
``trainer.plan``, ``trainer.log`` and ``trainer.save`` spans
(``Trainer.step_times`` entries ``plan:*``, ``log:*``, ``save:*``: the
shuffle and the dims scan, the meters and the epoch line, the chief's
checkpoints), both phases summed over the traced window and divided by
its epochs (its ``plan:train`` entries) on rank 0 of a data-parallel
launch, which alone saves the checkpoints while the other ranks wait for
it at the next all-reduce. Nothing to read from a program without the
spans."""

EDGES = ("plan:", "log:", "save:")


def read(run):
    spans = run["step_times"] or []
    epochs = sum(1 for name, _, _ in spans if name == "plan:train")
    if not epochs:
        return None
    return sum(s for name, _, s in spans if name.startswith(EDGES)) / epochs * 1e3
