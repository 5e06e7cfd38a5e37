"""Host milliseconds the trainer spends a train step: the program's own
``Trainer.step_times`` spans (each K-step call from its start to its
return, and the epoch's metric read-back), summed over the traced window's
train phase and divided by its train steps (rank 0's)."""


def read(run):
    steps, spans = run["steps"]["train"], run["step_times"]
    if not steps or not spans:
        return None
    return sum(s for phase, _, s in spans if phase in ("train", "fetch:train")) / steps * 1e3
