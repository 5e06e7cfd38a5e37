"""Host milliseconds of the K-step call's own work a train step: the
program's ``trainer.step`` spans (``Trainer.step_times`` entries ``train``:
each call from its start to its return) less the waits on the card inside
them (``kstep.stage_wait``, entries ``stage_wait:train``: the staging area
held until the copies of the call before last have run), summed over the
traced window's train phase and divided by its train steps (rank 0's).
Nothing to read from a program without the wait's span."""


def read(run):
    steps, spans = run["steps"]["train"], run["step_times"] or []
    waits = [s for name, _, s in spans if name == "stage_wait:train"]
    if not steps or not waits:
        return None
    calls = sum(s for name, _, s in spans if name == "train")
    return (calls - sum(waits)) / steps * 1e3
