"""CUDA graphs the K-step calls capture inside the traced window (rank
0's): the program's ``kstep.capture`` spans (``Trainer.step_times``
entries ``capture:train`` and ``capture:val``), one where
``_GroupRunner.captures`` counts. Epoch 0, outside the window, captures
each layout's graph; a capture inside it is a new layout (the running-max
dims grew). 0 when none ran; nothing to read from a program without the
trainer's spans (no ``plan:train`` entry)."""


def read(run):
    spans = run["step_times"] or []
    if not any(name == "plan:train" for name, _, _ in spans):
        return None
    return float(sum(1 for name, _, _ in spans if name.startswith("capture:")))
