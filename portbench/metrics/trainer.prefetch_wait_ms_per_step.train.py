"""Host milliseconds a train step waits for its data: the program's
``trainer.prefetch_wait`` spans (``Trainer.step_times`` entries
``prefetch_wait:train``: the step's thread blocked on the prefetch queue;
the phase's first wait holds the thread's start and its first,
un-prefetched collate), summed over the traced window's train phase and
divided by its train steps (rank 0's). Nothing to read from a program
without the span."""


def read(run):
    steps, spans = run["steps"]["train"], run["step_times"] or []
    waits = [s for name, _, s in spans if name == "prefetch_wait:train"]
    if not steps or not waits:
        return None
    return sum(waits) / steps * 1e3
