"""The trainer's span log: named ranges around its host work, on the
profiler's clock.

A ``Spans`` belongs to one trainer, which hands it to its K-step calls.
It is off unless the trainer turns it on for a phase (``recording``):
with a list (``Trainer.step_times``), or for a ``trace_dir`` capture
without one. Off, ``spans(name)`` returns a shared no-op context: one
check, no allocation, no profiler call. On, it opens
``torch.profiler.record_function(name)``, so that a profiler capture
holds the range among its host events, and when the range closes it
appends ``(entry, steps done in the phase, host seconds)`` to the list.
The entry is the name after its first dot and the phase
(``"trainer.plan"`` in the train phase: ``"plan:train"``), but for the
two in ``ENTRIES``: each call's is its phase, the read-back's
``fetch:<phase>``. A range that raises appends nothing. Work on another
thread opens a bare range (``range_only``), which appends nothing.
"""
from __future__ import annotations

import contextlib
import time

import torch

# ranges whose entries are named otherwise
ENTRIES = {"trainer.step": "{phase}", "trainer.readback": "fetch:{phase}"}

_OFF = contextlib.nullcontext()


class Spans:
    def __init__(self):
        self.on = False
        self.log = None       # the list entries go to, or None (ranges only)
        self.phase = ""
        self.steps = 0        # steps done in the phase: the trainer keeps it

    @contextlib.contextmanager
    def recording(self, log, phase: str, ranges: bool = False):
        """On for the body when ``log`` is a list or ``ranges`` is set."""
        if log is None and not ranges:
            yield
            return
        self.on, self.log, self.phase, self.steps = True, log, phase, 0
        try:
            yield
        finally:
            self.on, self.log = False, None

    def __call__(self, name: str):
        if not self.on:
            return _OFF
        return _Span(self, name)

    def range_only(self, name: str):
        """A ``record_function`` range while the spans are on, and no entry:
        for work off the step's thread (the trainer's look-ahead)."""
        return torch.profiler.record_function(name) if self.on else _OFF


class _Span:
    __slots__ = ("owner", "name", "range", "t0")

    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, kind, value, tb):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(kind, value, tb)
        owner = self.owner
        if owner.log is not None and kind is None:
            form = ENTRIES.get(self.name) or self.name.split(".", 1)[1] + ":{phase}"
            owner.log.append((form.format(phase=owner.phase), owner.steps, seconds))
        return False


# what a K-step call made outside a trainer holds: never turned on
OFF = Spans()
