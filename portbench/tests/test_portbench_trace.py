"""Reading the profiler's capture (``trace.reduce``): a host range, the
benchmark's or one the program opens around its own code, shows on the
device's timeline too; it is not device activity, so wrapping program code
in a range changes neither the busy time nor the time by kernel."""
import pytest
import torch

from portbench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
MAIN = 7


class Event:
    def __init__(self, name, start, end, device=CUDA, annotation=False, thread=MAIN):
        self._name, self._start, self._end = name, start, end
        self._device, self._annotation, self._thread = device, annotation, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return self._annotation


def program_step():
    """Two kernels and a copy with gaps between them, and the host events
    that enqueued them, in a window of 0-100 ns."""
    return [Event("aten::mm", 0, 8, CPU), Event("cudaLaunchKernel", 2, 6, CPU),
            Event("volta_sgemm_128x64_nn", 10, 30), Event("indexing_backward_kernel", 40, 70),
            Event("Memcpy DtoH (Device -> Pageable)", 80, 85),
            Event("cudaMemcpyAsync", 75, 86, CPU)]


def ranged(name, flagged):
    """The same step under a range: the host's range and its span on the
    device, over every kernel it enqueued and the gaps between them."""
    return program_step() + [Event(name, 0, 90, CPU), Event(name, 9, 86, annotation=flagged)]


@pytest.mark.parametrize("name", ["portbench.kstep.train", "mgvae.level_recurrence",
                                  "ProfilerStep#3"])
@pytest.mark.parametrize("flagged", [False, True])
def test_a_range_around_program_code_changes_no_device_reading(name, flagged):
    bare = trace.reduce(program_step(), 0, 100, MAIN)
    wrapped = trace.reduce(ranged(name, flagged), 0, 100, MAIN)
    assert bare["busy_s"] == pytest.approx(55e-9)
    for key in ("busy_s", "window_s", "kernels", "counts", "device_ops"):
        assert wrapped[key] == bare[key], key


def test_a_flagged_range_named_unlike_any_host_event_is_left_out():
    events = program_step() + [Event("gpu range of another thread's", 9, 86, annotation=True)]
    assert trace.reduce(events, 0, 100)["busy_s"] == pytest.approx(55e-9)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    got = dict(trace.reduce(ranged("mgvae.level_recurrence", False), 0, 100, MAIN)["idle_gaps"])
    # 0-10 under aten::mm / the range, 30-40, 70-80 and 85-100 under the range
    assert sum(got.values()) == pytest.approx(45e-9)
    assert set(got) <= {"aten::mm", "cudaLaunchKernel", "mgvae.level_recurrence",
                        "cudaMemcpyAsync", "host idle"}


def test_step_mfu_reads_the_traced_busy_time():
    """``step_mfu.train``: the steps' model operations over the device's busy
    time from the trace, not over the host's window."""
    from portbench import flops, spec
    from portbench_tiny import config

    read = spec.reader("step_mfu.train")
    cfg = config("dgae_mig_d64")
    shapes = [("train", 280, 517, 264, 64)] * 3 + [("val", 280, 517, 264, 64)]
    run = {"cfg": cfg, "shapes": shapes, "busy_s": 0.01, "window_s": 0.02}
    work = 3 * flops.train_flops(cfg, 280, 264, 517, 64) + flops.model_flops(cfg, 280, 264,
                                                                               517, 64)
    assert read(run) == pytest.approx(work / (0.01 * flops.PEAK_FLOP_S) * 100.0)
    assert read(dict(run, window_s=5.0)) == read(run)
    assert read(dict(run, busy_s=0.0)) is None
