"""The check's control and faults at a size a test run holds: each must
come out not correct, while the program as configured comes out correct.
Each drives the rest of a run (set-up, the window, the check) on the CPU,
past the harness's look for a chip, with the program broken underneath:

  tf32        the control: the program's products in TF32 (on the CPU its
              operands rounded to TF32's mantissa), not the fp32 stated
  frozen      a step that returns its state unchanged (Adam's step a no-op)
  half        half of each loss's rows left out, the mean over the rest
  noexchange  the data-parallel all-reduce left out (two gloo ranks)
"""
import multiprocessing
import os
import socket
import time

import pytest

from portbench import cell
from portbench_tiny import cell as tiny_cell, random_traffic


def one_run(plant, seed=2**31 + 3):
    c = tiny_cell("mig_train_bs16", "dgae_mig_d64", random_traffic())
    return cell.run(c, seed, 0.0, False, time.time(), plant=plant)


def test_sound_run_is_correct():
    res = one_run(None)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("plant", ["tf32", "frozen", "half"])
def test_fault_is_caught(plant):
    res = one_run(plant)
    assert not res["correct"], (plant, res["checks"])


def _rank(rank: int, port: int, plant, queue) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      OMP_NUM_THREADS="1")
    import torch.distributed as dist

    c = tiny_cell("mig_train_dp4", "dgae_mig_d64", random_traffic(dp=2))
    res = cell.run(c, 2**31 + 21, 0.0, False, time.time(), rank=rank, world=2, plant=plant)
    dist.destroy_process_group()
    if rank == 0:
        from portbench import run, spec

        line = run.result_line(spec.benchmark(), "mig_train_dp4", res, False, 2, "cpu")
        queue.put((res["correct"], res["checks"], sorted(line["metrics"])))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("plant,want", [(None, True), ("noexchange", False)])
def test_data_parallel_exchange(plant, want):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, plant, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        correct, checks, metrics = queue.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    assert all(p.exitcode == 0 for p in procs)
    assert correct == want, checks
    assert metrics == ["dp_train_gates_per_s", "setup_s"]
