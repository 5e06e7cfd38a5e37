"""Process groups: the port's counterpart of ``mgvae_tpu/parallel/mesh.py``.

The JAX package runs one program over a device mesh; PyTorch runs one
process per device. ``maybe_initialize_distributed`` is the rendezvous,
from torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) or the JAX package's launch variables
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``), and
``make_mesh(dp, mp)`` splits the processes into the groups of the two mesh
axes: the rank at (d, m), rank d * mp + m, holds member m of dp shard d.

A launch starts when ``RANK`` or ``WORLD_SIZE`` is set, or
``COORDINATOR_ADDRESS``; ``MASTER_ADDR`` / ``MASTER_PORT`` alone start
none. The backend is NCCL on ``cuda:{LOCAL_RANK}``, and gloo when the
caller asks for the CPU or names gloo (several processes sharing one card:
NCCL refuses two ranks on one device). No backend is chosen silently.

``multi_host_launch`` tells a launch over several hosts from one over one
host, for the trainer's grouping rule (the JAX trainer groups steps only
when ``jax.process_count() == 1``, one process over all of a host's
devices; the port runs one process per device, so a single-host launch of
W processes is the counterpart of that one JAX process).
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
JAX_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
# the variables that start a launch: torchrun's ranks (MASTER_ADDR and
# MASTER_PORT alone, which many cluster shells and images export, do not),
# and the JAX package's coordinator (``mgvae_tpu/parallel/mesh.py``)
TRIGGERS = {TORCHRUN_VARS: ("RANK", "WORLD_SIZE"), JAX_VARS: ("COORDINATOR_ADDRESS",)}


def _launch_config() -> dict | None:
    """(init_method, rank, world_size, local_rank) from the environment;
    None when no launch is started (module docstring). A launch with a
    partial set raises: proceeding as one process would make every process
    the chief and skip the gradient mean. The local rank is ``LOCAL_RANK``,
    or 0: the JAX package's launch runs one process per host, so under its
    variables each host trains on its first card unless ``LOCAL_RANK`` says
    otherwise."""
    env = os.environ
    for names, example in ((TORCHRUN_VARS, "torchrun --nproc_per_node k"),
                           (JAX_VARS, "mgvae_tpu_torch/examples/run_multihost.sh")):
        if not any(n in env for n in TRIGGERS[names]):
            continue
        missing = [n for n in names if n not in env]
        if missing:
            have = [n for n in names if n in env]
            raise RuntimeError(
                f"{', '.join(have)} set but {', '.join(missing)} missing: a partial "
                f"multi-process launch (set all of {', '.join(names)}, or launch with "
                f"{example})")
        if names is TORCHRUN_VARS:
            rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
            init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            rank, world = int(env["PROCESS_ID"]), int(env["NUM_PROCESSES"])
            init = f"tcp://{env['COORDINATOR_ADDRESS']}"
        local = int(env.get("LOCAL_RANK", 0))
        return {"init_method": init, "rank": rank, "world_size": world, "local_rank": local}
    return None


def multi_host_launch() -> bool:
    """Whether the launch variables describe processes on more than one
    host. torchrun's (``RANK`` / ``WORLD_SIZE`` set): ``WORLD_SIZE >
    LOCAL_WORLD_SIZE``, which torchrun sets on every rank; without
    ``LOCAL_WORLD_SIZE`` (a launch made by hand) any ``WORLD_SIZE > 1``
    counts, as nothing says that the processes share a host. The JAX
    package's (``COORDINATOR_ADDRESS``, one process per host): ``NUM_PROCESSES
    > 1``. No launch: False. The variables are read as ``_launch_config``
    reads them, torchrun's first."""
    env = os.environ
    if any(n in env for n in TRIGGERS[TORCHRUN_VARS]):
        world = int(env.get("WORLD_SIZE", 1))
        return world > int(env.get("LOCAL_WORLD_SIZE", 1))
    if any(n in env for n in TRIGGERS[JAX_VARS]):
        return int(env.get("NUM_PROCESSES", 1)) > 1
    return False


def maybe_initialize_distributed(device="cuda", backend: str | None = None,
                                 timeout: float | None = None) -> tuple[int, int]:
    """Join the process group the launch variables describe; returns (rank,
    world size). A no-op returning the existing group's (rank, size) when
    one is up, and (0, 1) when no launch variable is set.

    ``device``: "cuda" takes NCCL on ``cuda:{LOCAL_RANK}`` (made the current
    device); "cpu" takes gloo. ``backend="gloo"`` takes gloo on either (the
    card's tensors then travel through the host inside gloo).
    ``timeout``: seconds each collective may wait (torch's default when
    None)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    launch = _launch_config()
    if launch is None:
        return 0, 1
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"no backend {backend!r} for device {dev}: NCCL on the card, gloo "
                         "on the CPU or named for processes that share a card")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank: training runs on the card unless "
                               "the caller asks for the CPU (MGVAE_PLATFORM=cpu)")
        torch.cuda.set_device(local_device(dev, launch["local_rank"]))
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=launch["init_method"], rank=launch["rank"],
                            world_size=launch["world_size"], **kw)
    return dist.get_rank(), dist.get_world_size()


def local_device(device, local_rank: int | None = None) -> torch.device:
    """This process's device: "cuda" without an index is ``cuda:{LOCAL_RANK}``
    under a launch (``cuda:0`` otherwise); a device with an index, or the
    CPU, stays as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, mp) split of the processes and this process's place in it.
    ``dp_group`` holds the ranks of this member index across the dp shards
    (the gradient, BN-state and metric means), ``mp_group`` the members of
    this dp shard (the collectives of the sharded forward)."""
    dp: int
    mp: int
    dp_rank: int
    mp_rank: int
    dp_group: object
    mp_group: object


def make_mesh(dp: int, mp: int = 1) -> Mesh:
    """The (dp, mp) mesh over every process of the group: dp * mp must be
    the world size. Every process calls it, in the same order as the
    others (``new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group (maybe_initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * mp != world:
        raise ValueError(f"a ({dp}, {mp}) mesh needs {dp * mp} processes, the group has {world}")
    dp_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
    d, m = divmod(rank, mp)
    return Mesh(dp, mp, d, m, dp_groups[m], mp_groups[d])


def make_dp_mesh() -> Mesh:
    """Data parallelism over every process: dp = world size, mp = 1."""
    return make_mesh(dist.get_world_size(), 1)
