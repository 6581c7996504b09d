"""Multi-process runs over ``torch.distributed``.

The port of ``netrep_tpu/parallel/distributed.py``. The JAX package joins
one process per host through JAX's coordination service and builds one
global mesh whose ``perm`` axis spans the hosts; the port joins its
processes in a ``gloo`` process group and builds the same global mesh
(:func:`~netrep_tpu_torch.parallel.mesh.make_mesh` after
:func:`initialize`): each process names its own devices, and the mesh
lays every process's perm rows out in process order.

Usage, the same program in every process::

    from netrep_tpu_torch.parallel import distributed, mesh
    distributed.initialize()            # env-driven; no-op single-process
    m = mesh.make_mesh()                # perm rows of every process
    module_preservation(..., mesh=m)

Each process runs only its own shards of a chunk (the SPMD contract: the
same seed gives the same keys in every process) — the dense, multi-test
and sparse engines, and the screened null; :func:`gather_to_host`
allgathers the materialized null in chunk order and :func:`sum_to_host`
sums the streaming tallies (the screened null's rescue counters with
them), so every process returns the whole result.

``gloo`` carries host tensors, so a card's share is copied to the host
before it crosses (NCCL also refuses two processes on one card). The group
has a timeout (:data:`DEFAULT_TIMEOUT_S`): a collective whose peer died
raises instead of waiting for it, and every collective here turns the
backend's error into :class:`~netrep_tpu_torch.utils.faults.PeerLostError`,
which the fault ladder never retries: the group is broken.

Process 0 alone writes a run's checkpoint, and every process resumes
from what process 0 read (``engine.Checkpointer``); process 0 alone
records a perf-ledger entry. The JAX package's ``to_global`` has no
counterpart: each process places its own shards' operands itself, so no
engine path assembles a global array.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..utils import telemetry as tm
from ..utils.faults import PeerLostError

logger = logging.getLogger("netrep_tpu_torch")

#: Environment variables consulted when arguments are omitted: the JAX
#: package's names, so one launcher starts either package's processes.
ENV_VARS = {
    "coordinator_address": "JAX_COORDINATOR_ADDRESS",
    "num_processes": "JAX_NUM_PROCESSES",
    "process_id": "JAX_PROCESS_ID",
}

#: the launcher variables of ``torchrun`` that stand in for all three when
#: none is given (the port's auto-detection, as JAX's on a Cloud TPU VM)
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

#: seconds a collective waits on its peers before it raises
DEFAULT_TIMEOUT_S = 120.0


def is_initialized() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def local_device_count() -> int:
    """The devices this process drives: its visible cards, or the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return n or 1


def _summary() -> dict:
    local = local_device_count()
    return {"process_id": process_index(), "process_count": process_count(),
            "local_device_count": local,
            "global_device_count": local * process_count()}


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the process group — idempotent, env-var driven.

    Arguments default from ``ENV_VARS``; with none of them given, the
    ``torchrun`` variables (:data:`TORCHRUN_VARS`) stand in, and without
    those the run stays single-process. ``coordinator_address`` is
    ``host:port`` of process 0 (or a ``tcp://`` URL). Calling again after
    a successful join is a no-op.

    Returns a summary dict: ``process_id``, ``process_count``,
    ``local_device_count``, ``global_device_count`` (the port's devices:
    visible cards, or the CPU as one).
    """
    if is_initialized():
        return _summary()
    coordinator_address = coordinator_address or os.environ.get(
        ENV_VARS["coordinator_address"])
    if num_processes is None and ENV_VARS["num_processes"] in os.environ:
        num_processes = int(os.environ[ENV_VARS["num_processes"]])
    if process_id is None and ENV_VARS["process_id"] in os.environ:
        process_id = int(os.environ[ENV_VARS["process_id"]])
    given = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in given) and any(v is None for v in given):
        raise ValueError(
            "partial multi-host configuration: coordinator_address, "
            "num_processes and process_id must be given (or set via "
            f"{sorted(ENV_VARS.values())}) together, got "
            f"address={coordinator_address!r} num={num_processes!r} "
            f"id={process_id!r}. On Cloud TPU VMs omit all three."
        )
    explicit = coordinator_address is not None
    if not explicit:
        if not all(v in os.environ for v in TORCHRUN_VARS):
            return _summary()
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    try:
        dist.init_process_group(
            "gloo", init_method=_init_method(coordinator_address),
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=float(timeout_s)))
    except Exception as exc:
        if explicit:
            raise  # explicit configuration that failed: surface it
        # the launcher's variables were there but the join failed: the
        # other processes will wait at their first collective, so say so
        logger.warning(
            "multi-process auto-detection did not join a process group "
            "(%s: %s); continuing single-process. If this process IS part "
            "of a multi-process run, the others will hang — set %s/%s/%s "
            "explicitly.", type(exc).__name__, exc,
            *sorted(ENV_VARS.values()))
        tel = tm.current()
        if tel is not None:
            tel.emit("distributed_autodetect_failed",
                     error=type(exc).__name__, detail=str(exc)[:200])
        return _summary()
    info = _summary()
    logger.info("joined process group: process %d/%d, %d local device(s)",
                info["process_id"], info["process_count"],
                info["local_device_count"])
    tel = tm.current()
    if tel is not None:
        tel.emit("distributed_init", process_id=info["process_id"],
                 process_count=info["process_count"],
                 local_devices=info["local_device_count"],
                 global_devices=info["global_device_count"])
    return info


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()


def filter_addressable(devices) -> list:
    """The devices of ``devices`` this process can still drive — the
    elastic shrink rung's guard: the CPU, and the cards whose index the
    runtime still enumerates. Returns ``[]`` when the runtime can no
    longer enumerate cards at all (the caller takes the CPU rung)."""
    try:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except RuntimeError:
        return []
    return [d for d in devices
            if torch.device(d).type != "cuda"
            or (torch.device(d).index or 0) < cards]


@contextlib.contextmanager
def _collective(what: str):
    """A collective's backend error (``gloo``'s read error when a peer
    left, its timeout when a peer never came) as :class:`PeerLostError`."""
    try:
        yield
    except RuntimeError as e:
        raise PeerLostError(
            f"rank {process_index()} of {process_count()}: the {what} of "
            f"the process group failed ({type(e).__name__}: "
            f"{str(e)[:300]}); a peer process left or faulted. Process 0 "
            "keeps a run's completed permutations in its checkpoint, when "
            "one was asked for: launch every process again to resume"
        ) from e


def all_gather_object(obj) -> list:
    """``obj`` of every process, in process order."""
    out = [None] * process_count()
    with _collective("object allgather"):
        dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` in every process."""
    box = [obj]
    with _collective("object broadcast"):
        dist.broadcast_object_list(box, src=src)
    return box[0]


def gather_to_host(x, axis: int = 0):
    """This process's share of a chunk's outputs → the whole chunk as host
    numpy arrays in every process, each process's share in process order
    along ``axis``. ``x`` is one tensor or a list of tensors (each
    process's of the same shapes); a list goes over in one collective.

    Without a process group, a plain copy to the host. The engine calls it
    only for a mesh that spans processes, so a run without one never
    concatenates copies. This is the cross-process hop of the null
    collection; each hop emits an ``allgather`` event with its seconds and
    the bytes every process received."""
    one = isinstance(x, torch.Tensor)
    parts = [x] if one else list(x)
    if process_count() == 1:
        out = [p.detach().cpu().numpy() for p in parts]
        return out[0] if one else out
    t0 = time.perf_counter()
    flat = torch.cat([p.detach().reshape(-1).cpu() for p in parts])
    bufs = [torch.empty_like(flat) for _ in range(process_count())]
    with _collective("allgather"):
        dist.all_gather(bufs, flat)
    out, at = [], 0
    for p in parts:
        n = p.numel()
        out.append(np.concatenate(
            [b[at: at + n].numpy().reshape(p.shape) for b in bufs],
            axis=axis))
        at += n
    tel = tm.current()
    if tel is not None:
        tel.emit("allgather", s=time.perf_counter() - t0,
                 bytes=int(sum(b.numel() * b.element_size() for b in bufs)))
    return out[0] if one else out


def sum_to_host(a: np.ndarray) -> np.ndarray:
    """The int64 sum over processes of host tallies ``a`` (exact: integer
    addition in any order gives the same sum)."""
    if process_count() == 1:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).clone()
    with _collective("tally sum"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()
