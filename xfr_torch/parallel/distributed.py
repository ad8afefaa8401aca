"""Multi-process job coordination (port of xfr_tpu/parallel/distributed.py).

The reference's multi-machine story is a shared filesystem + randomized job
order + skip-if-output-exists (generate_..._multigpu.py:313-318).  Here,
multi-process runs get deterministic partitioning by ``torch.distributed``
rank (one process per card, as ``torchrun`` launches them) or explicit
shard arguments, with the same shared-FS idempotency as the safety net.
"""

from __future__ import annotations

import os
import random

import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """``torch.distributed.init_process_group`` wrapper (no-op when
    single-process, as the JAX package's is).

    ``coordinator_address``: an init method, ``"tcp://host:port"`` or
    ``"file:///shared/path"``; a bare ``"host:port"`` becomes ``tcp://``.
    The backend is NCCL when a card is present, else gloo (the CPU)."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if coordinator_address is not None and "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def initialize_from_env():
    """Join the process group that a ``torchrun`` launch describes in the
    environment (WORLD_SIZE > 1, not yet joined): NCCL with a card, each
    rank on the card of its LOCAL_RANK, else gloo.  A no-op otherwise, so
    a CLI calls it unconditionally."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    initialize("env://")


def process_info():
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def partition_jobs(jobs, shard_index=None, num_shards=None, shuffle=False,
                   seed=0):
    """Deterministic strided partition of a job list across workers.

    With shuffle=True the full list is shuffled with a shared seed first so
    every worker computes the same permutation (heterogeneous fleets then
    load-balance via the skip-if-exists file cache)."""
    jobs = list(jobs)
    if shuffle:
        random.Random(seed).shuffle(jobs)
    if shard_index is None or num_shards is None:
        shard_index, num_shards = process_info()
    return jobs[shard_index::num_shards]


def is_primary():
    return process_info()[0] == 0


def writes(mesh=None):
    """Whether this process writes a run's files: always without a device
    mesh; under one, where every rank computes the same results, only the
    first rank."""
    return mesh is None or is_primary()


_BARRIER_GEN: dict = {}


def barrier_via_files(path, tag, timeout_s=3600):
    """Filesystem barrier for shared-FS fleets without a process group.

    Safe to call repeatedly with the same tag — an internal generation
    counter namespaces each call (every process calls barriers in the
    same order, so generations agree).  Markers are never cleaned up
    (removal races the slowest waiter), so a barrier directory must be
    fresh per run: a pre-existing marker for THIS process raises instead
    of letting stale markers from a crashed previous run satisfy the
    count and silently skip synchronization."""
    import time

    idx, count = process_info()
    os.makedirs(path, exist_ok=True)
    gen = _BARRIER_GEN.get((path, tag), 0) + 1
    _BARRIER_GEN[(path, tag)] = gen
    full = "%s.g%d" % (tag, gen)
    marker = os.path.join(path, "%s.%d" % (full, idx))
    if os.path.exists(marker):
        raise RuntimeError(
            "stale barrier marker %s already exists — this barrier "
            "directory was used by a previous run; clear it (or use a "
            "fresh per-run path) before reusing" % marker)
    open(marker, "w").close()
    t0 = time.time()
    while True:
        done = sum(os.path.exists(os.path.join(path, "%s.%d" % (full, i)))
                   for i in range(count))
        if done >= count:
            return
        if time.time() - t0 > timeout_s:
            raise TimeoutError("barrier %s timed out (%d/%d)"
                               % (full, done, count))
        time.sleep(1.0)
