"""Process-group initialization and the host identity of a rank.

Counterpart of `fullycnnspeechenhancement_tpu/parallel/multihost.py`.  JAX
runs one process per host; the port runs one process per rank (a card, or
a CPU worker) over `torch.distributed`, so "host" here counts nodes:
`host_count()` is the world size over the ranks a node runs
(`LOCAL_WORLD_SIZE`, which torchrun and `cli.train` set; without it, one
node), and `host_index()` is this rank's node.  Under data parallelism
`cli.train` does not shard the manifest by host: every rank reads all of
it and keeps its rows of each global batch.

Enable with env FCSE_MULTIHOST=1 (the standard `RANK`, `WORLD_SIZE`,
`MASTER_ADDR` and `MASTER_PORT` variables, as torchrun sets them), or call
`initialize_multihost` with explicit arguments.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    """nccl for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: Optional[float] = None,
) -> None:
    """Idempotent `init_process_group` with env fallbacks.

    `init_method` defaults to `env://` (MASTER_ADDR / MASTER_PORT);
    `world_size` and `rank` to WORLD_SIZE and RANK.  `backend` defaults to
    `default_backend(device)`; under nccl a device without an index becomes
    the card of this rank's LOCAL_RANK.  `timeout_s` (default
    FCSE_DIST_TIMEOUT_S, else torch's) bounds the rendezvous and every
    collective.  With neither arguments nor env there is no pod to join:
    the process stays single.  A pod configured by either that fails to
    start raises; the backend is never switched."""
    if dist.is_initialized():
        return
    explicit = init_method or world_size is not None or rank is not None
    if not explicit and not any(k in os.environ for k in _ENV_KEYS):
        logger.info("no process group configured; single process")
        return
    kwargs = {
        "init_method": init_method or "env://",
        "world_size": int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", -1)),
        "rank": int(rank if rank is not None else os.environ.get("RANK", -1)),
    }
    timeout_s = timeout_s if timeout_s is not None else os.environ.get("FCSE_DIST_TIMEOUT_S")
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    backend = backend or default_backend(device)
    try:
        if backend == "nccl":
            dev = torch.device(device)
            torch.cuda.set_device(dev if dev.index is not None else local_rank(kwargs["rank"]))
        dist.init_process_group(backend, **kwargs)
    except Exception as e:  # noqa: BLE001
        # The pod was configured explicitly: a silent single-process
        # fallback would train on 1/N of the data with nobody noticing.
        raise RuntimeError(
            f"init_process_group({backend!r}, {kwargs}) failed; refusing to fall "
            "back to a single process or another backend"
        ) from e
    logger.info(
        "process group up: rank %d/%d (%s), host %d/%d",
        dist.get_rank(), dist.get_world_size(), backend, host_index(), host_count(),
    )


def maybe_initialize_from_env(device="cuda") -> None:
    if os.environ.get("FCSE_MULTIHOST") == "1":
        initialize_multihost(device=device)


def _local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def local_rank(rank: Optional[int] = None) -> int:
    """This rank's index on its node: LOCAL_RANK, else the rank modulo the
    node's ranks (0 without a process group)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        if not dist.is_initialized():
            return 0
        rank = dist.get_rank()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    return rank % int(local) if local else rank


def host_index() -> int:
    if not dist.is_initialized():
        return 0
    return dist.get_rank() // _local_world_size()


def host_count() -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size() // _local_world_size()


def local_batch_size(global_batch: int) -> int:
    """Per-host slice of the global batch (must divide evenly)."""
    n = host_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n
