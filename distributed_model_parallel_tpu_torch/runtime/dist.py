"""Process-group bootstrap on `torch.distributed` (port of
`runtime/dist.py`).

One process per GPU, as the reference runs (`mp.spawn` with
`init_process_group('nccl', init_method='tcp://...')`), launched by
`torchrun` or by hand:

* `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`
  (what `torchrun` sets) give the rendezvous, or the reference's
  `--dist-url tcp://host:port` with `RANK` / `WORLD_SIZE`;
* without a launcher, a world of one process starts on a free local
  port, so one GPU runs the same collective code as N;
* NCCL when the device is cuda, gloo on the CPU; each rank takes
  `cuda:LOCAL_RANK`;
* the process group has a timeout, so a rank that is lost fails the
  others instead of hanging them.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_backend(device: str = "cuda", dist_url: Optional[str] = None,
                       timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join (or start) the process group and return this rank's device.
    Idempotent: a second call returns the device of the first."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dist.is_initialized():
        return _rank_device(kind)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist_url is None:
        if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
            dist_url = (f"tcp://{os.environ['MASTER_ADDR']}:"
                        f"{os.environ['MASTER_PORT']}")
        elif world == 1:
            dist_url = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise RuntimeError(
                f"WORLD_SIZE={world} without MASTER_ADDR/MASTER_PORT or "
                "--dist-url: launch the ranks with torchrun"
            )
    dev = _rank_device(kind)
    if kind == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", init_method=dist_url,
        rank=rank, world_size=world, timeout=timeout,
        **({"device_id": dev} if kind == "cuda" else {}),
    )
    return dev


def _rank_device(kind: str) -> torch.device:
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that prints and writes the logs (rank 0)."""
    return process_index() == 0


__all__ = ["free_port", "initialize_backend", "is_primary", "process_count",
           "process_index"]
