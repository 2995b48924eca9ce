"""Device resolution and the run header (port of `tpu_dp.parallel.dist`).

One process drives one card so far, so only the two pieces serving and
single-process training need are here: `resolve_device` and `describe`.
Process groups and collectives come with the multi-rank slice.
"""

from __future__ import annotations

import os
import socket

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the first CUDA card, and raises when there is none: an
    entry point never drops silently to the CPU. An explicit device (the
    tests pass ``"cpu"``) is taken as given.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def describe(device=None) -> dict:
    """Topology summary for the run header: what this process drives."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    return {
        "devices": torch.cuda.device_count() if cuda else 1,
        "device_kind": (torch.cuda.get_device_name(dev) if cuda
                        else "cpu"),
        "platform": "gpu" if cuda else "cpu",
        "device": str(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host": socket.gethostname(),
        "host_cpus": os.cpu_count(),
    }
