"""Device resolution for every entry point of the port.

The JAX package reaches its accelerator through ``jax.default_backend()``
and a mesh; the port names one ``torch.device`` explicitly and hands it
down (``ServerConfig.device`` → ``WorkflowContext.device`` → the
algorithm's device tables). There is no fallback: a caller that wants
the CPU says ``device="cpu"`` (the tests do), and a machine without
CUDA makes the default raise instead of serving slowly on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the first CUDA card (``cuda:0``) and raises
    ``RuntimeError`` when CUDA is not available. An explicit device is
    honoured as given; an explicit CUDA device on a machine without
    CUDA raises too. Never returns the CPU unless asked for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run on the host explicitly"
            )
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


def describe_device(device: Optional[torch.device]) -> str:
    """Human-readable device name for status pages: the card's name on
    CUDA, ``cpu`` otherwise."""
    if device is not None and device.type == "cuda":
        return f"{device} {torch.cuda.get_device_name(device)}"
    return str(device)
