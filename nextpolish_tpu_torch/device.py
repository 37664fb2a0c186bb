"""Device choice for the port's entry points.

Entry points take an explicit ``device`` argument (``worker2 --device``).
It defaults to ``cuda``; the CPU runs only when the caller asks for it, and
asking for ``cuda`` on a machine without a usable card raises instead of
carrying on silently on the CPU.  No global device state is kept.

Stages that spread work over cards (task 1's contig round-robin and its
reads-sharded merge, engine 2's window groups) take a list of devices
(`resolve_devices`): ``cuda`` names every visible card, as the JAX
package's ``jax.devices()`` names every local chip; ``CUDA_VISIBLE_DEVICES``
restricts it.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """`device` (or the ``cuda`` default) as a torch.device; raises if it
    names CUDA and no card is usable, or names any other backend."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (worker2 --device cpu) to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_devices(device=None) -> list[torch.device]:
    """The devices a stage may spread over: ``cuda`` (the default) gives
    every visible card in index order, ``cuda:K`` gives [cuda:K], ``cpu``
    gives [cpu], and a list or tuple gives each entry resolved (entries
    may repeat: a list that names one card twice runs two shards or
    round-robin slots on it).  Raises as resolve_device does."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        return [resolve_device(d) for d in device]
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)  # raises without a usable card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(dev)]
