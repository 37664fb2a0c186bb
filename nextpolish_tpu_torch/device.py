"""Device choice for the port's entry points.

Entry points take an explicit ``device`` argument (``worker2 --device``).
It defaults to ``cuda``; the CPU runs only when the caller asks for it, and
asking for ``cuda`` on a machine without a usable card raises instead of
carrying on silently on the CPU.  No global device state is kept.
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
