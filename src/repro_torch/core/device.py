"""Where the port runs: the card, unless the caller asks for the CPU.

Every entry point (``Engine``, ``make_dataset``, ``HyperGraph.from_coo``,
the launcher) resolves its ``device`` argument here.  ``None`` means the
card; with no card present that raises instead of carrying on on the
CPU, so a run that was meant for the card never silently measures the
host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the host"
        )
    return dev
