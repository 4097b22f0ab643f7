"""Which device an entry point runs on.

Entry points take ``device=None``, which means the CUDA card. Without a card
that is an error: the port never moves to the CPU on its own. The CPU runs
the plain PyTorch versions only when a caller asks for it by name, as the
tests do with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run the plain PyTorch versions instead")
        return torch.device("cuda")
    return torch.device(device)
