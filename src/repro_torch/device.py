"""Where the port's entry points run: the CUDA device unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point should run on.

    Parameters
    ----------
    device : str or torch.device, optional
        An explicit device (``"cpu"``, ``"cuda"``, ``"cuda:1"``, ...).
        ``None`` means the current CUDA device.

    Returns
    -------
    torch.device

    Raises
    ------
    RuntimeError
        When ``device`` is ``None`` and no CUDA device is available: the
        port never falls back to the CPU by itself.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
