"""Where the port runs, and the float32 numerics every config assumes."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; when there is none this raises rather
    than carrying on on the CPU.  The CPU runs only when it is asked for
    by name (the tests pass ``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but CUDA is not "
                           "available")
    return dev


def set_float32_numerics() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    Every config computes in float32 (``configs/base.py``); TF32 keeps
    about three decimal digits and would break parity with the reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
