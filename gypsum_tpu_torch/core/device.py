"""Device selection for the whole port, in one place.

Every entry point (Receiver, AcquisitionEngine, TrackerBank, the CLI)
takes ``device=`` and resolves it here. The default is ``"cuda"``; asking
for CUDA on a machine without a card raises instead of carrying on quietly
on the CPU. Tests and CPU runs pass ``device="cpu"`` explicitly.

Resolving a device also pins the float32 matmul precision: TF32 keeps about
three decimal digits, which would round the tracker's phase-1 correlations
and break parity with the reference, so both switches are set off.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device``; raises when CUDA is asked for but
    no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda | cpu)")
    return dev
