"""The device an engine computes on.

The port's entry points (UnrootedInstance.prepare_for_phylo_likelihood,
LikelihoodEngine, GPInstance.make_engine, GPEngine) compute on the card
unless the caller passes ``device="cpu"``. Without a card the default raises;
nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def compute_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a torch.device, checked: a CUDA device needs a card
    (RuntimeError naming ``device="cpu"`` otherwise), and turns TF32 off
    (precision policy: no TF32 anywhere on the likelihood path)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested (the default), but no CUDA device "
                f"is present; pass device=\"cpu\" to compute on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
