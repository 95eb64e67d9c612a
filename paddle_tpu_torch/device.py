"""Device resolution for the port's entry points.

The port runs on an NVIDIA Hopper card (compute capability 9.0). An entry
point asked for CUDA on a machine without such a card raises; it never
drops to the CPU on its own. The CPU is used only when the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""
from __future__ import annotations

import torch

HOPPER_CAPABILITY = (9, 0)


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device`` after checking it can run
    the port: ``cpu``, or a CUDA device of capability (9, 0)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {dev} is neither 'cuda' nor 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch versions")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != HOPPER_CAPABILITY:
        raise RuntimeError(
            f"device {dev} has compute capability {cap}; the port's "
            f"kernels are built for sm_90a and need {HOPPER_CAPABILITY}")
    return dev
