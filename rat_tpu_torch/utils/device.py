"""Device resolution shared by the port's entry points."""

import torch


def resolve_device(device=None):
    """``None`` means ``"cuda"``. A CUDA device that is not available
    raises: the port never drops to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return device
