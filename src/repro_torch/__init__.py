"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

Same sub-package layout and public names as ``repro``: ``gp`` (Matérn-5/2
GP), ``core`` (acquisition, batched L-BFGS-B, coroutine MSO), ``kernels``
(hand-written CUDA kernels with their plain PyTorch versions), ``engine``
(evaluation plane), ``bo`` (the ask/tell sampler) and ``obs`` (spans).

The BO runs in ``torch.float64`` end to end.  Importing the package turns
off TF32 for CUDA matmuls and cuDNN, so an f32 product on the card never
silently drops to ~3 decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """Entry-point device rule: ``None`` means the card.

    Raises when CUDA is asked for (explicitly or by default) on a machine
    without it: an entry point never moves to the CPU unasked.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
