"""PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

Same sub-package layout and public names as ``repro``: ``gp`` (Matérn-5/2
GP), ``core`` (acquisition, batched L-BFGS-B, coroutine MSO), ``kernels``
(hand-written CUDA kernels with their plain PyTorch versions), ``engine``
(evaluation plane), ``bo`` (the ask/tell sampler) and ``obs`` (spans).
Two rules every module follows live here: :func:`resolve_device` (an
entry point runs on the card unless asked otherwise) and :func:`by_study`
(a stacked op on the fleet's study axis keeps each study's solo bits).

The BO runs in ``torch.float64`` end to end.  Importing the package turns
off TF32 for CUDA matmuls and cuDNN, so an f32 product on the card never
silently drops to ~3 decimal digits.
"""
import torch

Tensor = torch.Tensor

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


def by_study(fn, *args, stacked: bool):
    """``fn`` once per study of stacked arguments, the results stacked.

    A batched Cholesky, triangular solve, matrix product or row sum on
    the card picks its algorithm, and so its summation order, from the
    whole batch: study s would round otherwise in an S-study stack than
    alone.  Issued slice by slice, every call has exactly the shape of the
    solo call, so a study's bits do not depend on its company.  Tensor
    arguments lead with the study axis; ``None`` and other values pass to
    every slice as they are; ``None`` results stay ``None``.  Each
    argument is split by one ``unbind`` and the results joined by one
    ``stack``, so under autograd the backward runs slice by slice too.
    With ``stacked`` False the arguments are one study's, run as a stack
    of one through the same split and join: the layouts autograd hands
    back (which a CPU product's rounding follows) then match as well.
    """
    if not stacked:
        out = by_study(fn, *(a[None] if isinstance(a, Tensor) else a
                             for a in args), stacked=True)
        if isinstance(out, tuple):
            return tuple(None if o is None else o[0] for o in out)
        return out[0]
    parts = [a.unbind(0) if isinstance(a, Tensor) else None for a in args]
    S = len(next(p for p in parts if p is not None))
    outs = [fn(*(a if p is None else p[s] for a, p in zip(args, parts)))
            for s in range(S)]
    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else torch.stack(o)
                     for o in zip(*outs))
    return torch.stack(outs)
