"""Device and dtype resolution for the port's entry points."""
from __future__ import annotations

import contextlib

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or implied) and absent, so a run
    never carries on on the CPU by accident."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def compute_dtype(cfg) -> torch.dtype:
    """`TPU.COMPUTE_DTYPE` as a torch dtype (params stay float32)."""
    return _DTYPES[str(cfg.TPU.COMPUTE_DTYPE)]


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls in full float32, not TF32.

    cuDNN takes float32 convolutions in TF32 by default (about three decimal
    digits); the metrics and the pseudo-LR blur are float32 math in the JAX
    package, so the scoring path holds them to float32. bf16 compute is not
    affected."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
