"""Device resolution and float32 precision for the port.

The port's entry points run on the card by default: ``device=None`` means
``cuda``, and with no CUDA device that raises instead of carrying on on the
CPU. The CPU runs only when a caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DeviceError", "is_device_failure", "resolve_device", "set_float32_precision"]

DeviceLike = Optional[Union[str, torch.device]]


class DeviceError(RuntimeError):
    """A failure of the card, of its toolchain or of a kernel of the port:
    no card where one was asked for, ``nvcc`` missing or failing, a kernel
    launch returning an error."""


_CUDA_MESSAGES = ("CUDA error", "CUDA driver error", "CUBLAS_STATUS", "cuDNN error", "CUDNN_STATUS")


def is_device_failure(exc: BaseException) -> bool:
    """True for a ``DeviceError``, a CUDA out-of-memory or accelerator
    error, and a ``RuntimeError`` carrying a CUDA, cuBLAS or cuDNN error
    message: the failures that a search must not prune as a bad trial."""
    accelerator = getattr(torch, "AcceleratorError", None)
    if isinstance(exc, (DeviceError, torch.cuda.OutOfMemoryError)) or (
            accelerator is not None and isinstance(exc, accelerator)):
        return True
    return isinstance(exc, RuntimeError) and any(m in str(exc) for m in _CUDA_MESSAGES)


def set_float32_precision() -> None:
    """Full float32 for f32 matmuls and convolutions on the card.

    PyTorch's defaults differ between the two: f32 matmuls run in full f32
    (``cuda.matmul.allow_tf32`` False), but cuDNN runs f32 convolutions in
    TF32 (``cudnn.allow_tf32`` True), which keeps about three decimal digits
    and would change the conv stack's f32 numerics against the reference.
    Both are set here, explicitly, for the whole process; ``build_model``
    calls this for a model on the card. bf16 compute is unaffected.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default, ``cpu`` only when asked; raises without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
