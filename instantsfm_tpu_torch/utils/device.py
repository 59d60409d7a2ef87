"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and never fall back to the CPU
on their own: without a card they raise, and the caller asks for the CPU with
``device="cpu"``.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "instantsfm_tpu_torch: device='cuda' requested but no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev


def check_on_device(device, tensor: torch.Tensor) -> torch.device:
    """Resolve ``device`` and require ``tensor`` to live there."""
    dev = resolve_device(device)
    if tensor.device.type != dev.type or (
            dev.index is not None and tensor.device.index != dev.index):
        raise ValueError(f"inputs live on {tensor.device} but device={dev}; "
                         "move them with convert.from_numpy or .to()")
    return dev


@contextlib.contextmanager
def full_f32():
    """Full float32 in cuDNN convolutions and cuBLAS products inside the
    block, whatever the caller set: both may otherwise run in TF32 (about
    three decimal digits; cuDNN does by default).  The flags are restored
    on exit."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
