"""Operand checks and the launch path shared by the kernel wrappers."""

from __future__ import annotations

import torch


def check_operand(name: str, t: torch.Tensor, shape: tuple,
                  device: torch.device, dtype=torch.int32) -> None:
    """Raise unless t is a contiguous tensor of `dtype` and `shape` on
    `device` (a None entry in `shape` accepts any positive size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != len(shape) or any(
            (s is None and d < 1) or (s is not None and d != s)
            for d, s in zip(t.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def resolve_device(device) -> torch.device:
    """`device` (a torch device or its name) as a torch.device, a CUDA
    device without an index as the current card.  A CUDA device without
    a card raises here, so that an entry point called with its default
    never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_flag(name: str, value) -> None:
    """Raise TypeError where a device was passed in the place of the flag
    `name`: the entry points take the reference's parameters in its order
    and the device only as the keyword ``device=``."""
    if isinstance(value, (str, torch.device)):
        raise TypeError(f"{name}={value!r}: pass the device as the keyword "
                        "device=, not by position")


def check_cuda(device: torch.device) -> None:
    """Raise unless `device` is a CUDA device: the kernels have no other."""
    if device.type != "cuda":
        raise ValueError(f"no CUDA kernel for tensors on {device}")


def check_rc(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError_t {rc})")


def launch(kernel: str, device: torch.device, fn, *args) -> None:
    """Call the C launcher `fn(*args, stream)` into PyTorch's current
    stream on `device` (a tensor's CUDA device, so it has an index), and
    raise on a nonzero cudaError_t.  A launcher acts on the calling
    thread's current device (``cudaFuncSetAttribute``, the launch itself),
    and a thread starts on cuda:0, so when `device` is another card the
    call runs with `device` made current.  The stream handle is looked up
    once, and the device switched only when it differs."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    check_rc(kernel, rc)
