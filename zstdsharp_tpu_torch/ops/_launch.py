"""Operand checks and stream lookup shared by the kernel wrappers."""

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


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    if device.type != "cuda":
        raise ValueError(f"no CUDA kernel for tensors on {device}")
    return torch.cuda.current_stream(device).cuda_stream


def check_rc(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError_t {rc})")


def launch(kernel: str, device: torch.device, fn, *args) -> None:
    """Call the C launcher `fn(*args, stream)` into PyTorch's current
    stream on `device`, with `device` the calling thread's current CUDA
    device, and raise on a nonzero cudaError_t.  A launcher acts on the
    current device (``cudaFuncSetAttribute``, the launch itself), and a
    thread starts on cuda:0, so without the guard a worker thread's launch
    into another card's stream fails."""
    stream = stream_handle(device)
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    check_rc(kernel, rc)
