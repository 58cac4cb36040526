"""Hand-written CUDA kernels of the port, their launch counts, and the
checks every wrapper shares.

Each wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches
its kernel and nowhere else (its plain-PyTorch version, taken for CPU
tensors, does not count), so a run can show that its main path went
through the kernels: clear the counter, drive the path, read it.
"""

import collections
from typing import Mapping, Tuple

import torch

LAUNCHES: "collections.Counter[str]" = collections.Counter()


def i32(x: int) -> int:
    """Python int -> int32 with two's-complement wrap (the reference's
    traced int32 round arithmetic)."""
    return ((int(x) + 2**31) % 2**32) - 2**31


def check_args(kernel: str, device: torch.device, shape: Tuple[int, ...],
               tensors: Mapping[str, Tuple[torch.Tensor, torch.dtype]]):
    """Raise unless every ``name: (tensor, dtype)`` lies on ``device``,
    has ``dtype`` and ``shape``, and is contiguous."""
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def check_block_args(kernel: str, device: torch.device,
                     shape: Tuple[int, int],
                     tensors: Mapping[str, Tuple[torch.Tensor, torch.dtype]]
                     ) -> Tuple[int, ...]:
    """Raise unless every ``name: (tensor, dtype)`` is a 2-D view of
    ``shape`` on ``device`` with ``dtype`` whose rows are contiguous (last
    dim of stride 1, row stride at least the row's length) and which lies
    inside its storage, e.g. a column block ``plane[:, c0:c0 + kb]`` of a
    contiguous plane.  Returns each view's row stride in elements."""
    strides = []
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
        rows, cols = shape
        ld = t.stride(0) if rows > 1 else cols
        if (cols > 1 and t.stride(1) != 1) or ld < cols:
            raise ValueError(f"{kernel}: {name} must have contiguous rows "
                             f"(strides {t.stride()})")
        end = t.storage_offset() + (rows - 1) * ld + cols
        if rows * cols and end * t.element_size() > \
                t.untyped_storage().nbytes():
            raise ValueError(f"{kernel}: {name} reaches past its storage")
        strides.append(ld)
    return tuple(strides)


def on_cpu(kernel: str, device: torch.device) -> bool:
    """True for CPU tensors (the wrapper takes the plain version), False
    for CUDA tensors (it launches the kernel); raises for anything else."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {device}")
    return False


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream, raise on a launch error, and count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES[kernel] += 1
