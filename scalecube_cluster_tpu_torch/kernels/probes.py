"""The five capability probes of ``experiments/mosaic_probe.py``: CUDA
kernel wrappers and their plain PyTorch versions.

Each wrapper takes [rows, cols] tensors of any shape.  On CUDA tensors it
launches its kernel in ``csrc/mosaic_probes.cu``; on CPU tensors it runs
the plain version, which the CPU tests hold against the Pallas kernel of
the probe script in interpret mode.  There is no fallback: a CUDA tensor
launches the kernel or raises.

===================  ==================  ==============================
kernel               replaces            computes
===================  ==================  ==============================
``probe_load16``     ``k_load16``        int16 x -> int32 x + 1
``probe_store16``    ``k_store16``       int32 x -> int16 (x + 1) mod 2^16
``probe_cmp16``      ``k_cmp16``         int16 x, y -> int32 (x > y)
``probe_load8``      ``k_load8``         int8 x -> int32 2x
``probe_merge_core`` ``k_merge_core``    the reduced merge gate: int8
                                         status, int32 inc, int32 key,
                                         int8 gate -> int16 status,
                                         int32 inc
===================  ==================  ==============================

``probe_store16`` and ``probe_cmp16`` move 8 elements a thread in
16-byte vector accesses (``VECTORISED``), so their wrappers take only
inputs whose ``data_ptr()`` is 16-byte aligned, as every fresh tensor's
is, and raise ``ValueError`` naming the field for any other (a
contiguous view at an odd offset), on the CPU as on the card.

Two of them are one PyTorch call each, which ``chip_smoke.py`` times
beside the kernel: ``torch.add(x, 1, out=<int16>)`` adds in int32 and
narrows on the store (``probe_store16``), and ``torch.gt(x, y,
out=<int32>)`` stores the compare as int32 (``probe_cmp16``).  The
widening probes take two calls (a ``.to`` and the arithmetic: an add or
multiply with an int32 ``out`` runs in the narrow input type and would
wrap), and the merge core is a dozen.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch.kernels import _build, check_args, launch
from scalecube_cluster_tpu_torch.kernels import on_cpu

SOURCE = "mosaic_probes"
# Kernel name -> (TPU kernel, line of experiments/mosaic_probe.py).
REPLACES = {"probe_load16": ("k_load16", 46),
            "probe_store16": ("k_store16", 50),
            "probe_cmp16": ("k_cmp16", 54),
            "probe_load8": ("k_load8", 59),
            "probe_merge_core": ("k_merge_core", 63)}
NAMES = tuple(REPLACES)
# The kernels in csrc/mosaic_probes.cu that move 16-byte vectors, and
# their design: 8 elements a thread, read-only loads, plain stores.
VECTORISED = {"probe_store16": "vec16B x8", "probe_cmp16": "vec16B x8"}
ALIGN = 16


def load16_reference(x):
    return x.to(torch.int32) + 1


def store16_reference(x):
    return (x + 1).to(torch.int16)


def cmp16_reference(x, y):
    return (x > y).to(torch.int32)


def load8_reference(x):
    return x.to(torch.int32) * 2


def merge_core_reference(status, inc, key, gate):
    status = status.to(torch.int32)
    win_inc = torch.where(key < 0, 0, (key >> 1) & ((1 << 29) - 1))
    win_dead = (key >> 30) & 1
    win_status = torch.where(win_dead == 1, 2,
                             torch.where((key & 1) == 1, 1, 0))
    win_status = torch.where(key < 0, 3, win_status).to(torch.int32)
    accepts = (win_inc > inc) | ((win_inc == inc) & (win_status > status))
    accepts = accepts & (gate.to(torch.int32) > 0)
    return (torch.where(accepts, win_status, status).to(torch.int16),
            torch.where(accepts, win_inc, inc).to(torch.int32))


@functools.lru_cache(maxsize=None)
def _launcher(name: str, n_in: int, n_out: int):
    fn = getattr(_build.load(SOURCE), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * (n_in + n_out) + [ctypes.c_longlong]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_aligned(name, inputs):
    for field, t, _ in inputs:
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {field} must start on a {ALIGN}-byte "
                             f"boundary for the kernel's vector accesses "
                             f"(data_ptr() % {ALIGN} == "
                             f"{t.data_ptr() % ALIGN})")


def _probe(name, reference, inputs, out_dtypes):
    """Check ``inputs`` (``(field, tensor, dtype)``), then run the plain
    version on the CPU or launch the kernel on CUDA."""
    first = inputs[0][1]
    check_args(name, first.device, tuple(first.shape),
               {field: (t, dtype) for field, t, dtype in inputs})
    tensors = [t for _, t, _ in inputs]
    if name in VECTORISED:
        _check_aligned(name, inputs)
    if on_cpu(name, first.device):
        return reference(*tensors)
    outs = tuple(torch.empty(first.shape, dtype=d, device=first.device)
                 for d in out_dtypes)
    fn = _launcher(name, len(tensors), len(outs))
    args = [t.data_ptr() for t in tensors + list(outs)] + [first.numel()]
    launch(name, fn, first.device, *args)
    return outs if len(outs) > 1 else outs[0]


def load16(x):
    """int16 -> int32, plus one."""
    return _probe("probe_load16", load16_reference,
                  [("x", x, torch.int16)], (torch.int32,))


def store16(x):
    """int32 plus one (wrapping), stored as int16 (low 16 bits)."""
    return _probe("probe_store16", store16_reference,
                  [("x", x, torch.int32)], (torch.int16,))


def cmp16(x, y):
    """int16 ``x > y`` as int32 0/1."""
    return _probe("probe_cmp16", cmp16_reference,
                  [("x", x, torch.int16), ("y", y, torch.int16)],
                  (torch.int32,))


def load8(x):
    """int8 -> int32, times two."""
    return _probe("probe_load8", load8_reference,
                  [("x", x, torch.int8)], (torch.int32,))


def merge_core(status, inc, key, gate):
    """The reduced merge gate (no ABSENT opener, no DEAD gate): returns
    ``(status int16, inc int32)``."""
    return _probe("probe_merge_core", merge_core_reference,
                  [("status", status, torch.int8), ("inc", inc, torch.int32),
                   ("key", key, torch.int32), ("gate", gate, torch.int8)],
                  (torch.int16, torch.int32))


PROBES = {"probe_load16": load16, "probe_store16": store16,
          "probe_cmp16": cmp16, "probe_load8": load8,
          "probe_merge_core": merge_core}
REFERENCES = {"probe_load16": load16_reference,
              "probe_store16": store16_reference,
              "probe_cmp16": cmp16_reference,
              "probe_load8": load8_reference,
              "probe_merge_core": merge_core_reference}
