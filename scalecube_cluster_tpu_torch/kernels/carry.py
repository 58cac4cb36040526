"""The compact carry's codec: CUDA kernel wrappers and their plain
PyTorch versions.

Under ``compact_carry`` the state between rounds stores ``inc`` as int16,
``spread_until`` as int8 and ``suspect_deadline`` as int16, the last two
as rounds remaining from the next round (``DEADLINE_NONE16`` = no timer,
negative = a stale deadline of a frozen row).  :func:`carry_decode`
widens them to absolute int32 rounds at the start of a round
(``scalecube_cluster_tpu/models/swim._carry_decode``);
:func:`carry_encode` narrows them at its end (``_carry_encode``).  The
reference computes both as XLA fusions; on CUDA tensors each is one
launch of ``csrc/carry_codec.cu``, on CPU tensors the plain version
below runs.  There is no fallback: a CUDA tensor launches the kernel or
raises.

Block form (the K-tiled capacity round, ``SwimParams.k_block``): each
side's three planes may be an [N, Kb] column block of the [N, K] carry,
given as views with contiguous rows that share one row stride
(``plane[:, c0:c0 + kb]``); ``out`` names the views the results go to
(decode: the round's contiguous wide block; encode: the output carry's
columns).

No single PyTorch library call computes either function, so the kernels
have no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch.kernels import _build, check_block_args, i32
from scalecube_cluster_tpu_torch.kernels import launch, on_cpu

SOURCE = "carry_codec"
DECODE = "carry_decode"
ENCODE = "carry_encode"
INT32_MAX = 2**31 - 1
DEADLINE_NONE16 = 32767


def carry_decode_reference(inc, spread_until, suspect_deadline,
                           round_idx: int):
    """Plain version of :func:`carry_decode`."""
    r = i32(round_idx)
    dl = suspect_deadline.to(torch.int32)
    return (inc.to(torch.int32),
            spread_until.to(torch.int32) + r,
            torch.where(dl == DEADLINE_NONE16, INT32_MAX, dl + r))


def carry_encode_reference(inc, spread_until, suspect_deadline,
                           round_idx: int, inc_sat: int):
    """Plain version of :func:`carry_encode`."""
    nxt = i32(round_idx + 1)
    remaining = suspect_deadline - nxt
    far = (suspect_deadline == INT32_MAX) | (remaining > DEADLINE_NONE16 - 1)
    return (torch.clamp(inc, max=inc_sat).to(torch.int16),
            torch.clamp(spread_until - nxt, 0, 127).to(torch.int8),
            torch.where(far, DEADLINE_NONE16,
                        torch.clamp(remaining, -(DEADLINE_NONE16 - 1),
                                    DEADLINE_NONE16 - 1)).to(torch.int16))


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str):
    fn = getattr(_build.load(SOURCE), symbol)
    n_ints = 2 if symbol == "carry_encode_launch" else 1
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong]
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _row_stride(name, side, planes, shape, device):
    """The one row stride of a side's three ``(field, view, dtype)``
    planes; raises unless they are block views of ``shape`` on ``device``
    sharing it."""
    strides = check_block_args(name, device, shape, {
        field: (t, dtype) for field, t, dtype in planes})
    if len(set(strides)) != 1:
        raise ValueError(f"{name}: the {side} planes' row strides differ "
                         f"{strides}")
    return strides[0]


def _run(name, planes, out_dtypes, out, reference, scalars):
    """Check both sides, then launch the kernel (CUDA) or run
    ``reference`` (CPU) into ``out`` (fresh contiguous planes if None)."""
    first = planes[0][1]
    fresh = out is None
    if fresh:
        out = tuple(torch.empty(first.shape, dtype=d, device=first.device)
                    for d in out_dtypes)
    shape = tuple(first.shape)
    ld_in = _row_stride(name, "input", planes, shape, first.device)
    ld_out = _row_stride(name, "output", [
        (f"out[{i}]", t, d) for i, (t, d) in enumerate(zip(out, out_dtypes))],
        shape, first.device)
    if on_cpu(name, first.device):
        got = reference(*(t for _, t, _ in planes), *scalars)
        if fresh:
            return got
        for view, value in zip(out, got):
            view.copy_(value)
        return out
    rows, cols = first.shape
    launch(name, _launcher(f"{name}_launch"), first.device,
           *(t.data_ptr() for _, t, _ in planes),
           *(t.data_ptr() for t in out), rows, cols, ld_in, ld_out,
           *(i32(s) for s in scalars))
    return out


def carry_decode(inc, spread_until, suspect_deadline, round_idx: int,
                 out=None):
    """compact -> wide at ``round_idx``: int16 ``inc``, int8
    ``spread_until``, int16 ``suspect_deadline`` [N, Kb] -> the three
    int32 planes (absolute rounds; the sentinel becomes INT32_MAX), into
    ``out`` when given."""
    planes = (("inc", inc, torch.int16),
              ("spread_until", spread_until, torch.int8),
              ("suspect_deadline", suspect_deadline, torch.int16))
    return _run(DECODE, planes, (torch.int32,) * 3, out,
                carry_decode_reference, (round_idx,))


def carry_encode(inc, spread_until, suspect_deadline, round_idx: int,
                 inc_sat: int, out=None):
    """wide -> compact, relative to round ``round_idx + 1``: int32 [N, Kb]
    planes -> int16 ``inc`` (clamped at ``inc_sat``), int8
    ``spread_until``, int16 ``suspect_deadline``, into ``out`` when
    given."""
    planes = (("inc", inc, torch.int32),
              ("spread_until", spread_until, torch.int32),
              ("suspect_deadline", suspect_deadline, torch.int32))
    return _run(ENCODE, planes, (torch.int16, torch.int8, torch.int16), out,
                carry_encode_reference, (round_idx, inc_sat))
