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

No single PyTorch library call computes either function, so the kernels
have no library yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from scalecube_cluster_tpu_torch.kernels import _build, check_args, i32
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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, planes):
    first = planes[0][1]
    check_args(name, first.device, tuple(first.shape), dict(
        (field, (t, dtype)) for field, t, dtype in planes))
    return on_cpu(name, first.device)


def _launch(name, planes, out_dtypes, *scalars):
    first = planes[0][1]
    outs = tuple(torch.empty(first.shape, dtype=d, device=first.device)
                 for d in out_dtypes)
    launch(name, _launcher(f"{name}_launch"), first.device,
           *(t.data_ptr() for _, t, _ in planes),
           *(t.data_ptr() for t in outs), first.numel(),
           *(i32(s) for s in scalars))
    return outs


def carry_decode(inc, spread_until, suspect_deadline, round_idx: int):
    """compact -> wide at ``round_idx``: int16 ``inc``, int8
    ``spread_until``, int16 ``suspect_deadline`` [N, K] -> the three
    int32 planes (absolute rounds; the sentinel becomes INT32_MAX)."""
    planes = (("inc", inc, torch.int16),
              ("spread_until", spread_until, torch.int8),
              ("suspect_deadline", suspect_deadline, torch.int16))
    if _check(DECODE, planes):
        return carry_decode_reference(inc, spread_until, suspect_deadline,
                                      round_idx)
    return _launch(DECODE, planes, (torch.int32,) * 3, round_idx)


def carry_encode(inc, spread_until, suspect_deadline, round_idx: int,
                 inc_sat: int):
    """wide -> compact, relative to round ``round_idx + 1``: int32 [N, K]
    planes -> int16 ``inc`` (clamped at ``inc_sat``), int8
    ``spread_until``, int16 ``suspect_deadline``."""
    planes = (("inc", inc, torch.int32),
              ("spread_until", spread_until, torch.int32),
              ("suspect_deadline", suspect_deadline, torch.int32))
    if _check(ENCODE, planes):
        return carry_encode_reference(inc, spread_until, suspect_deadline,
                                      round_idx, inc_sat)
    return _launch(ENCODE, planes, (torch.int16, torch.int8, torch.int16),
                   round_idx, inc_sat)
