"""Run logging and profiling hooks for long runs.

Counterpart of ``scalecube_cluster_tpu/utils/runlog.py``.  A dense
many-round run cannot log each protocol action from inside the round;
the observability here is:

  - a stdlib logger (:func:`get_logger`) for host-side progress: chunk
    boundaries, checkpoint writes, device info;
  - :func:`log_metrics_summary`, which digests a run's per-round metric
    tensors (``models/swim.run``'s metrics) into the protocol-level
    counters a deployed member logs;
  - :func:`profiled`, which wraps a run in ``torch.profiler`` when
    ``SCALECUBE_TPU_PROFILE_DIR`` is set (the reference's variable; the
    trace lands there as a Chrome trace, readable by TensorBoard's
    profiler plugin).

The reference's ``completion_barrier`` and ``enable_compilation_cache``
work around its compiler and platform and have no counterpart here
(``torch.cuda.synchronize`` is the port's barrier).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

import numpy as np

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"

#: The environment variable that turns :func:`profiled` on.
PROFILE_DIR_ENV = "SCALECUBE_TPU_PROFILE_DIR"


def get_logger(name: str = "scalecube_tpu", level=None) -> logging.Logger:
    """Package logger; level from ``SCALECUBE_TPU_LOGLEVEL`` (default
    INFO).  The resolved level applies on every call (an explicit
    ``level`` wins over the variable); ``level`` may be a logging
    constant (0 == NOTSET included) or a name like ``"DEBUG"``."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    if level is None:
        level = os.environ.get("SCALECUBE_TPU_LOGLEVEL", "INFO")
    logger.setLevel(level)
    return logger


def _host(x) -> np.ndarray:
    """A metric trace as a numpy array (a tensor is copied to the host)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def log_metrics_summary(log: logging.Logger, metrics: dict,
                        round_offset: int = 0) -> None:
    """Log one line digesting ``metrics`` (the [n_rounds, ...] traces of
    ``models/swim.run``): pings, ping-req fan-outs, probe verdicts,
    gossip messages, refutations and false-positive observer-rounds over
    rounds [round_offset, round_offset + n_rounds).  An empty dict logs
    a "no metrics" line (a zero-round chunk is a valid input)."""
    if not metrics:
        log.info("rounds starting at %d: no metrics to summarize",
                 round_offset)
        return
    n_rounds = len(_host(next(iter(metrics.values()))))
    last = round_offset + n_rounds - 1

    def total(name):
        return int(_host(metrics[name]).sum()) if name in metrics else 0

    log.info(
        "rounds [%d, %d]: pings sent %d (+%d ping-req fan-outs), "
        "tracked-subject probe verdicts %d, gossip msgs %d, "
        "refutations %d, false-positive observer-rounds %d",
        round_offset, last, total("messages_ping_sent"),
        total("messages_ping_req_sent"), total("messages_ping"),
        total("messages_gossip"), total("refutations"),
        total("false_positives"),
    )


@contextlib.contextmanager
def profiled(log: logging.Logger = None):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card
    is present) into ``$SCALECUBE_TPU_PROFILE_DIR`` when it is set, else
    nothing; logs the block's seconds when ``log`` is given."""
    trace_dir = os.environ.get(PROFILE_DIR_ENV)
    t0 = time.perf_counter()
    if not trace_dir:
        yield
    else:
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(trace_dir)):
            yield
        if log is not None:
            log.info("profiler trace written to %s", trace_dir)
    if log is not None:
        log.info("profiled section took %.2fs", time.perf_counter() - t0)
