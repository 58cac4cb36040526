"""The provenance plane: which channel delivered the evidence for each
belief.

Counterpart of ``scalecube_cluster_tpu/models/provenance.py``.  For every
(observer, subject) status transition of a round the plane names the
channel whose folded key won it:

  CH_FD_DIRECT        the observer's own failure detector: a direct-probe
                      timeout (SUSPECT) or its suspicion timer (DEAD)
  CH_PINGREQ_PROXY    the FD verdict after the direct probe failed and
                      ping-req proxies were launched
  CH_GOSSIP           a piggybacked record on the gossip fan-out
  CH_SYNC             a SYNC exchange: the periodic push, a refutation
                      push, the anti-entropy pair, the joiner <-> seed
                      round trip
  CH_SELF_REFUTATION  the observer is the subject and bumped its own
                      incarnation
  CH_JOIN_REBIRTH     the subject was admitted into its slot this round

With ``SwimParams.provenance`` on, every tick body exposes its
per-channel folded maxima ``dict(fd=, gossip=, sync=, ping_req=)`` beside
the combined inbox (``models/swim.py``), which the composed runner hands
the plane as ``RoundCtx.provenance``; the states and metrics are those of
the knob off.  :func:`attribute_channels` is the reference's total
where-cascade, most specific test last: join-rebirth, then a removal no
DEAD wire key explains (the local timer: FD), then FD on a winner tie
(direct or proxy by the row's ping-req flag, with proxies configured),
SYNC on a tie, GOSSIP, FD as the base.

The rows ``(observer, subject, epoch, transition, channel, round)`` land
in a fixed-capacity buffer with exact ``count`` and ``dropped``
(:class:`ProvenanceState`), journaled as the ``provenance`` record kind
(``telemetry/sink.py``) and mined by the blame engine
(``telemetry/query.py``).  On the card a round is one
``kernels/provenance.provenance_observe`` launch (the codes, the cascade,
the self-refutation overlay and the record in one pass, nothing read back
to the host); on CPU tensors its plain version, the composition of
:func:`round_channel_records` and :func:`record_attributions`.  The
reference's ``lax.cond`` gates (the event predicate, its fast record
path) skip work whose rows are the same, so the port runs neither.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from scalecube_cluster_tpu_torch.kernels import provenance as kprov
from scalecube_cluster_tpu_torch.kernels import trace as trace_kernel
from scalecube_cluster_tpu_torch.telemetry import trace as ttrace
from scalecube_cluster_tpu_torch.telemetry.events import TraceEventType

# Channel codes, in cascade-priority order (decode_attributions and the
# blame engine name them through CHANNEL_NAMES).
CH_FD_DIRECT = kprov.CH_FD_DIRECT
CH_PINGREQ_PROXY = kprov.CH_PINGREQ_PROXY
CH_GOSSIP = kprov.CH_GOSSIP
CH_SYNC = kprov.CH_SYNC
CH_SELF_REFUTATION = kprov.CH_SELF_REFUTATION
CH_JOIN_REBIRTH = kprov.CH_JOIN_REBIRTH

CHANNEL_NAMES = ("fd_direct", "pingreq_proxy", "gossip", "sync",
                 "self_refutation", "join_rebirth")

# (observer, subject, epoch, transition, channel, round) per record.
_N_LANES = kprov.N_LANES

# A transition emits at most one record per cell a round, as the event
# trace does: 65,536 rows x 6 lanes x 4 B = 1.5 MB.
DEFAULT_CAPACITY = 1 << 16

#: The reference's fast-path window (a round with at most this many rows
#: written as one block); the port has one record path, whose rows and
#: accounting are the reference's both paths'.
COMPACT_WINDOW = 256


# --------------------------------------------------------------------------
# Carried state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ProvenanceState:
    """The attribution buffer: ``lanes[i] = (observer, subject, epoch,
    transition, channel, round)`` for i < ``count`` ([capacity, 6] int32,
    -1 past it), in (round, observer-major cell) order; ``dropped``
    counts the rows lost to overflow, so the buffer is an exact prefix of
    the stream.  ``count``/``dropped`` are 0-dim int32 device tensors."""

    lanes: torch.Tensor
    count: torch.Tensor
    dropped: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.lanes.shape[0]

    @staticmethod
    def empty(capacity: int = DEFAULT_CAPACITY,
              device="cpu") -> "ProvenanceState":
        return ProvenanceState(
            lanes=torch.full((capacity, _N_LANES), -1, dtype=torch.int32,
                             device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            dropped=torch.zeros((), dtype=torch.int32, device=device))

    def clone(self) -> "ProvenanceState":
        return ProvenanceState(lanes=self.lanes.clone(),
                               count=self.count.clone(),
                               dropped=self.dropped.clone())


# --------------------------------------------------------------------------
# The attribution cascade and the record (plain PyTorch)
# --------------------------------------------------------------------------


def attribute_channels(params, prov: dict, codes, join_now):
    """[N, K] int8 channel code per cell (the module docstring's cascade).
    ``prov`` is the tick's exposure (``fd``/``gossip``/``sync`` [N, K]
    wire keys, ``ping_req`` [N] bool); ``codes`` the round's transition
    codes (cells without one get a channel that no row reads);
    ``join_now`` [N, K] (or [1, K]) bool marks subjects admitted this
    round."""
    return kprov.channel_cascade(
        prov["fd"], prov["gossip"], prov["sync"],
        prov["ping_req"] if params.ping_req_members > 0 else None, codes,
        join_now, params.wire_format.dead_bit)


def round_channel_records(rc):
    """``(codes, channels, epochs)`` of one round's attributed
    transitions: ``codes`` [N, K] int8 (0 = none, else ``TraceEventType``
    + 1, the trace's derivation) with the self-refutation overlay (the
    code-0 self cell of a row whose ``self_inc`` rose becomes
    ALIVE_REFUTED at CH_SELF_REFUTATION), ``channels`` int8, ``epochs``
    int32 the cell's identity epoch after the round (0 with the
    open-world lane off)."""
    prev_epoch = rc.prev.epoch if rc.params.epoch_bits else None
    codes, _ = ttrace.round_transition_codes(
        rc.round_idx, rc.prev.status, rc.prev.inc, rc.new, rc.world,
        observer_offset=rc.offset, prev_epoch=prev_epoch)
    n = rc.prev.status.shape[0]
    subject_ids = rc.world.subject_ids
    join_now = (rc.world.join_at[subject_ids.long()] == rc.round_idx)[None, :]
    channels = attribute_channels(rc.params, rc.provenance, codes, join_now)
    refuted = rc.new.self_inc.to(torch.int32) > rc.prev.self_inc.to(
        torch.int32)
    is_self = trace_kernel.self_mask(subject_ids, n, rc.offset)
    self_refute = is_self & refuted[:, None] & (codes == 0)
    codes = codes.masked_fill(self_refute,
                              int(TraceEventType.ALIVE_REFUTED) + 1)
    channels = channels.masked_fill(self_refute, CH_SELF_REFUTATION)
    if rc.params.epoch_bits:
        epochs = rc.new.epoch.to(torch.int32)
    else:
        epochs = torch.zeros(codes.shape, dtype=torch.int32,
                             device=codes.device)
    return codes, channels, epochs


def record_attributions(pv: ProvenanceState, round_idx: int, codes,
                        channels, epochs, subject_ids,
                        observer_offset: int = 0) -> ProvenanceState:
    """Compact one round's attributed cells (``codes > 0``) into ``pv``,
    in place (returned for the reference's call shape): cell order, the
    slots ``count + e``, ``count`` capped at the capacity and the rest
    counted in ``dropped``.  The plain composition (eager PyTorch, any
    device); the plane's round on the card is :func:`observe_round`'s one
    kernel launch."""
    kprov.provenance_record_reference(
        pv.lanes, pv.count, pv.dropped, codes, channels, epochs,
        subject_ids.to(torch.int32), round_idx, observer_offset)
    return pv


def observe_round(pv: ProvenanceState, rc, is_self=None) -> ProvenanceState:
    """One round's provenance update, in place: derive, attribute and
    record as one ``kernels/provenance.provenance_observe`` call under the
    profiler range ``provenance.observe``.  ``is_self`` (the [N, K] self
    mask) serves the plain version on CPU tensors."""
    if rc.provenance is None:
        raise ValueError(
            "the provenance plane needs the tick's per-channel exposure: "
            "set SwimParams.provenance=True (the knob arms the maxima "
            "the attribution cascade reads)")
    prov, params = rc.provenance, rc.params
    n = rc.prev.status.shape[0]
    prev_epoch = rc.prev.epoch if params.epoch_bits else None
    with record_function("provenance.observe"):
        kprov.provenance_observe(
            pv.lanes, pv.count, pv.dropped, rc.prev.status, rc.new.status,
            prov["fd"], prov["gossip"], prov["sync"], prov["ping_req"],
            rc.prev.self_inc, rc.new.self_inc,
            rc.world.leave_at[rc.offset:rc.offset + n], rc.world.join_at,
            rc.world.subject_ids, rc.round_idx, rc.offset,
            dead_bit=params.wire_format.dead_bit,
            split_ping_req=params.ping_req_members > 0,
            prev_epoch=prev_epoch,
            new_epoch=rc.new.epoch if params.epoch_bits else None,
            is_self=is_self)
    return pv


# --------------------------------------------------------------------------
# The compose plane
# --------------------------------------------------------------------------


class ProvenancePlane:
    """Channel attribution as a plane of ``models/compose``: its slice is
    a :class:`ProvenanceState`, its round hook :func:`observe_round` on
    the shared round context's exposure.  ``state`` resumes a buffer
    across chunked runs (cloned once, then updated in place)."""

    name = "provenance"

    def __init__(self, capacity: int = DEFAULT_CAPACITY, state=None):
        self.capacity = capacity
        self.state = state
        self._is_self = None

    def init(self, params, world):
        if not params.provenance:
            raise ValueError(
                "ProvenancePlane requires SwimParams.provenance=True: "
                "with the knob off the tick bodies compile the "
                "per-channel exposure out and there is nothing to "
                "attribute")
        # Only the plain version reads the [N, K] self mask.
        self._is_self = (trace_kernel.self_mask(world.subject_ids,
                                                params.n_members)
                         if world.device.type == "cpu" else None)
        if self.state is None:
            return ProvenanceState.empty(self.capacity, device=world.device)
        if tuple(self.state.lanes.shape[1:]) != (_N_LANES,):
            raise ValueError(f"provenance lanes are "
                             f"{tuple(self.state.lanes.shape)}, expected "
                             f"[capacity, {_N_LANES}]")
        if self.state.lanes.device != world.device:
            raise ValueError(f"provenance state is on "
                             f"{self.state.lanes.device}, the world on "
                             f"{world.device}")
        return self.state.clone()

    def on_round(self, rc, pv):
        return observe_round(pv, rc, is_self=self._is_self)

    def finalize(self, fc, pv):
        return pv


# --------------------------------------------------------------------------
# Host-side decoding
# --------------------------------------------------------------------------


def decode_attributions(pv: ProvenanceState) -> list:
    """The buffer as plain-dict rows (host side), the exact recorded
    prefix in (round, observer-major cell) order; ``transition`` the
    ``TraceEventType`` name, ``channel`` the :data:`CHANNEL_NAMES` entry
    (the journal's and the blame engine's spelling)."""
    count = int(pv.count)
    out = []
    for obs, subj, epoch, code, chan, rnd in pv.lanes[:count].cpu().tolist():
        out.append(dict(observer=obs, subject=subj, epoch=epoch,
                        transition=TraceEventType(code).name,
                        channel=CHANNEL_NAMES[chan], round=rnd))
    return out


def attributions_payload(pv: ProvenanceState) -> dict:
    """The journal payload of the ``provenance`` record kind
    (``telemetry/sink.TelemetrySink.write_provenance``): the decoded rows
    and the buffer's exact accounting."""
    return dict(rows=decode_attributions(pv), recorded=int(pv.count),
                dropped=int(pv.dropped), capacity=int(pv.capacity))
