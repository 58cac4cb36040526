"""PyTorch/CUDA port of the SWIM membership simulator.

The JAX package ``scalecube_cluster_tpu`` is the reference; this package
runs the same protocol round with PyTorch tensors on an NVIDIA H100, with
hand-written CUDA kernels for the merge/timers step (``kernels/merge.py``,
``csrc/merge_timers.cu``) and the compact carry's codec
(``kernels/carry.py``, ``csrc/carry_codec.cu``), and the capability
probes of ``experiments/mosaic_probe.py`` (``kernels/probes.py``,
``csrc/mosaic_probes.cu``, entry ``mosaic_probe.py``).  Module names
follow the reference layout so each piece has an obvious counterpart.

The port imports ``torch``, numpy and the standard library only — never
``jax`` and never the reference package (``tests/test_torch_interop.py``
checks both).  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU.

Slice covered: the focal and full-view round in both delivery modes
(scatter, the default, and shift) with the network model (link rules,
delays and the delay ring, seeded cold starts, user gossips), in the
wide, ``int16_wire``, ``compact_carry`` and ``compact_carry`` +
``wire24`` layouts; the K-tiled full-view capacity round (``k_block``);
per-sender wire counters (``link_counters``); ``node_snapshot``; the
tick-level planes (SYNC anti-entropy, Lifeguard, dead suppression, the
open world, metadata); the composed plane runner (``models/compose.py``)
with the membership event trace (``telemetry/``: ``run_traced``,
``stream_traced_run``, the record kernel ``kernels/trace.py``,
``csrc/trace_record.cu``); ``models/fd.run``; the health-metrics,
invariant-monitor and provenance planes; the gossip-only simulator
(``models/gossip.py``, its own draws ``GossipDraws``); the chaos layer
(``chaos/``: the scenario DSL and its seeded generators, the serial
campaign runner with its journals and the minimizing reducer) and the
whole analytic model (``swim_math.py``).  Not covered: the batched
campaign runner, the oracle cross-validation and multi-GPU
(``models/swim.py`` and ``chaos/campaign.py`` list what raises
``NotImplementedError``).
"""
