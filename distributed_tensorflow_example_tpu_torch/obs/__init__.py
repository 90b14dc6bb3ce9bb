"""The port's copy of the JAX package's ``obs/`` modules that its serving
stack runs on: request-lifecycle spans (``spans``), SLO burn rates and
their federated form (``slo``), per-request latency waterfalls
(``waterfall``), the name registries (``buckets``), the row and document
contracts (``schema``), workload capture and synthesis
(``workload``), the status server (``serve``) and what it reads: the
run report (``aggregate``), heartbeats (``heartbeat``), the fleet
collector (``collector``) and its queueing analytics (``queueing``);
and the trainer's monitoring: the metrics stream (``metrics``), FLOPs
and MFU (``flops``), the anomaly policy (``anomaly``), the flight
recorder (``flight``) and the windowed profiler (``tracer``); and the
operator's read side, ``dtx-obs`` (``cli``, run as ``python -m
distributed_tensorflow_example_tpu_torch.obs.cli``) over the A/B gate
(``compare``), the bench history (``history``), change-point detection
(``drift``) and the capacity forecast (``capacity``).  Nothing of the
JAX package; ``flops``, ``metrics``, ``flight`` and ``tracer``
read torch for the card's name, memory and profiler."""
