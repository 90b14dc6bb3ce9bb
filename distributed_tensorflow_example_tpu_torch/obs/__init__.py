"""The port's copy of the JAX package's ``obs/`` modules that its serving
stack runs on: request-lifecycle spans (``spans``), SLO burn rates and
their federated form (``slo``), per-request latency waterfalls
(``waterfall``), the name registries (``buckets``), the row and document
contracts (``schema``), workload capture and synthesis
(``workload``), the status server (``serve``) and what it reads: the
run report (``aggregate``), heartbeats (``heartbeat``), the fleet
collector (``collector``) and its queueing analytics (``queueing``).
Pure Python: no torch, and nothing of the JAX package."""
