"""The port's copy of the serving half of the JAX package's ``obs/``:
request-lifecycle spans (``spans``), SLO burn rates (``slo``),
per-request latency waterfalls (``waterfall``), the name registries
(``buckets``), the span and waterfall contracts (``schema``) and the
submit span's prompt fingerprint (``workload``).  Pure Python: no
torch, and nothing of the JAX package."""
