"""The port's copy of the JAX package's resilience package:
preemption-surviving training.

- ``codec``/``manifest`` — the content-addressed incremental snapshot
  store: every leaf persists as an ``objects/`` payload named by its
  content digest, so a leaf unchanged since the previous snapshot is
  never rewritten; a root manifest written last (atomic tmp+rename)
  makes a snapshot visible only once durable, and a torn newest
  snapshot falls back to the previous valid one.  The layout is the
  JAX package's, so either package restores the other's store;
- ``writer`` — ``CheckpointWriter``, the write-behind thread: the train
  thread hands over a host snapshot and the thread encodes, hashes,
  writes and prunes (keep-last-K);
- ``signals`` — ``PreemptionHandler``: the chained SIGTERM/SIGINT
  handler; the train loop drains the writer and lands one last
  consistent snapshot before it exits through ``Preempted``;
- ``resume`` — exact-step auto-resume (``--resume=auto``): the newest
  valid manifest and the recorded data position (epoch and in-epoch
  batch skip), bitwise an uninterrupted run;
- ``restart`` — ``RestartPolicy``/``Supervisor`` and the restart
  narrator (``restarts.jsonl``).

Re-exports resolve lazily (PEP 562).  Nothing here imports the JAX
package; ``restart`` is pure Python, the rest numpy and torch on the
host.
"""

_EXPORTS = {
    "encode_array": "codec",
    "decode_array": "codec",
    "bit_container_dtype": "codec",
    "newest_valid_snapshot": "manifest",
    "list_snapshots": "manifest",
    "prune_snapshots": "manifest",
    "restore_arrays": "manifest",
    "snapshot_valid": "manifest",
    "persist_snapshot": "manifest",
    "CheckpointWriter": "writer",
    "PreemptionHandler": "signals",
    "Preempted": "signals",
    "ResumePlan": "resume",
    "auto_resume": "resume",
    "skip_batches": "resume",
    "RestartPolicy": "restart",
    "RestartDecision": "restart",
    "RestartNarrator": "restart",
    "Supervisor": "restart",
    "dead_procs": "restart",
    "backoff_s": "restart",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        mod = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
