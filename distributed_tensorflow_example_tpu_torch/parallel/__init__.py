"""The port's parallel strategies over the ``('data', 'model')`` mesh
(``mesh``: rank r plays device r of JAX's one-process mesh; the data and
model groups; the Megatron operators): the synchronous step and the eval
(``step``), ZeRO-1 (``zero``), FSDP (``fsdp``), multi-site local SGD over
the ``('site', 'data')`` layout (``local_sgd``), sequence parallelism
over the ``('data', 'seq'[, 'model'])`` layout (``mesh.build_seq_mesh``,
its rotation and exchange; the attention in ``ops/ring_attention`` and
``ops/ulysses_attention``), expert parallelism over the ``('data',
'expert'[, 'model'])`` layout (``mesh.build_expert_mesh``, its exchange
and sums; the dispatch in ``models/transformer``), and the
device-resident epoch (``epoch``), the trainer's default fast path."""
