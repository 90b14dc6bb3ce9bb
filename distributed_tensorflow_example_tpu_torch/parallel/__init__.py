"""The synchronous data-parallel step of the port (``step``): gradients
all-reduced with ``torch.distributed`` across processes; and the
device-resident epoch (``epoch``), the trainer's default fast path."""
