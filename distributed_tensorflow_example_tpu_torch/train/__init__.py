"""The port's training stack: optimizers (``optim``), the train state
(``state``) and the training loop (``loop.run``)."""
