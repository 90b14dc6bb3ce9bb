"""Model families of the port: the MLP (``mlp``, with the activation
table every family shares) and the transformer without experts, for
serving and training (``transformer``)."""
