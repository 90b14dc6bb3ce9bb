"""Model families of the port: the MLP (``mlp``, with the activation
table every family shares) and the serving subset of the transformer
(``transformer``)."""
