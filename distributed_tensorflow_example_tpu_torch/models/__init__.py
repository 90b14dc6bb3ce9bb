"""Model families of the port (the serving subset of the transformer so
far; ``mlp`` holds only the shared activation table)."""
