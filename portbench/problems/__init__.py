"""One module per kind of configuration (``"kind"`` in its file): how its
inputs are drawn from the seed, how one call of the port is made, what the
call answered, and the reference's view of the same inputs."""
