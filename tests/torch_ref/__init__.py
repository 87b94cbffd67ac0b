"""Plain float32 references of published models, in plain ``torch``, for
the port's CPU tests. They import nothing of the port or of JAX."""
