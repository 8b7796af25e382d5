"""Dense-family model of the port (layers, assembly, JAX parameter import)."""
