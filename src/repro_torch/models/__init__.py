"""The LM side of the port: config, layers, the dense transformer, the
model factory and the JAX-parameter converter."""
