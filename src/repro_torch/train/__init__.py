"""Training (optimizer, train step, loop, checkpoints) and the serving
steps (prefill, decode) of the port."""
