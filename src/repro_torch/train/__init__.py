"""Serving steps (prefill, decode) of the port; training comes later."""
