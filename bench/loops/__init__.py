"""How calls are offered in the window, one module per traffic ``loop``."""
