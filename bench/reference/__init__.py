"""The plain reference: what each operator's result must be, in plain
PyTorch, from the benchmark's own inputs. Nothing here imports the program."""
