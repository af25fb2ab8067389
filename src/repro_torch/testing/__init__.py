"""Test harnesses: result comparison, the plan fuzzer, the chaos and the
distributed cases (the port of ``repro.testing``)."""
