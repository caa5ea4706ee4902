"""CPU tests of the benchmark harness (run: python -m pytest gpubench/tests -q)."""
