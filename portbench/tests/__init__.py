"""CPU tests of the benchmark and its card test."""
