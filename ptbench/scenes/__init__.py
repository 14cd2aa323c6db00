"""Frozen scene generators: the benchmark's traffic of geometry."""
