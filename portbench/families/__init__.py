"""The model families the benchmark's entries drive, one module each."""
