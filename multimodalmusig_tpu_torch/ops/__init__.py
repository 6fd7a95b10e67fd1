"""Solvers, special functions and the fused λ kernel."""
