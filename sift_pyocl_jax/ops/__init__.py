"""Compute ops: plain XLA formulations plus the Pallas (Triton) best-2 matcher."""
