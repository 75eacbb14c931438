"""Compute ops: culling prepass, the hand-written walk kernels, hit search."""
