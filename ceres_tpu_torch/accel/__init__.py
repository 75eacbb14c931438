"""Acceleration structure: host SweepSAH build, treelet cut, clusters."""
