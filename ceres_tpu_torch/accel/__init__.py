"""Acceleration structure: device LBVH and treelet cut, host SweepSAH
build and quality cut, clusters."""
