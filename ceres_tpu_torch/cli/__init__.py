"""Command-line apps: ``render`` (one frame) and ``anim`` (a turntable)."""
