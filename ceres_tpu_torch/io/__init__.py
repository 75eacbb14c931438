"""Scene I/O: OBJ loading."""
