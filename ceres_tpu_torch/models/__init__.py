"""Scene model types: triangle soups, cameras, shading."""
