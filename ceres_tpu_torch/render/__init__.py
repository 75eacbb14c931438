"""The render pipeline."""
