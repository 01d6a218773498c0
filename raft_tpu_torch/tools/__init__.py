"""Measurement tools that run on the card (see each module)."""
