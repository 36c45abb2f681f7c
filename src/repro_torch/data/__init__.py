"""Seeded dataset generators (the same draws as the reference package's)."""
