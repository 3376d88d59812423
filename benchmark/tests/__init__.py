"""Tests of the benchmark (CPU; those marked ``card`` need the card)."""
