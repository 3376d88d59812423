"""Data sources of the port (only the fetch helper the serving path uses)."""
