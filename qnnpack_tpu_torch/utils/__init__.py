"""Runtime utilities."""
