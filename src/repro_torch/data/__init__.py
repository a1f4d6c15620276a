"""Synthetic data pipeline (numpy; no device work at import)."""
