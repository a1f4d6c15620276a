"""The optimizer: AdamW with schedule and clipping."""
