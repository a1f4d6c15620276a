"""The optimizer (AdamW with schedule and clipping, its ZeRO-1 specs) and
gradient compression."""
