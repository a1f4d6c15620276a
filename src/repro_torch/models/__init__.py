"""The LM substrate of the port: the dense decoder (``attn`` and
``attn_local`` blocks) for prefill and KV-cache decode, with the model's
causal attention on the hand-written flash kernel where its shape allows.
Importing this package builds nothing."""
