"""The plain float32 reference that decides `correct`: the Wan DiT with its
block-causal KV cache, the Wan 2.1 VAE, umT5, and the int8 tier's
calibration and quantisation. It imports nothing of the port."""
