"""Data and checkpoint tooling of the port, run as modules: `python -m
realtime_video_tpu_torch.scripts.generate_ode_pairs`, `.create_shards`,
`.synthesize_checkpoint` and `.run_real_checkpoint`."""
