"""Data tooling of the port, run as modules: `python -m
realtime_video_tpu_torch.scripts.generate_ode_pairs` and
`python -m realtime_video_tpu_torch.scripts.create_shards`."""
