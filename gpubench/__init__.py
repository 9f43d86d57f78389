"""The benchmark of the PyTorch and CUDA port (`realtime_video_tpu_torch`):
closed-loop text-to-video sessions on one H100. `run.py` runs a cell of
`BENCHMARK.json`; configurations, traffic mixes and per-layer metric readers
are files of their own under `configs/`, `traffic/` and `metrics/`."""
