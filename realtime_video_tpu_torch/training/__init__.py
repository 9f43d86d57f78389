"""Distillation training (port of realtime_video_tpu/training/): the losses,
DMD / SiD / CausVid, the self-forcing model, EMA and the train step."""
