"""PyTorch/CUDA port of realtime_video_tpu for NVIDIA Hopper GPUs.

The JAX package `realtime_video_tpu` is the reference: every module here keeps
the name of its JAX counterpart and is held against it by the CPU tests
(`tests/test_torch_*.py`). The port imports `torch` and never `jax`.

Layout: `config`, `scheduler`, `models/` (rope, wan_dit, diffusion_wrapper,
t5, text_encoder, vae, vae_wrapper, taehv: the preview tier's tiny
autoencoder), `ops/` (attention dispatcher, kv_cache, and the Hopper
kernels' wrappers `hopper_attention`, `hopper_int8_mm`, `hopper_conv` over
`csrc/*.cu`), `parallel/plan` (the serving memory plan),
`pipelines/causal_inference` (the offline block-causal sampler), `sample`
(offline batch sampling over the session), `serving/` (session, models,
server, video_io), `native` (the loader of the server's JPEG codec) and
`utils/` (checkpoint: the reference's state dicts -> the port's trees;
convert: JAX parameter trees -> the port's; qcache: the on-disk cache of
quantised trees; tokenizer).
"""
