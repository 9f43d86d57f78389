"""`SelfForcingModel` (training/base.py) against the JAX package's, on the
tiny models of tests/test_torch_training.py and the tiny VAE of
tests/test_torch_causal_inference.py (f32, the same numpy weights):
  * the host-drawn rollout length, for a range of step seeds;
  * `_run_generator` over 8 blocks (24 latent frames of 4x4), past the
    21-frame window: the cache evicts (JAX's rolling buffer, the port's
    training-cache window) and the output is re-anchored (the last frame
    decoded to pixels and re-encoded as an image latent ahead of the last
    20 frames), JAX's draws replayed: relative Frobenius 1e-3, exit flags
    equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from realtime_video_tpu.config import VAEConfig as JVAEConfig
from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu.training.base import SelfForcingModel as JModel
from realtime_video_tpu_torch.config import VAEConfig, load_server_config
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper as TVAE
from realtime_video_tpu_torch.training.base import SelfForcingModel as TModel
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax
from test_torch_session import numpy_tree
from test_torch_training import REL, ReplayDraws, _noise, jax_draws, nets, rel_fro  # noqa: F401

VAEC = dict(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
CONFIG = dict(denoising_step_list=[1000, 500], num_frame_per_block=3, num_training_frames=24)
STEP_SEED = 7  # np.random.RandomState(7).randint(1, 9) == 8: all 8 blocks


def test_rollout_length_matches_jax(nets):
    jnets, tnets, _, _ = nets
    jm = JModel(*jnets, jconfig(**CONFIG))
    tm = TModel(*tnets, load_server_config(**CONFIG))
    lengths = [tm.rollout_num_blocks(s) for s in range(64)]
    assert lengths == [jm.rollout_num_blocks(s) for s in range(64)]
    assert set(lengths) == set(range(1, 9))


def test_run_generator_past_the_window_matches_jax(nets):
    jnets, tnets, jcross, tcross = nets
    vae_np, shapes = numpy_tree(
        lambda k: jvae.init_vae_params(k, JVAEConfig(**VAEC), jnp.float32), 11)
    jv = JVAE(cfg=JVAEConfig(**VAEC),
              params=jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), vae_np, shapes))
    tv = TVAE(VAEConfig(**VAEC), vae_params_from_jax(vae_np))
    jm = JModel(*jnets, jconfig(**CONFIG), vae=jv)
    tm = TModel(*tnets, load_server_config(**CONFIG), vae=tv)
    assert tm.rollout_num_blocks(STEP_SEED) == 8
    noise = _noise(30, (1, 24, 16, 4, 4))
    run = lambda p, n, c, k: jm._run_generator(p, n, c, k, step_seed=STEP_SEED)  # noqa: E731
    args = (jnets[0].params, noise, jcross[0], jax.random.PRNGKey(31))
    draws = ReplayDraws(jax_draws(run, *args))
    jpred, jflags = jax.jit(run)(*args)
    with torch.no_grad():
        tpred, tflags = tm._run_generator(tnets[0].params, torch.from_numpy(np.array(noise)),
                                          tcross[0], draws, step_seed=STEP_SEED)
    assert not draws.items
    assert tflags.tolist() == np.asarray(jflags).tolist()
    assert tuple(tpred.shape) == np.asarray(jpred).shape == (1, 21, 16, 4, 4)
    assert rel_fro(tpred[:, 1:].numpy(), np.asarray(jpred)[:, 1:]) < REL
    assert rel_fro(tpred[:, :1].numpy(), np.asarray(jpred)[:, :1]) < REL
