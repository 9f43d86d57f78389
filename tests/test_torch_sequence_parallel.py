"""The port's sequence parallelism (`parallel/sequence.py`) against the JAX
package's on the CPU, in f32.

One `parallel/launch.run` of 4 ranks over gloo
(`torch_parallel_ranks.sp_rank`):
  * Ulysses, ring and USP at sp 2 ({"dp": 2, "sp": 2}, and USP as ring 2 x
    Ulysses 1) and sp 4 (USP as ring 2 x Ulysses 2), each rank's output
    gathered, against JAX's `make_sp_attention` / `make_ring_attention` /
    `make_usp_attention` under `shard_map` on the same numpy q, k, v, at
    atol 2e-5 (tests/test_sequence_parallel.py's bar); the ring with 3
    heads, which divide by no sp;
  * the teacher, `BidirectionalDiffusionInferencePipeline(sp_mesh=)` at
    world 4 with 2 heads (ring 2 x Ulysses 2) over 21 latent frames (84
    tokens, 21 a rank: the frames do not split, the tokens do), 2 UniPC
    steps with guidance: against the port without sp at 2e-4, and against
    JAX's pipeline (its text K/V in f32, as test_torch_teacher_pipelines.py's
    `F32CrossGen`) at relative Frobenius 1e-3.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from realtime_video_tpu.config import WanModelConfig as JCfg
from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.parallel import sequence as jseq
from realtime_video_tpu.pipelines import BidirectionalDiffusionInferencePipeline as JBiDiff
from realtime_video_tpu_torch.parallel import launch
from torch_parallel_ranks import sp_rank

TEACHER = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=2)


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


#: (name, kind, the port's mesh, JAX's mesh (axes, sizes), q/k/v shape)
CASES = [
    ("ulysses_sp2", "ulysses", {"dp": 2, "sp": 2}, (("sp",), (2,)), (2, 64, 8, 32)),
    ("ulysses_sp4", "ulysses", {"sp": 4}, (("sp",), (4,)), (2, 64, 8, 32)),
    ("ring_sp2", "ring", {"dp": 2, "sp": 2}, (("sp",), (2,)), (1, 128, 3, 16)),
    ("ring_sp4", "ring", {"sp": 4}, (("sp",), (4,)), (1, 128, 3, 16)),
    ("usp_sp2", "usp", {"dp": 2, "sp_r": 2, "sp_u": 1}, (("sp_r", "sp_u"), (2, 1)),
     (2, 64, 4, 16)),
    ("usp_sp4", "usp", {"sp_r": 2, "sp_u": 2}, (("sp_r", "sp_u"), (2, 2)), (2, 64, 4, 16)),
]


def _jax_attention(kind, axes, sizes, arrays):
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), axes)
    if kind == "ulysses":
        fn, spec = jseq.make_sp_attention(mesh, "sp"), "sp"
    elif kind == "ring":
        fn, spec = jseq.make_ring_attention(mesh, "sp"), "sp"
    else:
        fn, spec = jseq.make_usp_attention(mesh, "sp_u", "sp_r"), ("sp_r", "sp_u")
    q, k, v = (jseq.shard_sequence(jnp.asarray(a), mesh, spec) for a in arrays)
    return np.asarray(jax.jit(fn)(q, k, v))


def _teacher_params():
    cfg = JCfg(**TEACHER)
    p = jdit.init_wan_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    p["head"]["head"]["w"] = jnp.asarray(rng.normal(0, 0.05, p["head"]["head"]["w"].shape),
                                         jnp.float32)
    return cfg, p


class F32CrossGen(JGen):
    """JAX's generator with its text K/V in f32 from the bf16-rounded
    embeddings its pipeline passes (the port's pipeline with an f32 DiT)."""

    def compute_crossattn_cache(self, params, prompt_embeds):
        return super().compute_crossattn_cache(params, prompt_embeds.astype(jnp.float32))


@pytest.fixture(scope="module")
def run():
    arrays = {name: _qkv(i, shape) for i, (name, _, _, _, shape) in enumerate(CASES)}
    cfg, p = _teacher_params()
    rng = np.random.default_rng(7)
    noise = rng.normal(size=(1, 21, 16, 4, 4)).astype(np.float32)
    embeds = [rng.normal(size=(1, 16, cfg.text_dim)).astype(np.float32) for _ in range(2)]
    case = {"attention": [(name, kind, shape, arrays[name]) for name, kind, shape, _, _ in CASES],
            "teacher": {"dims": TEACHER, "params": jax.device_get(p), "steps": 2,
                        "noise": noise, "embeds": embeds}}
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        pending = pool.submit(launch.run, sp_rank, 4, case, backend="gloo", device="cpu",
                              timeout_s=240)
        want = {name: _jax_attention(kind, *jmesh, arrays[name])
                for name, kind, _, jmesh, _ in CASES}
        jp = JBiDiff(jconfig(guidance_scale=3.0, sampling_steps=2),
                     F32CrossGen(cfg=cfg, params=p, dtype=jnp.float32))
        _, jlat = jp.inference(jnp.asarray(noise), prompt_embeds=jnp.asarray(embeds[0]),
                               neg_prompt_embeds=jnp.asarray(embeds[1]), return_latents=True)
        want["teacher"] = np.asarray(jlat)
        ranks = pending.result()
    return ranks, want


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sequence_parallel_attention_matches_jax(run, name):
    ranks, want = run
    for r in ranks:
        np.testing.assert_allclose(r[name], want[name], atol=2e-5)


def test_teacher_with_sp_mesh(run):
    ranks, want = run
    assert ranks[0]["teacher_mesh"] == {"sp_r": 2, "sp_u": 2}
    single = ranks[0]["teacher_single"]
    for r in ranks:
        np.testing.assert_allclose(r["teacher"], single, rtol=2e-4, atol=2e-4)
    assert rel_fro(ranks[0]["teacher"], want["teacher"]) < 1e-3
