"""The port's WebSocket server over a real TCP socket on the CPU, tiny random
models: ready -> msgpack GenerateParams -> 30 JPEG frames for 3 blocks ->
completed; an unported request field gets an error; /health and /metrics."""
import asyncio
from io import BytesIO

import aiohttp
import pytest
import torch
from aiohttp import web
from msgpack import packb
from PIL import Image

from realtime_video_tpu_torch.config import VAEConfig, WanModelConfig, load_server_config
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.models.text_encoder import StaticTextEncoder
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline
from realtime_video_tpu_torch.serving.models import Models
from realtime_video_tpu_torch.serving.server import create_app

WAN = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
VAEC = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)


@pytest.fixture(scope="module")
def stack():
    config = load_server_config(num_frame_per_block=3, model_name="t2v-tiny")
    gen = WanDiffusion(cfg=WAN, device="cpu", dtype=torch.bfloat16, seed=0)
    vae = VAEWrapper(VAEC, device="cpu", dtype=torch.bfloat16, seed=1)
    emb = torch.randn((1, 16, WAN.text_dim), generator=torch.Generator().manual_seed(2))
    models = Models(StaticTextEncoder(emb.to(torch.bfloat16)), gen,
                    CausalInferencePipeline(config, gen), vae, vae)
    return config, models


async def serve(app):
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, f"http://127.0.0.1:{port}"


async def stream(session, base, request, timeout=120):
    """Run one WS session; returns (jpeg frames, final status message)."""
    frames, final = [], None
    async with session.ws_connect(f"{base}/session/t1") as ws:
        ready = await ws.receive_json(timeout=timeout)
        assert ready["status"] == "ready"
        await ws.send_bytes(packb(request))
        while True:
            msg = await ws.receive(timeout=timeout)
            if msg.type == aiohttp.WSMsgType.BINARY:
                frames.append(msg.data)
            elif msg.type == aiohttp.WSMsgType.TEXT:
                final = msg.json()
                break
            else:
                break
    return frames, final


def test_ws_session_streams_30_frames_over_a_socket(stack):
    config, models = stack

    async def run():
        runner, base = await serve(create_app(config, models))
        try:
            async with aiohttp.ClientSession() as s:
                async with s.get(f"{base}/health") as r:
                    assert r.status == 200 and await r.text() == "OK"
                frames, final = await stream(s, base, {
                    "prompt": "a cat", "width": 64, "height": 64, "seed": 3,
                    "num_blocks": 3, "num_denoising_steps": 4, "kv_cache_num_frames": 3,
                })
                assert final["status"] == "completed", final
                assert len(frames) == 30
                im = Image.open(BytesIO(frames[0]))
                assert im.size == (64, 64) and im.mode == "RGB"

                frames, final = await stream(s, base, {
                    "prompt": "a cat", "width": 64, "height": 64,
                    "input_video": "clip.mp4"})
                assert frames == [] and "not supported" in final["error"]

                for _ in range(50):  # server-side teardown is asynchronous
                    async with s.get(f"{base}/metrics") as r:
                        snap = await r.json()
                    if snap["sessions_active"] == 0:
                        break
                    await asyncio.sleep(0.1)
                assert snap["frames_sent_total"] >= 30 and snap["ttff_ms_last"] is not None
        finally:
            await runner.cleanup()

    asyncio.run(run())
