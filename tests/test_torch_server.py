"""The port's WebSocket server over a real TCP socket on the CPU, tiny random
models: ready -> msgpack GenerateParams -> 30 JPEG frames for 3 blocks ->
completed; the same with the TAEHV preview tier (33 frames); a request
whose input cannot be read gets an error; /health and /metrics; the
upload and download endpoints; webcam frames pushed as mid-stream "image"
messages; a start frame given as an uploaded file's path."""
import asyncio
import time
from io import BytesIO

import aiohttp
import numpy as np
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


async def stream(session, base, request, timeout=120, sid="t1"):
    """Run one WS session; returns (jpeg frames, final status message)."""
    frames, final = [], None
    async with session.ws_connect(f"{base}/session/{sid}") as ws:
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

                # a clip that cannot be read: the session is not set up
                frames, final = await stream(s, base, {
                    "prompt": "a cat", "width": 64, "height": 64,
                    "input_video": "missing-clip.mp4"})
                assert frames == [] and "Cannot open video file" in final["error"]

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


def test_taehv_session_streams_33_frames_over_a_socket(stack, monkeypatch, tmp_path):
    """A server with the TAEHV preview tier (`use_taehv`) streams a session:
    TAEHV random-initialised at the session's start (no checkpoint at
    RTV_TAEHV_CKPT), 3 blocks of 12 frames with block 0's first 3 dropped."""
    config, models = stack
    monkeypatch.setenv("RTV_TAEHV_CKPT", str(tmp_path / "taew2_1.pth"))
    monkeypatch.setattr(models, "taehv_params", None)
    taehv = load_server_config(num_frame_per_block=3, model_name="t2v-tiny", use_taehv=True)

    async def run():
        runner, base = await serve(create_app(taehv, models))
        try:
            async with aiohttp.ClientSession() as s:
                frames, final = await stream(s, base, {"prompt": "a cat", "width": 64,
                                                       "height": 64, "num_blocks": 3,
                                                       "num_denoising_steps": 2})
                assert final == {"session_id": "t1", "status": "completed"}
                assert len(frames) == 33
                assert Image.open(BytesIO(frames[0])).size == (64, 64)
        finally:
            await runner.cleanup()

    asyncio.run(run())
    assert models.taehv_params["decoder"][1]["w"].dtype == torch.bfloat16


def _jpeg(rng, h=48, w=80) -> bytes:
    buf = BytesIO()
    Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def test_upload_endpoints_and_download(stack):
    """upload_start_frame / upload_video save the file and answer its path; a
    non-multipart upload is a 500 with an error; after a stream its frames
    download as an mp4 once (tests/test_server.py:129-181)."""
    config, models = stack

    async def run():
        runner, base = await serve(create_app(config, models))
        try:
            async with aiohttp.ClientSession() as s:
                buf = BytesIO()
                Image.new("RGB", (64, 64), (10, 200, 30)).save(buf, format="PNG")
                data = aiohttp.FormData()
                data.add_field("file", buf.getvalue(), filename="frame.png")
                async with s.post(f"{base}/upload_start_frame", data=data) as r:
                    assert r.status == 200
                    body = await r.json()
                assert body["path"].endswith(".png") and body["filename"] == "frame.png"
                with open(body["path"], "rb") as f:
                    assert f.read() == buf.getvalue()
                data = aiohttp.FormData()
                data.add_field("file", b"\x00" * 64, filename="clip.mp4")
                async with s.post(f"{base}/upload_video", data=data) as r:
                    assert r.status == 200 and (await r.json())["path"].endswith(".mp4")
                async with s.post(f"{base}/upload_video", data=b"not multipart") as r:
                    assert r.status == 500 and "error" in await r.json()
                async with s.get(f"{base}/download_video/never-ran") as r:
                    assert r.status == 404

                frames, final = await stream(s, base, {
                    "prompt": "a cat", "width": 64, "height": 64, "seed": 1,
                    "num_blocks": 1, "num_denoising_steps": 1, "kv_cache_num_frames": 3,
                }, sid="dl1")
                assert final["status"] == "completed" and len(frames) == 6
                async with s.get(f"{base}/download_video/dl1") as r:
                    status = r.status
                    mp4 = await r.read()
                    ctype = r.content_type
                if status == 200:
                    assert ctype == "video/mp4" and len(mp4) > 100
                    async with s.get(f"{base}/download_video/dl1") as r:
                        assert r.status == 404  # the frames went with the download
                else:
                    assert status == 500  # no mp4 writer on this host
        finally:
            await runner.cleanup()

    asyncio.run(run())


def test_webcam_frames_pushed_midstream(stack):
    """A webcam session fed by mid-stream "image" messages (JPEG bytes, a
    strength, a stale timestamp that only logs a warning), as a webcam client
    sends them: 10 frames, then 13 more once block 0's 6 frames are back
    (each block takes every frame queued by then); 6 + 12 frames return."""
    config, models = stack
    rng = np.random.default_rng(1)
    stale_ms = (time.time() - 5.0) * 1e3

    async def push(ws, n):
        for _ in range(n):
            await ws.send_bytes(packb({"image": _jpeg(rng), "strength": 0.7,
                                       "timestamp": stale_ms}))

    async def run():
        runner, base = await serve(create_app(config, models))
        frames, final = [], None
        try:
            async with aiohttp.ClientSession() as s:
                async with s.ws_connect(f"{base}/session/cam") as ws:
                    assert (await ws.receive_json(timeout=60))["status"] == "ready"
                    await ws.send_bytes(packb({
                        "prompt": "a cat", "width": 64, "height": 64, "seed": 2,
                        "num_blocks": 2, "num_denoising_steps": 2,
                        "kv_cache_num_frames": 3, "webcam_mode": True, "strength": 0.7}))
                    await push(ws, 10)
                    while final is None:
                        msg = await ws.receive(timeout=120)
                        if msg.type == aiohttp.WSMsgType.BINARY:
                            frames.append(msg.data)
                            if len(frames) == 6:
                                await push(ws, 13)
                        else:
                            final = msg.json()
            assert final["status"] == "completed", final
            assert len(frames) == 18
            assert Image.open(BytesIO(frames[-1])).size == (64, 64)
        finally:
            await runner.cleanup()

    asyncio.run(run())


def test_start_frame_path_over_the_socket(stack):
    """A start frame uploaded, then named by its path in the request: its
    latents take one block of a 2-block budget, so 6 frames come back."""
    config, models = stack

    async def run():
        runner, base = await serve(create_app(config, models))
        try:
            async with aiohttp.ClientSession() as s:
                data = aiohttp.FormData()
                data.add_field("file", _jpeg(np.random.default_rng(2), 64, 64),
                               filename="start.jpg")
                async with s.post(f"{base}/upload_start_frame", data=data) as r:
                    path = (await r.json())["path"]
                frames, final = await stream(s, base, {
                    "prompt": "a cat", "width": 64, "height": 64, "seed": 3,
                    "num_blocks": 2, "num_denoising_steps": 2, "kv_cache_num_frames": 3,
                    "start_frame": path}, sid="start")
                assert final["status"] == "completed", final
                assert len(frames) == 6
        finally:
            await runner.cleanup()

    asyncio.run(run())
