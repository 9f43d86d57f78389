"""Real-time WebSocket streaming server for the PyTorch port (port of
realtime_video_tpu/serving/server.py, after release_server.py:758-1085).

  * GET /health, GET /metrics, GET / (demo page);
  * POST /upload_video, POST /upload_start_frame: a multipart file, saved to a
    temporary file whose path comes back as {"path", "filename"}, for a
    request's `input_video` or `start_frame`;
  * GET /download_video/{session_id}: the session's frames so far as an mp4;
  * WS /session/{id}: msgpack-encoded GenerateParams in, JPEG frames (or
    msgpack {image, request_id} with ?fmt=msgpack) out, then
    {"status": "completed"}; mid-stream dict messages: action "reset", a new
    "prompt" (+ "interp_steps"), "seed", and "image" (+ "strength",
    "request_id", "timestamp"): a webcam frame pushed into the session.

A single-worker generate pool runs the session's blocks (all GPU work), a
thread pool turns frames into JPEGs (the native codec when it builds, else
PIL) and decodes pushed frames, and an asyncio queue feeds the socket in
order.

Run: `python -m realtime_video_tpu_torch.serving.server` (PORT, CONFIG,
DEVICE env vars; the text encoder by USE_STATIC_ENCODER_COND_DICT and
RTV_T5_TINY, as `serving/models.load_text_encoder` reads them).
"""
from __future__ import annotations

import asyncio
import gc
import logging
import os
import random
import socket
import tempfile
import threading
import time
import traceback
import uuid
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from aiohttp import WSMsgType, web
from msgpack import packb, unpackb
from pydantic import ValidationError

from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.serving.metrics import METRICS
from realtime_video_tpu_torch.serving.models import Models, load_all
from realtime_video_tpu_torch.serving.params import GenerateParams
from realtime_video_tpu_torch.serving.session import GenerationSession
from realtime_video_tpu_torch.serving.video_io import save_video_to_bytes

log = logging.getLogger(__name__)

UUID_NIL = str(uuid.UUID(int=0))

#: every session's frames sent so far ([1, T, 3, H, W] in [0, 1]), for download
session_frames_storage: Dict[str, List[np.ndarray]] = {}
session_frame_locks: Dict[str, threading.Lock] = {}

generate_pool = ThreadPoolExecutor(max_workers=1)
encode_pool = ThreadPoolExecutor(max_workers=min(24, (os.cpu_count() or 4) * 4))


def _jpeg_bytes(frame: np.ndarray, quality: int = 90) -> bytes:
    """[3, H, W] float in [0, 1] -> JPEG bytes: the native codec when it is
    available, else PIL."""
    from realtime_video_tpu_torch.native import encode_jpeg_planar

    data = encode_jpeg_planar(frame, quality=quality)
    if data is not None:
        return data
    from PIL import Image

    arr = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8).transpose(1, 2, 0)
    buf = BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


async def health(request: web.Request) -> web.Response:
    return web.Response(text="OK")


async def metrics(request: web.Request) -> web.Response:
    return web.json_response(METRICS.snapshot())


async def root(request: web.Request) -> web.Response:
    demo = Path(__file__).resolve().parents[2] / "templates" / "release_demo.html"
    if not demo.exists():
        return web.Response(text="<h1>realtime-video</h1><p>Demo UI not found.</p>",
                            content_type="text/html", status=404)
    return web.Response(text=demo.read_text(encoding="utf-8"), content_type="text/html")


async def _save_upload(request: web.Request, default_name: str) -> web.Response:
    """Write the request's first multipart field to a temporary file and
    answer with its path."""
    try:
        reader = await request.multipart()
        field = await reader.next()
        suffix = Path(field.filename or default_name).suffix or Path(default_name).suffix
        with tempfile.NamedTemporaryFile(delete=False, suffix=suffix) as tmp:
            while chunk := await field.read_chunk():
                tmp.write(chunk)
        return web.json_response({"path": tmp.name, "filename": field.filename})
    except Exception as e:  # noqa: BLE001 — report a bad upload to the client
        return web.json_response({"error": str(e)}, status=500)


async def upload_video(request: web.Request) -> web.Response:
    return await _save_upload(request, "video.mp4")


async def upload_start_frame(request: web.Request) -> web.Response:
    return await _save_upload(request, "frame.jpg")


async def download_video(request: web.Request) -> web.Response:
    """The session's frames as an mp4 at 16 fps; the stored frames are
    dropped once they are downloaded."""
    session_id = request.match_info["session_id"]
    if session_id not in session_frames_storage:
        return web.json_response({"error": "No video data found for this session"}, status=404)
    frames = session_frames_storage[session_id]
    if not frames:
        return web.json_response({"error": "No frames available"}, status=404)
    all_frames = np.concatenate(frames, axis=1)  # [1, T, 3, H, W]
    mp4 = await asyncio.get_running_loop().run_in_executor(
        encode_pool, save_video_to_bytes, all_frames, 16)
    if mp4 is None:
        return web.json_response({"error": "Failed to generate MP4"}, status=500)
    del session_frames_storage[session_id]
    session_frame_locks.pop(session_id, None)
    return web.Response(
        body=mp4, content_type="video/mp4",
        headers={"Content-Disposition": f"attachment; filename=video_{session_id}.mp4"})


async def ws_session(websocket: web.WebSocketResponse, id: str, config,
                     models: Models, query=None):
    loop = asyncio.get_running_loop()
    await websocket.send_json({"status": "ready", "worker": socket.gethostname()})

    session: Optional[GenerationSession] = None
    frame_sender_task = None
    generate_task = None
    metrics_started = False
    try:
        params = None
        async for msg in websocket:
            if msg.type != WSMsgType.BINARY:
                continue
            try:
                params = GenerateParams.model_validate(unpackb(msg.data))
                break
            except ValidationError as e:
                await websocket.send_json({"error": e.errors()})
            except Exception as e:  # noqa: BLE001 — undecodable msgpack frame
                await websocket.send_json(
                    {"error": f"invalid msgpack payload: {type(e).__name__}"})
        if params is None:
            return
        METRICS.session_started(id)
        metrics_started = True
        params.block_on_frame = True
        if params.seed is None:
            params.seed = random.randint(0, 2**24 - 1)

        if isinstance(params.start_frame, str):  # a path, from /upload_start_frame
            try:
                from PIL import Image

                params.start_frame = Image.open(params.start_frame).convert("RGB")
            except Exception as e:  # noqa: BLE001 — serve the request without it
                log.error("Failed to load start frame: %s", e)
                params.start_frame = None

        if id not in session_frames_storage:
            session_frames_storage[id] = []
            session_frame_locks[id] = threading.Lock()

        frame_queue: asyncio.Queue = asyncio.Queue()
        use_msgpack = (query or {}).get("fmt", "jpeg") == "msgpack"

        async def frame_sender():
            while True:
                try:
                    next_frame = await (await frame_queue.get())
                    await websocket.send_bytes(next_frame)
                    METRICS.frame_sent(id)
                except asyncio.CancelledError:
                    break
                except Exception as e:  # noqa: BLE001
                    log.error("Error sending frame: %s", e)
                frame_queue.task_done()

        frame_sender_task = asyncio.create_task(frame_sender())

        async def extract_frame(frames_future, idx: int, frame_id: str) -> bytes:
            frames = await frames_future
            data = await loop.run_in_executor(encode_pool, _jpeg_bytes, frames[0, idx])
            if use_msgpack:
                return packb({"image": data, "request_id": frame_id})
            return data

        def frame_callback(tensor, frame_ids, _event):
            def to_host():
                arr = np.clip((tensor.float().cpu().numpy() + 1.0) * 0.5, 0.0, 1.0)
                with session_frame_locks[id]:
                    session_frames_storage[id].append(arr)
                return arr

            try:
                cpu_future = loop.run_in_executor(encode_pool, to_host)
                for idx in range(tensor.shape[1]):
                    frame_id = frame_ids[idx] if idx < len(frame_ids) else UUID_NIL
                    frame_queue.put_nowait(
                        loop.create_task(extract_frame(cpu_future, idx, frame_id)))
            except Exception as e:  # noqa: BLE001
                log.error("Error in frame_callback: %s", e)
                traceback.print_exc()

        def actual_frame_callback(*args):
            loop.call_soon_threadsafe(frame_callback, *args)

        gc.collect()

        def new_session():
            return GenerationSession(params, config, frame_callback=actual_frame_callback,
                                     models=models)

        try:
            session = new_session()
        except Exception as e:  # noqa: BLE001 — refused or unreadable input: tell the client
            log.error("Session set-up failed: %s", e)
            await websocket.send_json({"error": str(e)})
            return

        async def generate_loop():
            try:
                while True:
                    try:
                        await loop.run_in_executor(generate_pool, session.generate_block,
                                                   models)
                    except asyncio.CancelledError:
                        log.info("Generation completed: %s/%s blocks",
                                 session.block_idx, session.num_blocks)
                        try:
                            # drain pending frames so "completed" never
                            # overtakes queued JPEG sends
                            await asyncio.wait_for(frame_queue.join(), timeout=60)
                        except asyncio.TimeoutError:
                            log.warning("frames still queued after 60 s")
                        try:
                            await websocket.send_json({"session_id": id,
                                                       "status": "completed"})
                        except ConnectionError:
                            pass
                        break
                    except Exception as e:  # noqa: BLE001 — report and stop the session
                        log.error("Error during generation: %s", e)
                        traceback.print_exc()
                        await websocket.send_json({"error": f"generation failed: {e}"})
                        break
            except Exception as e:  # noqa: BLE001
                log.error("Error in generate_loop: %s", e)

        generate_task = loop.create_task(generate_loop())

        async for msg in websocket:
            if msg.type != WSMsgType.BINARY:
                if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                    break
                continue
            try:
                frame = unpackb(msg.data)
            except Exception:  # noqa: BLE001 — a garbage frame must not kill the session
                log.warning("Undecodable mid-stream frame")
                continue
            if not isinstance(frame, dict):
                log.warning("Received non-dict frame data")
                continue
            if frame.get("action") == "reset":
                session.dispose()
                session = new_session()
            try:
                if frame.get("prompt", session.params.prompt) != session.params.prompt:
                    params.prompt = frame["prompt"]
                    try:
                        interp_steps = int(frame.get("interp_steps",
                                                     frame.get("interpolation_steps", 4)))
                    except (TypeError, ValueError):
                        interp_steps = 4
                    session.interpolate_prompt_embeds(models, session.params.prompt,
                                                      max(1, interp_steps))
                if (new_seed := frame.get("seed")) is not None:
                    session.params.seed = int(new_seed)
                if image := frame.get("image"):
                    await loop.run_in_executor(encode_pool, session.push_frame, image,
                                               frame.get("strength"), frame.get("request_id"))
                    if (ts := frame.get("timestamp")) and isinstance(ts, (int, float)):
                        if time.time() - ts / 1000.0 > 1.0:
                            log.warning("High latency detected: %.2fs",
                                        time.time() - ts / 1000.0)
            except Exception as e:  # noqa: BLE001 — one bad control message != dead session
                log.error("Error handling mid-stream message: %s", e)
    finally:
        log.info("Terminating session")
        if metrics_started:
            METRICS.session_ended(id)
        if session:
            session.dispose()
        if frame_sender_task:
            frame_sender_task.cancel()
        if generate_task:
            generate_task.cancel()
        try:
            await websocket.send_json({"session_id": id, "status": "completed"})
        except (ConnectionError, RuntimeError):
            pass


async def app_session(request: web.Request) -> web.WebSocketResponse:
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    # one generation session at a time: sessions share the pipeline's KV and
    # cross-attention caches, so a second concurrent one is refused
    app = request.app
    limit = int(app["config"].get("max_concurrent_sessions", 1) or 1)
    if app.setdefault("active_ws_sessions", 0) >= limit:
        await ws.send_json({"error": "server busy: generation session already active"})
        await ws.close()
        return ws
    app["active_ws_sessions"] += 1
    try:
        await ws_session(ws, request.match_info["id"], config=app["config"],
                         models=app["models"], query=request.query)
    finally:
        app["active_ws_sessions"] -= 1
    return ws


def create_app(config=None, models: Optional[Models] = None, device=None) -> web.Application:
    app = web.Application(client_max_size=256 * 1024 * 1024)
    if config is None:
        config = load_server_config(os.getenv("CONFIG") or None)
    app["config"] = config
    if models is None:
        models = load_all(config, device or os.getenv("DEVICE", "cuda"))
    app["models"] = models
    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/", root)
    app.router.add_post("/upload_video", upload_video)
    app.router.add_post("/upload_start_frame", upload_start_frame)
    app.router.add_get("/download_video/{session_id}", download_video)
    app.router.add_get("/session/{id}", app_session)
    return app


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s.%(msecs)03d - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    app = create_app()
    web.run_app(app, host="0.0.0.0", port=int(os.getenv("PORT", "8000")))


if __name__ == "__main__":
    main()
