"""Routes of the PyTorch port's session server over a weightless engine, on
the pattern of tests/test_server.py, plus /profile through torch.profiler
and device placement."""
from __future__ import annotations

import asyncio
import os
import sys

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.parallel.placement import DevicePlacer
from mere_fusion_tpu_torch.server.app import MANAGER, create_app
from tests.fakes import FakeEngine

CPU = torch.device("cpu")


def make_client(max_sessions: int = 2) -> TestClient:
    cfg = Config().override(**{"transport.mode": "loopback",
                               "server.max_sessions": max_sessions})
    app = create_app(cfg, engine_factory=lambda c: FakeEngine(c), devices=[CPU])
    return TestClient(TestServer(app))


def test_routes_and_lifecycle(tmp_path):
    async def main():
        client = make_client()
        await client.start_server()
        try:
            r = await client.post("/start_session", json={})
            body = await r.json()
            assert r.status == 200 and body["code"] == 0
            sid = body["session_id"]
            session = client.app[MANAGER].get(sid)
            engine = session.model
            assert session.device == CPU

            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": "hi"})
            assert (await r.json())["code"] == 0 and engine.messages == ["hi"]
            r = await client.post("/talk", json={"session_id": sid, "type": "chat",
                                                 "text": "ping"})
            assert r.status == 501                      # no llm configured
            r = await client.post("/interrupt", json={"session_id": sid})
            assert (await r.json())["code"] == 0 and engine.paused == 1
            await client.post("/set_audio_type", json={"session_id": sid,
                                                       "audio_type": 2, "reinit": True})
            assert engine.curr_state == 2

            assert "gauges" in await (await client.get("/metrics")).json()
            assert (await (await client.get("/health")).json())["sessions"] == 1
            r = await client.get("/profile", params={"seconds": "0.05",
                                                     "dir": str(tmp_path)})
            trace = (await r.json())["data"]["trace"]
            assert os.path.getsize(trace) > 0

            r = await client.post("/stop_session", json={"session_id": sid})
            assert (await r.json())["code"] == 0
            r = await client.post("/interrupt", json={"session_id": sid})
            assert r.status == 404
        finally:
            await client.close()

    asyncio.run(main())


def test_max_sessions_429():
    async def main():
        client = make_client(max_sessions=2)
        await client.start_server()
        try:
            for _ in range(2):
                assert (await client.post("/start_session", json={})).status == 200
            assert (await client.post("/start_session", json={})).status == 429
        finally:
            await client.close()

    asyncio.run(main())


def test_placer_picks_least_loaded_and_caps():
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    placer = DevicePlacer(devs, max_sessions_per_device=1)
    assert placer.acquire("a") == devs[0]
    assert placer.acquire("b") == devs[1]
    with pytest.raises(RuntimeError, match="capacity"):
        placer.acquire("c")
    placer.release("a")
    assert placer.acquire("c") == devs[0]
    assert placer.counts() == {devs[0]: 1, devs[1]: 1}


def test_unported_transports_raise(monkeypatch):
    """webrtc needs aiortc: without it (blocked here) the start answers 500
    naming it, and the placement slot is released."""
    monkeypatch.setitem(sys.modules, "aiortc", None)
    cfg = Config().override(**{"transport.mode": "webrtc"})

    async def main():
        client = TestClient(TestServer(create_app(cfg, lambda c: FakeEngine(c),
                                                  devices=[CPU])))
        await client.start_server()
        try:
            r = await client.post("/start_session", json={})
            body = await r.json()
            assert r.status == 500 and "aiortc" in body["message"]
            assert client.app[MANAGER].placer.counts() == {CPU: 0}
        finally:
            await client.close()

    asyncio.run(main())
