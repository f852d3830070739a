"""SRS WHIP-style HTTP signaling, decoupled from aiortc.

Port of mere_fusion_tpu/server/signaling.py. The reference negotiates both
peer connections against the SRS HTTP API and tears a session down from the
connection-state watcher (reference: app.py:282-291, 406-478, 434-512).
``pc`` is anything with createOffer / setLocalDescription /
setRemoteDescription, and the HTTP POST and the answer's construction are
injectable, so the offer/answer state machine, its retries, timeouts and
teardown run in tests against a fake of aiortc; a server passes real
aiortc objects (aiohttp and aiortc are imported only then).
"""
from __future__ import annotations

import asyncio
import logging
import secrets
from typing import Any, Awaitable, Callable, Optional

logger = logging.getLogger(__name__)

PostJson = Callable[[str, dict, float], Awaitable[dict]]


async def default_post_json(url: str, payload: dict, timeout: float) -> dict:
    import aiohttp

    async with aiohttp.ClientSession() as http:
        async with http.post(url, json=payload,
                             timeout=aiohttp.ClientTimeout(total=timeout)) as resp:
            return await resp.json()


def default_make_answer(sdp: str):
    from aiortc import RTCSessionDescription

    return RTCSessionDescription(sdp=sdp, type="answer")


class SrsError(ValueError):
    """The SRS API answered with an error body (a code other than 0) or a
    malformed answer."""


def _answer_sdp(data) -> str:
    """The answer's SDP from an SRS response body, or SrsError."""
    if not isinstance(data, dict):
        raise SrsError(f"SRS answer is not a JSON object: {type(data).__name__}")
    code = data.get("code")
    if code and code != 0:   # the reference's truthiness check
        raise SrsError(f"SRS rejected the offer: code={code!r} "
                       f"msg={data.get('msg') or data.get('message')!r}")
    sdp = data.get("sdp")
    if not isinstance(sdp, str) or not sdp:
        raise SrsError(f"SRS answer missing sdp (code={code!r})")
    return sdp


async def negotiate(pc, api_url: str, stream_url: str,
                    post_json: Optional[PostJson] = None,
                    make_answer: Optional[Callable[[str], Any]] = None,
                    retries: int = 3, timeout: float = 15.0,
                    sleep: Callable[[float], Awaitable[None]] = asyncio.sleep,
                    action: Optional[str] = None) -> None:
    """Create a local offer, POST it to the SRS HTTP API, apply the answer.

    The request body is the reference's (app.py:437-445, 496-504: api,
    streamurl, clientip, sdp, tid, action). A truthy code other than 0 is an
    SRS failure and a missing or empty sdp a malformed answer (app.py:452-461).
    A failure anywhere in the POST and the answer retries the same offer
    after 1 s, 2 s, ... (app.py:282-291); each POST is bounded by
    ``timeout`` seconds. After the last attempt it raises ConnectionError
    with the last failure.
    """
    post_json = post_json or default_post_json
    make_answer = make_answer or default_make_answer
    offer = await pc.createOffer()
    await pc.setLocalDescription(offer)
    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            data = await post_json(api_url, {
                "api": api_url,
                "streamurl": stream_url,
                "clientip": None,
                "sdp": pc.localDescription.sdp,
                "tid": str(10000 + secrets.randbelow(90000)),
                "action": action or "",
            }, timeout)
            await pc.setRemoteDescription(make_answer(_answer_sdp(data)))
            return
        except Exception as e:   # any failure of this attempt is retried
            last = e
            if attempt + 1 < retries:
                await sleep(2**attempt)
    raise ConnectionError(f"SRS signaling failed after {retries} attempts: {last}")


async def wait_connected(pc, timeout: float = 15.0) -> None:
    """Wait until ``pc.connectionState`` is "connected"; ConnectionError on
    "failed" or "closed", or after ``timeout`` seconds.

    The produce negotiation starts only once the consume pc is connected
    (reference app.py:471-478). aiortc moves connectionState new →
    connecting → connected after the answer and signals each move with
    "connectionstatechange" (docs/aiortc_contract.md §C7); a pc may be
    connected already, and the event does not fire again, so the state is
    checked before the listener is registered and inside it.
    """
    fut: asyncio.Future = asyncio.get_running_loop().create_future()

    def check() -> None:
        if fut.done():
            return
        state = pc.connectionState
        if state == "connected":
            fut.set_result(None)
        elif state in ("failed", "closed"):
            fut.set_exception(ConnectionError(f"pc became {state} while waiting to connect"))

    @pc.on("connectionstatechange")
    async def _on_state() -> None:
        check()

    check()
    try:
        await asyncio.wait_for(fut, timeout)
    except asyncio.TimeoutError:
        raise ConnectionError(f"pc not connected within {timeout}s "
                              f"(state={pc.connectionState!r})") from None


def attach_state_watcher(pc, on_dead: Callable[[str], Any], label: str = "pc") -> None:
    """Call ``on_dead(state)`` once, when the connection becomes "failed" or
    "closed" (reference app.py:406-478). "disconnected" is not terminal:
    ICE often recovers from it within seconds, and firing on it would end a
    call that could recover and leave the watcher blind to the real end.
    ``on_dead`` may be sync or async."""
    fired = False

    @pc.on("connectionstatechange")
    async def _on_state() -> None:
        nonlocal fired
        state = pc.connectionState
        if state in ("failed", "closed") and not fired:
            fired = True
            logger.warning("%s connection %s: tearing down", label, state)
            result = on_dead(state)
            if asyncio.iscoroutine(result):
                await result
