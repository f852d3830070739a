"""LLM adapters with a uniform ``chat(text)`` / ``stream_chat(messages)`` API.

A copy of mere_fusion_tpu/llm/__init__.py; ``requests``, ``transformers`` and
``google.generativeai`` stay optional imports of the adapters that use them.

Equivalent of the reference's llm/ package (reference: llm/LLM.py:20-32,
Qwen.py, VllmGPT.py:18-46, Gemini.py, ChatGPT.py) plus the streaming path
used by the full-duplex brain (stream_openai_video.py:86-124). HTTP backends
use requests directly (OpenAI-compatible SSE), so no client SDK is required.
"""
from __future__ import annotations

import json
from typing import Iterator, Protocol


class LLMAdapter(Protocol):
    def chat(self, text: str) -> str: ...
    def stream_chat(self, messages: list[dict]) -> Iterator[str]: ...


class OpenAICompatLLM:
    """Any OpenAI-compatible /v1/chat/completions endpoint (SSE streaming)."""

    def __init__(self, base_url: str = "https://api.openai.com/v1",
                 model: str = "gpt-3.5-turbo", api_key: str = "",
                 system_prompt: str = ""):
        self.base_url = base_url.rstrip("/")
        self.model = model
        self.api_key = api_key
        self.system_prompt = system_prompt

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def chat(self, text: str) -> str:
        return "".join(self.stream_chat(self._messages(text)))

    def _messages(self, text: str) -> list[dict]:
        msgs = []
        if self.system_prompt:
            msgs.append({"role": "system", "content": self.system_prompt})
        msgs.append({"role": "user", "content": text})
        return msgs

    def stream_chat(self, messages: list[dict]) -> Iterator[str]:
        import requests

        body = {"model": self.model, "messages": messages, "stream": True}
        with requests.post(
            f"{self.base_url}/chat/completions",
            headers=self._headers(), json=body, stream=True, timeout=120,
        ) as r:
            r.raise_for_status()
            for line in r.iter_lines():
                if not line or not line.startswith(b"data:"):
                    continue
                payload = line[5:].strip()
                if payload == b"[DONE]":
                    break
                delta = (
                    json.loads(payload)["choices"][0].get("delta", {}).get("content")
                )
                if delta:
                    yield delta


class VllmGPT:
    """vLLM completion endpoint, reference contract (llm/VllmGPT.py:18-31)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8101,
                 model: str = "THUDM/chatglm3-6b"):
        self.url = f"http://{host}:{port}/v1/completions"
        self.model = model

    def chat(self, text: str) -> str:
        import requests

        body = {"model": self.model, "prompt": "Simple reply;" + text, "history": []}
        r = requests.post(self.url, json=body, timeout=120)
        return r.json()["choices"][0]["text"]

    def stream_chat(self, messages: list[dict]) -> Iterator[str]:
        yield self.chat(messages[-1]["content"])


class QwenLocal:
    """Local Qwen via transformers (reference: llm/Qwen.py, qwen_server.py).
    Requires the model weights to be present locally."""

    def __init__(self, model_path: str = "Qwen/Qwen-1_8B-Chat", device: str = "cpu"):
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model_path, trust_remote_code=True)
        self.model = AutoModelForCausalLM.from_pretrained(
            model_path, trust_remote_code=True
        ).to(device).eval()
        self.device = device

    def chat(self, text: str) -> str:
        import torch

        messages = [{"role": "user", "content": text}]
        inputs = self.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True, return_tensors="pt"
        ).to(self.device)
        with torch.no_grad():
            out = self.model.generate(inputs, max_new_tokens=256)
        return self.tokenizer.decode(out[0][inputs.shape[1]:], skip_special_tokens=True)

    def stream_chat(self, messages: list[dict]) -> Iterator[str]:
        yield self.chat(messages[-1]["content"])


class GeminiLLM:
    """Google Gemini with retry (reference: llm/Gemini.py:12-44)."""

    def __init__(self, model_path: str = "gemini-pro", api_key: str = "",
                 retries: int = 5):
        import google.generativeai as genai

        genai.configure(api_key=api_key)
        self.model = genai.GenerativeModel(model_path)
        self.retries = retries

    def chat(self, text: str) -> str:
        last = None
        for _ in range(self.retries):
            try:
                return self.model.generate_content(text).text
            except Exception as e:  # pragma: no cover - network path
                last = e
        raise RuntimeError(f"gemini failed after {self.retries} retries") from last

    def stream_chat(self, messages: list[dict]) -> Iterator[str]:
        yield self.chat(messages[-1]["content"])


class EchoLLM:
    """Offline test adapter: streams a canned transformation of the input."""

    def __init__(self, template: str = "You said: {text}. "):
        self.template = template

    def chat(self, text: str) -> str:
        return self.template.format(text=text)

    def stream_chat(self, messages: list[dict]) -> Iterator[str]:
        reply = self.chat(messages[-1]["content"])
        for i in range(0, len(reply), 8):  # stream in small chunks
            yield reply[i : i + 8]


def make_llm(name: str, **kw) -> LLMAdapter:
    table = {
        "openai": OpenAICompatLLM,
        "chatgpt": OpenAICompatLLM,
        "vllm": VllmGPT,
        "qwen": QwenLocal,
        "gemini": GeminiLLM,
        "echo": EchoLLM,
    }
    # API keys default from the environment (reference loads them from .env
    # via dotenv and os.environ, app.py:10, llm/Gemini.py:12)
    if not kw.get("api_key"):
        from mere_fusion_tpu_torch.utils.env import env_api_key

        if name in ("openai", "chatgpt"):
            key = env_api_key("OPENAI_API_KEY")
        elif name == "gemini":
            key = env_api_key("GEMINI_API_KEY", "GOOGLE_API_KEY")
        else:
            key = ""
        if key:
            kw["api_key"] = key
    try:
        return table[name](**kw)
    except KeyError:
        raise ValueError(f"unknown llm {name!r}; options: {sorted(table)}") from None
