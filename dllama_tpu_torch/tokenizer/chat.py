"""Chat templating and streaming stop-sequence (EOS) detection.

The port's own copy of the JAX package's ``tokenizer/chat.py`` (host-only).
Behavior-compatible with the reference (reference: src/tokenizer.cpp:517-722,
src/tokenizer.hpp:100-155): template type is auto-detected from the tokenizer's
stored jinja template string; rendering is hard-coded per family (llama2,
llama3, deepseek3, chatml); EosDetector is a streaming matcher that buffers
output while a stop string might be forming (MAYBE_EOS).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ChatTemplateType(enum.Enum):
    UNKNOWN = "unknown"
    LLAMA2 = "llama2"
    LLAMA3 = "llama3"
    DEEP_SEEK3 = "deepSeek3"
    CHATML = "chatml"


@dataclass
class ChatItem:
    role: str
    message: str


@dataclass
class GeneratedChat:
    content: str
    public_prompt: str | None = None  # e.g. "<think>\n" surfaced to the user


class ChatTemplateGenerator:
    """Render a message list into a model prompt (tokenizer.cpp:547-635)."""

    def __init__(self, chat_template: str | None,
                 eos: str = "",
                 type: ChatTemplateType = ChatTemplateType.UNKNOWN):
        if type == ChatTemplateType.UNKNOWN:
            if chat_template is None:
                raise ValueError("the tokenizer does not include a chat template")
            if "[INST]" in chat_template:
                type = ChatTemplateType.LLAMA2
            elif "<|start_header_id|>" in chat_template:
                type = ChatTemplateType.LLAMA3
            elif "<｜Assistant｜>" in chat_template:
                type = ChatTemplateType.DEEP_SEEK3
            elif "<|im_start|>" in chat_template:
                type = ChatTemplateType.CHATML
            else:
                raise ValueError("not supported chat template")
        self.type = type
        self.eos = eos

    def generate(self, items: list[ChatItem],
                 append_generation_prompt: bool = True) -> GeneratedChat:
        buf: list[str] = []
        public_prompt = None
        t = self.type
        if t == ChatTemplateType.LLAMA2:
            i = 0
            if len(items) >= 2 and items[0].role == "system" and items[1].role == "user":
                buf.append("[INST] <<SYS>>\n" + items[0].message + "\n<</SYS>>\n\n"
                           + items[1].message + " [/INST]" + self.eos)
                i = 2
            for item in items[i:]:
                if item.role == "assistant":
                    buf.append(item.message + self.eos)
                elif item.role == "user":
                    buf.append("[INST] " + item.message + " [/INST]" + self.eos)
        elif t == ChatTemplateType.LLAMA3:
            for item in items:
                buf.append("<|start_header_id|>" + item.role + "<|end_header_id|>\n\n"
                           + item.message + self.eos)
            if append_generation_prompt:
                buf.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif t == ChatTemplateType.DEEP_SEEK3:
            i = 0
            if items and items[0].role == "system":
                buf.append(items[0].message)
                i = 1
            for item in items[i:]:
                if item.role == "user":
                    buf.append("<｜User｜>" + item.message)
                elif item.role == "assistant":
                    buf.append("<｜Assistant｜>" + item.message)
            if append_generation_prompt:
                buf.append("<｜Assistant｜><think>\n")
                public_prompt = "<think>\n"
        elif t == ChatTemplateType.CHATML:
            # Note: the reference appends the generation prompt inside the item
            # loop (tokenizer.cpp:617-629) which duplicates it per message; that
            # reads like a bug, so here it is appended once at the end.
            for item in items:
                if item.role in ("system", "user", "assistant"):
                    buf.append("<|im_start|>" + item.role + "\n" + item.message
                               + "<|im_end|>\n")
            if append_generation_prompt:
                buf.append("<|im_start|>assistant\n")
        else:
            raise ValueError(f"cannot render template {t}")
        return GeneratedChat(content="".join(buf), public_prompt=public_prompt)


class EosResult(enum.Enum):
    NOT_EOS = 0
    EOS = 1
    MAYBE_EOS = 2


class EosDetector:
    """Streaming stop-string detector with MAYBE_EOS buffering
    (tokenizer.cpp:637-722).

    ``padding_left``/``padding_right`` allow a stop string to be found embedded
    up to that many characters from the buffer edges (the CLI passes the max
    stop length for both — dllama.cpp:180).
    """

    def __init__(self, stop_token_ids: list[int], stop_pieces: list[str],
                 padding_left: int = 0, padding_right: int = 0):
        self.stop_token_ids = list(stop_token_ids)
        self.pieces = [p.encode("utf-8") for p in stop_pieces]
        self.padding_left = padding_left
        self.padding_right = padding_right
        self._buffer = bytearray()
        self._eos_pos: int | None = None

    def is_eos_token(self, token_id: int) -> bool:
        return token_id in self.stop_token_ids

    def append(self, token_id: int, piece: str | None) -> EosResult:
        if piece is not None:
            self._buffer.extend(piece.encode("utf-8"))

        if self.is_eos_token(token_id):
            self._eos_pos = len(self._buffer)
            return EosResult.EOS
        self._eos_pos = None

        buf = self._buffer
        for stop in self.pieces:
            if len(buf) > len(stop) + self.padding_left + self.padding_right:
                continue
            for lo in range(self.padding_left + 1):
                n = len(buf) - lo
                if n == 0 or n > len(stop) + self.padding_right:
                    continue
                n = min(n, len(stop))
                if buf[lo:lo + n] == stop[:n]:
                    if n == len(stop):
                        self._eos_pos = lo
                        del self._buffer[lo:]
                        return EosResult.EOS
                    return EosResult.MAYBE_EOS
        return EosResult.NOT_EOS

    def get_delta(self) -> str | None:
        """The text safe to flush to the user after the last append."""
        if not self._buffer:
            return None
        if self._eos_pos == 0:
            return None
        return bytes(self._buffer).decode("utf-8", errors="replace")

    def reset(self) -> None:
        self._buffer.clear()
        self._eos_pos = None
