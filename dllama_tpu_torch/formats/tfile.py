""".t tokenizer file format — reader and writer.

The port's own copy of the JAX package's ``formats/tfile.py``.
Wire-compatible with the reference format (reference: src/tokenizer.cpp:42-178
for the reader, converter/tokenizer-writer.py:3-57 for the writer):

    int32 magic = 0x567124
    int32 headerSize                 # includes magic + this field
    (int32 key, int32 value) *       # (headerSize - 8) / 8 pairs
    chat template bytes              # if CHAT_TEMPLATE key present (its value = length)
    int32 eos_token_id * n           # if N_EOS_TOKENS present
    per token: float32 score, int32 length, bytes   # vocab_size entries
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from pathlib import Path

TOKENIZER_MAGIC = 0x567124


class TokHeaderKey(enum.IntEnum):
    """Header key ids (reference: src/tokenizer.hpp:21-32)."""

    VERSION = 0
    VOCAB_SIZE = 1
    MAX_TOKEN_LENGTH = 2
    BOS_ID = 3
    EOS_ID = 4  # backward compatibility
    PAD_ID = 5  # ignored
    CHAT_EOS_ID = 6  # backward compatibility
    CHAT_TEMPLATE = 7
    CHAT_STOP = 8  # ignored (value = byte length to skip)
    N_EOS_TOKENS = 9
    ADD_BOS = 10


@dataclass
class TokenizerData:
    """Parsed .t contents — raw vocab + metadata, no behavior."""

    vocab: list[bytes]
    scores: list[float]
    bos_id: int = -1
    add_bos: bool = True
    eos_token_ids: list[int] = field(default_factory=list)
    chat_template: str | None = None
    max_token_length: int = 0

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def regular_vocab_size(self) -> int:
        # The reference assumes bosId splits regular and special vocab
        # (tokenizer.cpp:141-143, flagged "very unstable assumption" there).
        return self.bos_id if self.bos_id >= 0 else len(self.vocab)


def read_tfile(path: str | Path) -> TokenizerData:
    raw = Path(path).read_bytes()
    magic, = struct.unpack_from("<i", raw, 0)
    if magic != TOKENIZER_MAGIC:
        raise ValueError(f"invalid tokenizer file magic {magic:#x}")
    header_size, = struct.unpack_from("<i", raw, 4)
    n_kv = (header_size - 8) // 8

    version = -1
    vocab_size = 0
    max_token_length = 0
    bos_id = -1
    add_bos = True
    eos_ids: list[int] = []
    chat_template_length = -1
    n_eos_tokens = 0
    skip_after_header = 0

    for i in range(n_kv):
        key, value = struct.unpack_from("<ii", raw, 8 + i * 8)
        if key == TokHeaderKey.VERSION:
            version = value
        elif key == TokHeaderKey.VOCAB_SIZE:
            vocab_size = value
        elif key == TokHeaderKey.MAX_TOKEN_LENGTH:
            max_token_length = value
        elif key == TokHeaderKey.BOS_ID:
            bos_id = value
        elif key in (TokHeaderKey.EOS_ID, TokHeaderKey.CHAT_EOS_ID):
            eos_ids.append(value)
        elif key == TokHeaderKey.CHAT_TEMPLATE:
            chat_template_length = value
        elif key == TokHeaderKey.CHAT_STOP:
            skip_after_header += value
        elif key == TokHeaderKey.PAD_ID:
            pass
        elif key == TokHeaderKey.N_EOS_TOKENS:
            n_eos_tokens = value
        elif key == TokHeaderKey.ADD_BOS:
            add_bos = value == 1
        else:
            raise ValueError(f"invalid tokenizer header key {key}")

    if version != 1:
        raise ValueError("old tokenizer version, please regenerate your tokenizer")

    off = header_size + skip_after_header
    chat_template = None
    if chat_template_length > 0:
        chat_template = raw[off:off + chat_template_length].decode("utf-8")
        off += chat_template_length
    for _ in range(n_eos_tokens):
        eos_id, = struct.unpack_from("<i", raw, off)
        eos_ids.append(eos_id)
        off += 4

    vocab: list[bytes] = []
    scores: list[float] = []
    for i in range(vocab_size):
        if off + 8 > len(raw):
            raise ValueError(f"cannot read token {i} header from tokenizer file (truncated)")
        score, length = struct.unpack_from("<fi", raw, off)
        off += 8
        if length < 1 or off + length > len(raw):
            raise ValueError(f"cannot read token {i} from tokenizer file "
                             f"(length {length}, truncated or corrupt)")
        vocab.append(raw[off:off + length])
        off += length
        scores.append(score)

    if max_token_length < 1:
        raise ValueError("invalid tokenizer max token length")

    return TokenizerData(vocab=vocab, scores=scores, bos_id=bos_id, add_bos=add_bos,
                         eos_token_ids=eos_ids, chat_template=chat_template,
                         max_token_length=max_token_length)


def write_tfile(path: str | Path, data: TokenizerData) -> None:
    """Write a .t file (reference: converter/tokenizer-writer.py:3-57)."""
    params: list[tuple[int, int]] = [
        (TokHeaderKey.BOS_ID, data.bos_id),
        (TokHeaderKey.VERSION, 1),
        (TokHeaderKey.VOCAB_SIZE, len(data.vocab)),
        (TokHeaderKey.MAX_TOKEN_LENGTH, max(len(t) for t in data.vocab)),
    ]
    template_bytes = data.chat_template.encode("utf-8") if data.chat_template else None
    if template_bytes:
        params.append((TokHeaderKey.CHAT_TEMPLATE, len(template_bytes)))
    params.append((TokHeaderKey.N_EOS_TOKENS, len(data.eos_token_ids)))
    params.append((TokHeaderKey.ADD_BOS, 1 if data.add_bos else 0))

    with open(path, "wb") as f:
        kv = b"".join(struct.pack("<ii", int(k), int(v)) for k, v in params)
        f.write(struct.pack("<i", TOKENIZER_MAGIC))
        f.write(struct.pack("<i", 8 + len(kv)))
        f.write(kv)
        if template_bytes:
            f.write(template_bytes)
        for eos_id in data.eos_token_ids:
            f.write(struct.pack("<i", eos_id))
        for score, token in zip(data.scores, data.vocab):
            assert len(token) > 0
            f.write(struct.pack("<fI", score, len(token)))
            f.write(token)
