"""Greedy-merge BPE encoder and streaming UTF-8-safe decoder.

The port's own copy of the JAX package's ``tokenizer/bpe.py`` (the pure
Python merge loop).

Behavior-compatible with the reference implementation
(reference: src/tokenizer.cpp:309-388 encode, 222-307 decode/detokUtf8,
194-208 token lookup). The vocab is raw bytes (byte-level BPE or
sentencepiece pieces produced by the converter); encoding works on bytes, so
multi-byte UTF-8 input accumulates until a vocab entry matches.

Differences from the reference, by design:

* lookup uses hash maps instead of ``bsearch`` over a sorted array;
* the merge loop keeps the reference's "highest score wins, leftmost on tie"
  policy but runs on a heap + doubly-linked list (O(n log n)) instead of the
  reference's rescan-per-merge (O(n²), tokenizer.cpp:349-377) — same output
  on every input, proven by the tokenizer equivalence tests;
* unresolvable bytes raise ``ValueError`` instead of ``assert`` (the
  reference aborts — llm vocabularies always cover all bytes in practice).
"""

from __future__ import annotations

import heapq

from ..formats.tfile import TokenizerData, read_tfile

_REPLACEMENT = "�".encode("utf-8")  # 0xEF 0xBF 0xBD


def _utf8_expected_continuation(byte: int) -> int | None:
    """How many continuation bytes a UTF-8 lead byte announces; None if invalid."""
    if byte <= 0x7F:
        return 0
    if 0xC0 <= byte <= 0xDF:
        return 1
    if 0xE0 <= byte <= 0xEF:
        return 2
    if 0xF0 <= byte <= 0xF7:
        return 3
    return None


class Tokenizer:
    """Vocab + encode/decode over a parsed .t file."""

    def __init__(self, data: TokenizerData):
        self.data = data
        self.vocab = data.vocab
        self.scores = data.scores
        self.bos_id = data.bos_id
        self.add_bos = data.add_bos
        self.eos_token_ids = list(data.eos_token_ids)
        self.chat_template = data.chat_template
        self.vocab_size = data.vocab_size
        self.regular_vocab_size = data.regular_vocab_size

        # Regular vocab: bytes -> id. On duplicates keep the FIRST id, matching
        # the reference's bsearch over a stably-ordered array of unique keys.
        self._regular: dict[bytes, int] = {}
        for i in range(self.regular_vocab_size):
            self._regular.setdefault(self.vocab[i], i)
        # Special vocab keeps file order: the reference's prefix scan takes the
        # first match in vocab order (tokenizer.cpp:194-202).
        self._special: list[tuple[int, bytes]] = [
            (i, self.vocab[i])
            for i in range(self.regular_vocab_size, self.vocab_size)
        ]
        self._pending = bytearray()  # streaming decoder carry-over

    @classmethod
    def load(cls, path) -> "Tokenizer":
        return cls(read_tfile(path))

    def is_eos(self, token: int) -> bool:
        return token in self.eos_token_ids

    # -- encode -------------------------------------------------------------

    def encode(self, text: str | bytes, is_start: bool = True,
               add_special_tokens: bool = True) -> list[int]:
        """Tokenize: byte accumulation pass, then greedy best-score pair merging."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        tokens: list[int] = []
        if is_start and self.add_bos and self.bos_id >= 0:
            tokens.append(self.bos_id)

        buf = bytearray()
        i = 0
        n = len(text)
        while i < n:
            if add_special_tokens:
                # The reference checks special tokens at every byte position,
                # even mid-accumulation (tokenizer.cpp:323-330).
                matched = next(((tid, len(piece)) for tid, piece in self._special
                                if text.startswith(piece, i)), None)
                if matched is not None:
                    if buf:
                        raise ValueError(
                            f"unresolvable bytes before special token: {bytes(buf)!r}")
                    tokens.append(matched[0])
                    i += matched[1]
                    continue
            buf.append(text[i])
            i += 1
            tid = self._regular.get(bytes(buf))
            if tid is not None:
                tokens.append(tid)
                buf.clear()
        if buf:
            raise ValueError(f"unresolvable bytes in input: {bytes(buf)!r}")

        return self._merge(tokens)

    def _merge(self, tokens: list[int]) -> list[int]:
        """Greedy merge: repeatedly merge the best-scoring adjacent pair,
        leftmost on ties — the reference's policy (tokenizer.cpp:349-377,
        strict ``>`` comparison ⇒ first max wins), on a lazy-deletion heap
        over a doubly-linked token list. A heap entry is
        ``(-score, left_pos, left_ver, right_ver, right_pos, merged_id)``;
        node versions invalidate entries whose endpoints merged since.
        """
        n = len(tokens)
        if n < 2:
            return tokens
        ids = list(tokens)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        ver = [0] * n
        heap: list = []
        lookup = self._regular.get
        vocab, scores = self.vocab, self.scores

        def push(j: int) -> None:
            k = nxt[j]
            if k == -1:
                return
            mid = lookup(vocab[ids[j]] + vocab[ids[k]])
            if mid is not None:
                heapq.heappush(heap, (-scores[mid], j, ver[j], ver[k], k, mid))

        for j in range(n - 1):
            push(j)
        while heap:
            _, j, vj, vk, k, mid = heapq.heappop(heap)
            if (not alive[j] or not alive[k] or ver[j] != vj or ver[k] != vk
                    or nxt[j] != k):
                continue  # stale: an endpoint merged since this pair was seen
            ids[j] = mid
            ver[j] += 1
            alive[k] = False
            nxt[j] = nxt[k]
            if nxt[k] != -1:
                prev[nxt[k]] = j
            if prev[j] != -1:
                push(prev[j])
            push(j)
        out: list[int] = []
        j = 0
        while j != -1:  # node 0 is always the surviving head
            out.append(ids[j])
            j = nxt[j]
        return out

    # -- streaming decode ---------------------------------------------------

    def reset_decoder(self) -> None:
        self._pending.clear()

    def decode(self, token: int) -> str | None:
        """Decode one token for streaming output.

        Returns the printable delta, or None when nothing is emittable yet
        (bos, incomplete UTF-8 sequence). Incomplete trailing sequences stay
        buffered for the next call; invalid bytes become U+FFFD with stream
        recovery (tokenizer.cpp:224-285).
        """
        if token == self.bos_id:
            return None
        if self.is_eos(token):
            if self._pending:
                out = bytes(self._pending).decode("utf-8", errors="replace")
                self._pending.clear()
                return out
            return None
        self._pending.extend(self.vocab[token])
        return self._drain_utf8()

    def decode_all(self, tokens: list[int]) -> str:
        """Non-streaming convenience: decode a whole sequence."""
        self.reset_decoder()
        parts = [p for p in (self.decode(t) for t in tokens) if p]
        if self._pending:
            parts.append(bytes(self._pending).decode("utf-8", errors="replace"))
            self._pending.clear()
        return "".join(parts)

    def _drain_utf8(self) -> str | None:
        """Emit the longest valid-or-recovered UTF-8 prefix, keep the rest."""
        src = bytes(self._pending)
        out = bytearray()
        checkpoint = 0  # bytes of `out` that end on a sequence boundary
        checkpoint_src = 0
        i = 0
        expect = 0
        while i < len(src):
            c = src[i]
            recovery = False
            if expect:
                if (c & 0xC0) == 0x80:
                    out.append(c)
                    i += 1
                    expect -= 1
                else:
                    recovery = True
            else:
                exp = _utf8_expected_continuation(c)
                if exp is None:
                    recovery = True
                else:
                    out.append(c)
                    i += 1
                    expect = exp
            if not recovery:
                if not expect:
                    checkpoint = len(out)
                    checkpoint_src = i
            else:
                if expect:
                    expect = 0
                else:
                    i += 1
                del out[checkpoint:]
                out.extend(_REPLACEMENT)
                checkpoint = len(out)
                checkpoint_src = i
        self._pending = bytearray(src[checkpoint_src:])
        if checkpoint > 0:
            # errors="replace": the structural scan above validates lead/
            # continuation SHAPE only — a length-complete sequence can still
            # be invalid UTF-8 (overlong like f0 88 8f 83, surrogates,
            # > U+10FFFF). Those become U+FFFD instead of crashing the
            # stream, consistent with the byte-level recovery path.
            return out[:checkpoint].decode("utf-8", errors="replace")
        return None
