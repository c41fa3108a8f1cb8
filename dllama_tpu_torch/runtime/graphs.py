"""Decode steps captured as CUDA graphs: the port's counterpart of the JAX
package's one compiled program per step (``plan_scoped_jit(greedy_step_guarded
/ sampled_step_guarded)``, ``dllama_tpu/runtime/engine.py:667-682``, and the
paged step, ``dllama_tpu/runtime/serving.py:1359-1361``).

An eager step launches some 3500-4800 kernels from Python, and the card
idles while the host enqueues them. A :class:`StepGraph` holds a step
function (its *body*) that reads static input tensors and writes static
output tensors. On a CUDA device it runs the body twice on a side stream
(the warm-up: it loads each kernel library through ``ctypes``, makes every
kernel's module resident and looks up the driver entry points, none of
which may happen for the first time inside a capture), then captures one
run into a private memory pool with ``torch.cuda.graph``; every
:meth:`StepGraph.replay` relaunches the whole step with one call. Capture
either succeeds or raises: nothing falls back to the eager step. Code that
wants the eager step calls ``models.llama.greedy_step`` / ``sampled_step`` /
``paged_sampled_step`` by name. On a CPU device a replay runs the body on
the same buffers, through the plain versions (the wrappers' device rule).

What makes a step capturable: its inputs keep their addresses (the static
buffers, the parameters, the KV cache or pool, which ``reset`` zeroes in
place), positions ride as device tensors, split counts come from shapes
alone, scratch comes from the graph's pool, and nothing in the step reads
a tensor back to the host.

Launch counts: each kernel wrapper counts its launches, and the bytes and
operations of each (``ops/cost.py``), in Python attributes, which a replay
does not run. The capture records each wrapper's counts in the captured
step (and takes them off the counters: they were recorded, not run), and
every replay adds them again, so the counters count what the card ran.

Compile ledger (``runtime/introspection.py``): a step built with a
``program`` files its capture there (signature, capture seconds, pool
bytes, and what one replay moves and computes through K1-K5); a step that
is not captured (the CPU, ``eager``) files its first run instead, and
every further replay is a hit.

:class:`DecodeGraph` is the single-sequence step of the engine (greedy or
sampled): the graph writes its picked token into its own input and
advances its device position, so a chunk of ``k`` tokens is ``k`` replays
and one readback (``--decode-chunk K``). :class:`VerifyGraph` is the
engine's speculative verify step (``--spec-lookup K``, greedy): K+1 tokens
in, ``(n_acc, preds)`` out in one readback. Both carry the numerics
tripwire (``runtime/numerics.py``): the poison selector is a device scalar
filled before the replays (a fill, no synchronisation), and the non-finite
lane count comes back in the same readback as the tokens. The paged verify step of
continuous batching is a :class:`StepGraph` of
``runtime/serving.py::PagedGenerator``, captured once per pool geometry
(slots, K+1, table width), as the JAX package jits it once per geometry.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from . import introspection

WARMUP_RUNS = 2


def staging(t: torch.Tensor) -> torch.Tensor:
    """A host tensor to stage copies into ``t``: page-locked when ``t`` lies
    on the card, so that ``t.copy_(stage, non_blocking=True)`` needs no
    synchronisation. The caller rewrites it only after a readback has
    synchronised the stream that copied it."""
    return torch.zeros(t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda")


def load(dst: torch.Tensor, stage: torch.Tensor, values) -> None:
    """Copy host ``values`` into the static buffer ``dst`` through ``stage``."""
    stage.numpy()[...] = values
    dst.copy_(stage, non_blocking=True)


class StepGraph:
    """A step body captured once on a CUDA device and replayed; on the CPU,
    the body itself on every replay.

    ``prime`` (optional) puts the static inputs in a state where a run of
    the body writes nothing that is ever read, before each warm-up run.
    The capture runs in ``torch.cuda.graph``'s default global mode, which
    refuses unsafe CUDA calls from every thread while it lasts, so a step
    is captured before the threads that could make them start.
    ``capture_s`` is the host time of the warm-up and the capture;
    ``pool_bytes`` the device memory the private pool reserved.
    ``StepGraph.captures`` counts the captures of the process (a serving
    run captures its steps before it listens, and none after). With
    ``eager`` nothing is captured and every replay runs the body on the
    card too: the paged steps at ``tp > 1``, whose shards' steps are not
    captured yet. ``program`` (an :class:`~dllama_tpu_torch.runtime.introspection.Program`)
    and ``sig`` (its signature) file the capture, or the first run of a
    step that is not captured, in the compile ledger."""

    captures = 0

    def __init__(self, body: Callable[[], None], device, *,
                 prime: Callable[[], None] | None = None, eager: bool = False,
                 program: introspection.Program | None = None, sig: dict | None = None):
        self.body = body
        self.device = torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.per_replay: dict = {}  # wrapper -> (launches, bytes, ops) one replay adds
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.program, self.sig = program, dict(sig or {})
        if self.device.type == "cuda" and not eager:
            self._capture(prime)

    def _capture(self, prime) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    if prime is not None:
                        prime()
                    self.body()
            main.wait_stream(side)
            if prime is not None:
                prime()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            before = introspection.counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    self.body()
            finally:
                # the capture recorded these launches; replays run them
                self.per_replay = introspection.delta(before)
                for fn, (n, b, o) in before.items():
                    fn.launches, fn.moved_bytes, fn.ops = n, b, o
            torch.cuda.synchronize()
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        StepGraph.captures += 1
        if self.program is not None:
            self.program.captured(self.sig, self.capture_s, self.per_replay,
                                  self.pool_bytes, self.device)

    def replay(self) -> None:
        """One step, on the current stream; no synchronisation."""
        if self.graph is None:
            if self.program is None:
                self.body()
            else:
                self.program.run(0, self.body, sig=lambda: self.sig, device=self.device)
            return
        self.graph.replay()
        for fn, (n, b, o) in self.per_replay.items():
            fn.launches += n
            fn.moved_bytes += b
            fn.ops += o
        if self.program is not None:
            self.program.hit()

    def stats(self) -> dict:
        """Capture seconds, pool bytes and wrapper launches per replay."""
        return {"captured": self.graph is not None, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes,
                "launches_per_replay": {fn.__name__: n
                                        for fn, (n, _, _) in self.per_replay.items() if n}}


class DecodeGraph:
    """The engine's single-sequence decode step (``models.llama.greedy_step``
    or ``sampled_step`` over the dense cache ``kv``) on static buffers:
    the token ``[1, 1]``, the position ``[1]`` int32, the poison selector
    ``[1]`` f32, and for a sampled step temperature, top-p and one coin per
    position. A replay writes its pick to ``out[pos]``, adds its non-finite
    lane count to ``nf``, feeds the pick into ``tok`` and advances ``pos``,
    all on the device. The warm-up writes only cache row ``pos`` (the first
    row a decode writes, rewritten before it becomes visible)."""

    def __init__(self, params, cfg, kv, device, *, sampled: bool, pos: int,
                 program: introspection.Program | None = None):
        from ..models.llama import greedy_step, sampled_step

        dev = torch.device(device)
        self.sampled = sampled
        # the body closes over these tensors, never over self: a cycle
        # through the graph would keep the parameters and the cache alive
        # after the engine drops its graphs, until a garbage collection
        first = int(pos)
        tok = self.tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
        pos = self.pos = torch.full((1,), first, dtype=torch.int32, device=dev)
        out = self.out = torch.zeros(cfg.seq_len, dtype=torch.long, device=dev)
        poison = self.poison = torch.zeros(1, dtype=torch.float32, device=dev)
        nf = self.nf = torch.zeros(1, dtype=torch.long, device=dev)
        self._span = (0, 0)
        self.nonfinite = 0  # the last readback's non-finite lanes
        if sampled:
            temp = self.temp = torch.zeros(1, dtype=torch.float32, device=dev)
            topp = self.topp = torch.zeros(1, dtype=torch.float32, device=dev)
            coins = self.coins = torch.zeros(cfg.seq_len, dtype=torch.float32, device=dev)
            self._coins_host = staging(coins)

        def body() -> None:
            p = pos.long()
            if sampled:
                nxt, bad, _ = sampled_step(params, cfg, tok, pos, kv, temp, topp,
                                           coins.index_select(0, p), poison=poison)
            else:
                nxt, bad, _ = greedy_step(params, cfg, tok, pos, kv, poison=poison)
            nf.add_(bad)
            out.index_copy_(0, p, nxt)
            tok.copy_(nxt.view(1, 1))
            pos.add_(1)

        self.step = StepGraph(body, dev, prime=lambda: pos.fill_(first), program=program,
                              sig=introspection.signature(tok=tok, pos=pos, kv=kv,
                                                          sampled=sampled, mesh="none"))

    def launch(self, token: int, start_pos: int, k: int, temperature: float = 0.0,
               topp: float = 0.0, coins: np.ndarray | None = None,
               poison: float = 0.0) -> None:
        """Enqueue ``k`` steps from ``token`` at ``start_pos``: static inputs
        filled on the device, ``k`` replays, no synchronisation. ``poison``
        is the tripwire's selector for every step of the launch."""
        self.tok.fill_(int(token))
        self.pos.fill_(int(start_pos))
        self.poison.fill_(float(poison))
        self.nf.zero_()
        if self.sampled:
            self.temp.fill_(float(temperature))
            self.topp.fill_(float(topp))
            span = slice(start_pos, start_pos + k)
            load(self.coins[span], self._coins_host[span], coins)
        for _ in range(k):
            self.step.replay()
        self._span = (start_pos, start_pos + k)

    def tokens(self) -> list[int]:
        """The last launch's tokens: the one readback of a chunk, which also
        brings back the launch's non-finite lane count (``nonfinite``)."""
        lo, hi = self._span
        got = torch.cat([self.out[lo:hi], self.nf]).tolist()
        self.nonfinite = got[-1]
        return got[:-1]


class VerifyGraph:
    """The engine's single-sequence speculative verify step
    (``models.llama.verify_step`` over the dense cache ``kv``) on static
    buffers: the tokens ``[1, K+1]`` (the committed token and K drafts) and
    the start position ``[1]`` int32 and the poison selector ``[1]`` f32. A
    replay writes ``[n_acc, preds..., nonfinite]`` (``K + 3`` int64) to
    ``out``, read back in one transfer. The warm-up
    writes cache rows ``pos .. pos + K`` at the position of the capture,
    which the first verify there writes again before they become
    visible."""

    def __init__(self, params, cfg, kv, device, *, width: int, pos: int,
                 program: introspection.Program | None = None):
        from ..models.llama import verify_step

        dev = torch.device(device)
        # the body closes over tensors only (see DecodeGraph)
        first = int(pos)
        tok = self.tok = torch.zeros((1, width), dtype=torch.long, device=dev)
        pos = self.pos = torch.full((1,), first, dtype=torch.int32, device=dev)
        out = self.out = torch.zeros(width + 2, dtype=torch.long, device=dev)
        poison = self.poison = torch.zeros(1, dtype=torch.float32, device=dev)
        self._tok_host = staging(tok)

        def body() -> None:
            n_acc, preds, nf, _ = verify_step(params, cfg, tok, pos, kv, poison=poison)
            out[:1].copy_(n_acc)
            out[1:width + 1].copy_(preds[0])
            out[width + 1:].copy_(nf)

        self.step = StepGraph(body, dev, prime=lambda: pos.fill_(first), program=program,
                              sig=introspection.signature(tok=tok, pos=pos, kv=kv,
                                                          mesh="none"))

    def run(self, tokens, start_pos: int, poison: float = 0.0
            ) -> tuple[int, list[int], int]:
        """One verify of ``tokens`` (``K + 1`` ids) at ``start_pos``:
        ``(n_acc, preds, nonfinite)``."""
        load(self.tok, self._tok_host, np.asarray(tokens, dtype=np.int64).reshape(1, -1))
        self.pos.fill_(int(start_pos))
        self.poison.fill_(float(poison))
        self.step.replay()
        got = self.out.tolist()
        return got[0], got[1:-1], got[-1]
