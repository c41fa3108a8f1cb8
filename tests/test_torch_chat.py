"""``python -m dllama_tpu_torch chat`` (the REPL, ``serve/cli.py::run_chat``)
on the CPU, through the CLI's ``main`` with stdin patched, held against the
JAX package's ``run_chat`` on the same files at temperature 0: each streamed
reply equals JAX's, EOF ends the REPL with exit 0, ``--chat-template``
forces the family, and a line that would fill the context stops the REPL
with the context-full message."""

from __future__ import annotations

import io
import re

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.serve import cli as jax_cli
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chat")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=1024),
                     np.random.default_rng(13))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    # a byte the random model emits, as a second EOS, so that replies end
    # before the context does
    td.eos_token_ids = td.eos_token_ids + [ord("6")]
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


def _chat(main, files, lines, monkeypatch, capsys, *extra) -> tuple[int, str]:
    m, t = files
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(l + "\n" for l in lines)))
    rc = main(["chat", "--model", m, "--tokenizer", t, "--temperature", "0",
               "--seed", "1", *extra])
    return rc, capsys.readouterr().out


def _replies(out: str) -> list[str]:
    """The text after each "🤖 " marker, up to the next prompt."""
    return [re.split(r"\n💻 > |\n🚧", part, maxsplit=1)[0]
            for part in out.split("🤖 ")[1:]]


@pytest.mark.parametrize("template", [None, "chatml"])
def test_chat_replies_match_jax(files, monkeypatch, capsys, template):
    lines = ["hello there", "", "tell me more"]
    extra = ["--chat-template", template] if template else []
    rc, out = _chat(cli.main, files, lines, monkeypatch, capsys, "--device", "cpu", *extra)
    assert rc == 0
    jrc, jout = _chat(jax_cli.main, files, lines, monkeypatch, capsys, "--tp", "1", *extra)
    assert jrc == 0
    got, want = _replies(out), _replies(jout)
    assert got == want and all(got)
    # llama3's replies end at an EOS and both turns run; chatml's first
    # reply runs to the context end, and the second line finds it full
    assert len(got) == (2 if template is None else 1)


def test_chat_stops_when_the_context_is_full(files, monkeypatch, capsys):
    lines = ["hi", "x" * 1100, "never read"]
    rc, out = _chat(cli.main, files, lines, monkeypatch, capsys, "--device", "cpu")
    assert rc == 0
    assert "🚧 context is full (seq_len reached), stopping" in out
    assert out.count("🤖 ") == 1
