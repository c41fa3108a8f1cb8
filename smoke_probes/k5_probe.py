"""Kernel K5's tuning probes on the card (``csrc/moe_matmul.cu``).

    python3 smoke_probes/k5_probe.py splits
    python3 smoke_probes/k5_probe.py variants NAME=OLD=>NEW [NAME=OLD=>NEW ...]
    python3 smoke_probes/k5_probe.py turbo-profile

Run from the root of a checkout on a machine with one H100; it imports
``chip_smoke`` (its ``Timer``, shapes and random planes) and the port from
the current directory. ``splits`` times the tensor-core kernel at each
forced K split (1, 2, 3, 4, 8, 16 where K allows) on the main path's shapes:
the Qwen3-30B-A3B w1 experts at 8 and 64 rows (exact and fast), dense bf16
experts at 64 rows, the 8B turbo w1 linear at M = 1, 8, 128; ``SPLIT``
lines. ``variants`` builds ``csrc/moe_matmul.cu`` as it is (``base``) and,
for each argument, a copy with the text OLD replaced by NEW
(``csrc/moe_matmul_NAME.cu``, removed afterwards), then times the same cases
on each library in turns (base first and last) and checks each against the
plain version; ``TAB`` lines. ``turbo-profile`` profiles the 8-layer 8B
copy's prefill chunks and decode steps (``chip_smoke.engine_profile``, bf16)
under ``--quant-mode`` fast, turbo and turbo16, fast again; ``PROF`` lines.
Every run prints the card's name and power limit first."""
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dllama_tpu_torch.ops import cuda_build, turbo  # noqa: E402
from dllama_tpu_torch.ops import moe_matmul as mm  # noqa: E402
from dllama_tpu_torch.ops.linear import dequantize_weight  # noqa: E402


def cases(g: torch.Generator) -> list:
    """(label, x, planes, offsets, decoder, fast) on the main path's shapes."""
    out = []
    for fast in (False, True):
        we = cs.random_expert_planes(cs.MOE_DIM, cs.MOE_HIDDEN, fast, g)
        for n_tok in (1, cs.SLOTS):
            off, _ = cs.routed_offsets(n_tok, g)
            x = torch.randn((n_tok * cs.MOE_ACTIVE, cs.MOE_DIM), generator=g, device="cuda")
            out.append((f"q w1 rows={n_tok * cs.MOE_ACTIVE} {'fast' if fast else 'exact'}",
                        x.to(torch.bfloat16 if fast else torch.float32), we, off, "q", fast))
        if fast:
            dense = dequantize_weight(we, torch.float32).to(torch.bfloat16)
            off, _ = cs.routed_offsets(cs.SLOTS, g)
            x = torch.randn((cs.SLOTS * cs.MOE_ACTIVE, cs.MOE_DIM), generator=g, device="cuda")
            out.append(("dense bf16 w1 rows=64", x.to(torch.bfloat16), dense, off, "dense",
                        False))
    qw = cs.random_planes(cs.DIM, cs.HIDDEN, True, g)
    for a8 in (True, False):
        tw = turbo.derive_turbo(qw, a8=a8)
        stack = turbo.TurboWeight(tw.w8[None], tw.scale[None], a8)
        for M in (1, 8, 128):
            x = torch.randn((M, cs.DIM), generator=g, device="cuda").to(torch.bfloat16)
            out.append((f"turbo {'a8' if a8 else 'a16'} w1 M={M}", x, stack, None,
                        "a8" if a8 else "a16", False))
    return out


def splits() -> None:
    timer, real = cs.Timer(), mm._moe_splits
    try:
        for label, x, we, off, dec, fast in cases(torch.Generator(device="cuda").manual_seed(99)):
            chunks = -(-mm._planes(we, dec)[1] // mm._KC)
            seen = set()
            for want in (1, 2, 3, 4, 8, 16):
                per = -(-chunks // min(want, chunks))
                plan = (-(-chunks // per), per * mm._KC)
                if plan in seen:
                    continue
                seen.add(plan)
                mm._moe_splits = lambda *a, plan=plan: plan
                ms = timer(lambda: mm.moe_matmul(x, we, off, decoder=dec, fast=fast))
                print(f"SPLIT {label:24s} splits={plan[0]:2d} ms={ms:.4f}", flush=True)
    finally:
        mm._moe_splits = real


def variants(args: list[str]) -> None:
    src_dir = cuda_build.CSRC_DIR
    base = (src_dir / "moe_matmul.cu").read_text()
    names = {"base": "moe_matmul_base"}
    sources = {"base": base}
    for arg in args:
        name, rest = arg.split("=", 1)
        old, new = rest.split("=>", 1)
        if old not in base:
            raise SystemExit(f"variant {name}: {old!r} is not in csrc/moe_matmul.cu")
        names[name], sources[name] = f"moe_matmul_{name}", base.replace(old, new)
    libs = {}
    try:
        for v, n in names.items():
            (src_dir / f"{n}.cu").write_text(sources[v])
        print("build", cuda_build.build(tuple(names.values())), flush=True)
        for v, n in names.items():
            lib = cuda_build.load(n)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.dlt_moe_matmul.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.dlt_moe_matmul.restype = i
            libs[v] = lib
    finally:
        for n in names.values():
            (src_dir / f"{n}.cu").unlink(missing_ok=True)
    timer, table = cs.Timer(), {}
    real = getattr(mm._lib, "cached", None)
    try:
        for v in [*names, "base"]:
            mm._lib.cached = libs[v]
            for label, x, we, off, dec, fast in cases(torch.Generator(device="cuda")
                                                      .manual_seed(7)):
                want = mm.moe_matmul_plain(x, we, off, decoder=dec, fast=fast)
                got = mm.moe_matmul(x, we, off, decoder=dec, fast=fast)
                err = ((got - want).abs().max() / want.abs().max()).item()
                ms = timer(lambda: mm.moe_matmul(x, we, off, decoder=dec, fast=fast))
                table.setdefault(label, []).append(f"{v}={ms:.4f} ({err:.1e})")
    finally:
        mm._lib.cached = real
    for label, row in table.items():
        print("TAB", f"{label:24s}", "  ".join(row), flush=True)


def turbo_profile() -> None:
    import json

    with tempfile.TemporaryDirectory() as tmp:
        tok, model = os.path.join(tmp, "tok.t"), os.path.join(tmp, "llama31_8b_8l.m")
        cs.write_tokenizer(tok)
        cs.write_model(model, cs.LONG_LAYERS)
        for mode in ("fast", "turbo", "turbo16", "fast"):
            for rec in cs.engine_profile(model, tok, "bf16", quant_mode=mode):
                rec = {k: v for k, v in rec.items() if not k.startswith("top_ms")}
                print("PROF", mode, json.dumps(rec), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k5_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
          .stdout.strip(), flush=True)
    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    if cmd == "splits":
        splits()
    elif cmd == "variants":
        variants(sys.argv[2:])
    elif cmd == "turbo-profile":
        turbo_profile()
    else:
        raise SystemExit(__doc__)
