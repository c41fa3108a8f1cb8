"""Synchronisations per paged decode step of one package tree.

    python3 smoke_probes/syncs.py ROOT MODEL TOKENIZER

Imports ``dllama_tpu_torch`` from the tree at ROOT, fills 8 slots of a
``PagedGenerator`` (block 16) on MODEL at ``--max-seq-len 2048``, captures
its step and counts the synchronising CUDA calls of 8 ``step()`` calls under
``torch.cuda.set_sync_debug_mode("warn")``. Prints one ``SYNCS {...}`` line.
Needs a CUDA card; run it once per tree (``ab_serving.sh`` does)."""
import json
import sys
import warnings

root, model, tok = sys.argv[1:4]
sys.path.insert(0, root)
import torch  # noqa: E402

from dllama_tpu_torch.formats.quants import Q80  # noqa: E402
from dllama_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402
from dllama_tpu_torch.runtime.serving import PagedGenerator, Request  # noqa: E402

PROMPT = ("The quick brown fox jumps over the lazy dog while the synthetic "
          "model answers with whatever its random weights prefer; " * 4)
eng = InferenceEngine(model, tok, device="cuda", max_seq_len=2048, sync_type=Q80,
                      temperature=0.0, kv_block_size=16)
gen = PagedGenerator(eng, 8)
gen.capture()
ids = eng.tokenizer.encode(PROMPT)
for i in range(8):
    gen.admit(Request(rid=i, prompt_ids=ids[: 40 + 20 * i], max_tokens=64,
                      stop_on_eos=False), i)
gen.step()
torch.cuda.synchronize()
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    for _ in range(8):
        gen.step()
    torch.cuda.set_sync_debug_mode("default")
# the mode's one-time "prototype feature" notice is not a synchronisation
msgs = [str(w.message) for w in caught
        if "called a synchronizing CUDA operation" in str(w.message)]
print("SYNCS " + json.dumps(dict(root=root, steps=8, syncs=len(msgs))), flush=True)
