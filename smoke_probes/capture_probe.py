"""The single-sequence path's host times on one card, for comparing two
trees in turns: engine load, prefill, the first decode step (which
captures the step's CUDA graph) and the steady steps, f32 and bf16, twice
in one process. Run from the root of the tree to time (the package of the
current directory is imported), with this checkout's ``chip_smoke.py``
writing the 32-layer model into ASSETS once:

    python3 CHANGE/smoke_probes/capture_probe.py TAG ASSETS

Prints one ``CP {...}`` line. ``smoke_probes/capture_ab.sh PARENT_TREE``
runs it parent, change, change, parent."""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dllama_tpu_torch.formats.quants import Q80  # noqa: E402
from dllama_tpu_torch.ops import cuda_build  # noqa: E402
from dllama_tpu_torch.runtime.engine import InferenceEngine  # noqa: E402

tag, assets = sys.argv[1], sys.argv[2]
os.makedirs(assets, exist_ok=True)
model, tok = os.path.join(assets, "m.m"), os.path.join(assets, "t.t")
if not os.path.exists(model):
    cs.write_tokenizer(tok)
    cs.write_model(model, 32)
cuda_build.build()
out = {"tag": tag, "card": cs.card_line()}
for rep in range(2):
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        eng = InferenceEngine(model, tok, device="cuda", max_seq_len=cs.MAX_SEQ, sync_type=Q80,
                              compute_dtype=dt, temperature=0.0, seed=cs.SEED)
        load_s = time.perf_counter() - t0
        r = eng.generate(eng.tokenizer.encode(cs.PROMPT), 64, stop_on_eos=False)
        pred = [s.ms for s in r.steps if s.kind == "pred"]
        out[f"{dt}_{rep}"] = dict(load_s=round(load_s, 3), eval_ms=round(r.eval_ms, 2),
                                  first_pred_ms=round(pred[0], 2),
                                  steady_ms=round(statistics.median(pred[1:]), 3),
                                  capture_s=round(eng._graphs[False].step.capture_s, 4),
                                  tok_s=round(r.pred_tok_per_s, 2))
        eng.close()
        torch.cuda.empty_cache()
print("CP " + json.dumps(out), flush=True)
