"""One side of a same-card A/B of the f32 paged serving run.

    python3 smoke_probes/ab_serving.py ROOT MODEL TOKENIZER TAG

Runs ``serve_run`` of ROOT's own ``chip_smoke.py`` (the port's ``api
--batch-slots 8 --kv-block-size 16`` in process, 16 concurrent clients, 32
layers, f32) on the package of the tree at ROOT, after building its kernels.
Prints one ``AB {...}`` line: generated tok/s, step ms median, TTFT and
latency. Needs a CUDA card; ``ab_serving.sh`` runs the turns."""
import importlib.util
import json
import os
import sys

root, model, tok, tag = sys.argv[1:5]
root = os.path.abspath(root)
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)

import torch  # noqa: E402

from dllama_tpu_torch.ops import cuda_build  # noqa: E402

cuda_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
rec, _ = cs.serve_run(model, tok, 32, "f32", [])
print("AB " + json.dumps(dict(tag=tag, root=root, gen_tok_per_s=rec["gen_tok_per_s"],
                              step_ms_median=rec["step_ms_median"], steps=rec["steps"],
                              ttft_ms_p50=rec["ttft_ms_p50"], p50=rec["latency_ms_p50"],
                              p95=rec["latency_ms_p95"], tokens=rec["generated_tokens"])),
      flush=True)
