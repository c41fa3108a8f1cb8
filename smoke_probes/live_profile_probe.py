"""The live profile of batched serving, 12 times in a row on one card: the
4-layer 8B copy served by the port's api (``chip_smoke.serve_run`` with its
16 clients), then ``chip_smoke.profile_live`` (``POST
/debug/profile?ms=500&ops=1`` while a 256-token request decodes) again and
again; one ``LIVE`` line a window (status, steps seen, lanes, seconds).
Run from the root of a checkout:

    python3 smoke_probes/live_profile_probe.py"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from dllama_tpu_torch.ops import cuda_build  # noqa: E402

print(cs.card_line(), flush=True)
cuda_build.build()
with tempfile.TemporaryDirectory() as tmp:
    model, tok, _ = cs.write_assets(tmp, 4)
    out = []

    def observe(url, gen, reqs, replays):
        for i in range(12):
            t0 = time.perf_counter()
            r = cs.profile_live(url)
            att = r["body"].get("op_attribution", {})
            out.append(dict(i=i, status=r["status"], steps=r["body"].get("n_steps"),
                            lanes=att.get("n_lanes"), s=round(time.perf_counter() - t0, 2)))
            print("LIVE", json.dumps(out[-1]), flush=True)
        return {}

    cs.serve_run(model, tok, 4, "f32", [], observe=observe, first=cs.WIDTHS_BODY)
print("DONE", json.dumps(out), flush=True)
