#!/bin/bash
# Parent against change on one card: the f32 paged serving run in turns
# parent, change, change, parent (ab_serving.py), then the synchronisations
# per paged step of each tree (syncs.py). Run from the root of the change's
# tree with the parent's tree unpacked in a git-ignored directory:
#   git archive PARENT | tar -x -C probe/parent
#   bash smoke_probes/ab_serving.sh probe/parent   # one H100
set -e
parent=${1:?usage: ab_serving.sh PARENT_TREE}
assets=$(mktemp -d)
trap 'rm -rf "$assets"' EXIT
python3 - "$assets" <<'PY'
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
d = sys.argv[1]
cs.write_tokenizer(os.path.join(d, "tok.t"))
cs.write_model(os.path.join(d, "m32.m"), 32)
cs.write_model(os.path.join(d, "m8.m"), 8)
PY
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for side in parent change change parent; do
  root=$parent; [ "$side" = change ] && root=.
  python3 smoke_probes/ab_serving.py "$root" "$assets/m32.m" "$assets/tok.t" "$side" | grep "^AB "
done
for root in "$parent" .; do
  python3 smoke_probes/syncs.py "$root" "$assets/m8.m" "$assets/tok.t" | grep "^SYNCS "
done
