#!/bin/bash
# Parent against change on one card: smoke_probes/capture_probe.py in turns
# parent, change, change, parent, one shared model. Run from the root of the
# change's tree with the parent's tree unpacked in a git-ignored directory:
#   git archive PARENT | tar -x -C probe/parent
#   bash smoke_probes/capture_ab.sh probe/parent   # one H100
set -e
parent=${1:?usage: capture_ab.sh PARENT_TREE}
here=$(pwd)
assets=$(mktemp -d)
trap 'rm -rf "$assets"' EXIT
for side in parent change change parent; do
  if [ $side = parent ]; then d=$parent; else d=$here; fi
  (cd "$d" && python3 "$here/smoke_probes/capture_probe.py" $side "$assets") 2>&1 | grep -a "^CP "
done
