#!/bin/bash
# Parent against change on one card: chip_smoke.py --ab (phase 4, the long
# sp cell at sp = 1, the paged step profile) in turns parent, change,
# change, parent, each side its own script, one shared model; the logs go to
# LOGS/ab_e2e_N_SIDE.log (default: a fresh temporary directory, printed).
# Run from the root of the change's tree with
# the parent's tree unpacked in a git-ignored directory:
#   git archive PARENT | tar -x -C probe/parent
#   bash smoke_probes/ab_e2e.sh probe/parent [LOGS]   # one H100
set -e
parent=${1:?usage: ab_e2e.sh PARENT_TREE [LOGS]}
here=$(pwd)
logs=${2:-$(mktemp -d)}
mkdir -p "$logs"
echo "logs: $logs"
assets=$(mktemp -d)
trap 'rm -rf "$assets"' EXIT
i=0
for side in parent change change parent; do
  i=$((i+1))
  if [ $side = parent ]; then d=$parent; else d=$here; fi
  (cd "$d" && python3 chip_smoke.py --ab $side --assets "$assets") \
    > "$logs/ab_e2e_${i}_$side.log" 2>&1
  grep -a "^AB " "$logs/ab_e2e_${i}_$side.log"
done
