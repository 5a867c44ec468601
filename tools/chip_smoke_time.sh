#!/bin/bash
# Wall-clock time of `python3 chip_smoke.py` in each checkout given, one
# after another on the same card, to compare two trees' script times:
#
#     tools/chip_smoke_time.sh <checkout> [<checkout> ...]
#
# Run from the root of a checkout. Prints one line a run (its exit code
# and seconds); each run's output goes to <dir>/chip_smoke_time.<n>.txt,
# where <dir> is $CHIP_SMOKE_TIME_OUT (default build/). Exits non-zero if
# any run did.
set -u
out=$(realpath -m "${CHIP_SMOKE_TIME_OUT:-build}")
mkdir -p "$out"
status=0
n=0
for tree in "$@"; do
    n=$((n + 1))
    start=$(date +%s%N)
    (cd "$tree" && python3 chip_smoke.py) > "$out/chip_smoke_time.$n.txt" 2>&1
    rc=$?
    ms=$(( ($(date +%s%N) - start) / 1000000 ))
    echo "chip_smoke.py in $tree: rc=$rc, $((ms / 1000)).$(printf %03d $((ms % 1000))) s"
    [ "$rc" -eq 0 ] || status=1
done
exit $status
