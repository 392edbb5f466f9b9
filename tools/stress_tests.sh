#!/bin/bash
# Run the same pytest selection many times at once, to find an intermittent
# hang: WORKERS copies in parallel per round, ROUNDS rounds, each copy under
# a time limit. A copy that hits the limit (rc 124) is a hang; its output
# (with a faulthandler dump of every thread) is kept.
#
#   tools/stress_tests.sh ROOT WORKERS ROUNDS LIMIT_S PYTEST_ARGS...
#   tools/stress_tests.sh . 6 4 150 tests/test_torch_winograd.py \
#       -k test_strategy_gradients_match_jax_winograd
#
# Prints one line per copy ("round R copy W rc N S s") and the count of
# hangs; the logs go to $STRESS_LOG_DIR (default: a new temporary directory).
set -u
root=$1 workers=$2 rounds=$3 limit=$4
shift 4
logs=${STRESS_LOG_DIR:-$(mktemp -d)}
mkdir -p "$logs"
cd "$root" || exit 2
for round in $(seq "$rounds"); do
  for w in $(seq "$workers"); do
    (
      start=$(date +%s)
      JAX_PLATFORMS=cpu timeout "$limit" python -m pytest "$@" -q -p no:cacheprovider \
        -p no:randomly -o faulthandler_timeout=$((limit / 2)) \
        > "$logs/round${round}_copy${w}.log" 2>&1
      echo "round $round copy $w rc $? $(( $(date +%s) - start )) s"
    ) &
  done
  wait
done | tee "$logs/summary.txt"
echo "hangs (rc 124): $(grep -c 'rc 124' "$logs/summary.txt") of $((workers * rounds)); logs in $logs"
