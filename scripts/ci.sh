#!/usr/bin/env bash
# Canonical checks (CPU backend, JAX_PLATFORMS=cpu; the GPU runs are
# chip_smoke.py and bench.py).
#   scripts/ci.sh fast   — budgeted suite (FAIL if > FAST_BUDGET_S), run on
#                          every change
#   scripts/ci.sh full   — + slow end-to-end goldens (~13 min, 2 workers)
#   scripts/ci.sh smoke  — chip_smoke.py on the attached GPU
#   scripts/ci.sh bench  — one-line JSON benchmark on the attached GPU
set -euo pipefail
cd "$(dirname "$0")/.."
FAST_BUDGET_S="${FAST_BUDGET_S:-240}"
case "${1:-fast}" in
  fast)
    start=$(date +%s)
    JAX_PLATFORMS=cpu python -m pytest tests/ -x -q -m "not slow"
    wall=$(( $(date +%s) - start ))
    echo "ci fast suite wall: ${wall}s (budget ${FAST_BUDGET_S}s)"
    if [ "$wall" -gt "$FAST_BUDGET_S" ]; then
      echo "ci: FAST SUITE OVER BUDGET (${wall}s > ${FAST_BUDGET_S}s)" >&2
      exit 3
    fi
    ;;
  full)
    start=$(date +%s)
    JAX_PLATFORMS=cpu python -m pytest tests/ -q
    echo "ci full suite wall: $(( $(date +%s) - start ))s"
    ;;
  smoke) exec python chip_smoke.py ;;
  bench) exec python bench.py ;;
  *) echo "usage: $0 {fast|full|smoke|bench}" >&2; exit 2 ;;
esac
