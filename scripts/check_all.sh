#!/usr/bin/env bash
# Full gate set: run before calling any round done.
#   bash scripts/check_all.sh
set -uo pipefail
cd "$(dirname "$0")/.."

fail=0
step() { echo; echo "=== $1 ==="; }

step "pytest (CPU; the GPU kernel in Pallas interpret mode)"
JAX_PLATFORMS=cpu python -m pytest tests/ -q || fail=1

step "graft entry: single-chip compile + 8-device dryrun"
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
python -c "
import __graft_entry__ as g
import jax
fn, args = g.entry()
jax.jit(fn).lower(*args).compile()
g.dryrun_multichip(8)
print('graft OK')" || fail=1

step "differential campaign vs reference binary (200 cases)"
if [ -x /root/build-ref/needleman-wunsch ]; then
  NW_TPU_PLATFORM=cpu JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS=0.1 \
  python scripts/differential_campaign.py 200 || fail=1
else
  echo "reference binary missing; build per .claude/skills/verify/SKILL.md"
fi

step "on the GPU (run there): python chip_smoke.py; python bench.py"

echo
[ "$fail" = 0 ] && echo "ALL GATES GREEN" || echo "GATE FAILURES (see above)"
exit $fail
