#!/bin/bash
# Deterministic tiny-config golden test on the port (the twin of
# test_scripts/dlrm_tpu_test.sh; test/dlrm_s_test.sh equivalent).
#
# Each config runs through the port's trainer on the card and its log is
# held to the JAX package's golden log in test_scripts/golden/: the same
# text with every number within 5e-6 (golden_compare.py; the port's
# numbers are not byte-equal to JAX's). The goldens are only read: this
# script never writes them. The JAX script's first, discarded run of each
# config fills JAX's compile cache; the port has none, so it runs once.
set -u
cd "$(dirname "$0")/../.."

golden_dir=test_scripts/golden
status=0

run_config () {
  name=$1; shift
  log=$(mktemp)
  python -m dlrm_tpu_torch.cli "$@" 2>/dev/null > "$log"
  if [ ! -f "$golden_dir/$name.log" ]; then
    echo "$name: FAILED (no golden $golden_dir/$name.log)"
    status=1
  elif python -m dlrm_tpu_torch.scripts.golden_compare \
      "$golden_dir/$name.log" "$log"; then
    echo "$name: PASSED"
  else
    echo "$name: FAILED"
    status=1
  fi
  rm -f "$log"
}

# the four tiny configs of test/dlrm_s_test.sh:22-47
run_config tiny1 --mini-batch-size=1 --data-size=1
run_config tiny2 --mini-batch-size=2 --data-size=4 --nepochs=2
run_config tiny3 --mini-batch-size=2 --data-size=5 --nepochs=3 --debug-mode
run_config tiny4 --mini-batch-size=2 --data-size=6 --loss-function=bce --round-targets=True

exit $status
