#!/bin/bash
# Criteo Terabyte training on the port (the twin of
# bench_scripts/dlrm_criteo_terabyte.sh; bench/dlrm_s_criteo_terabyte.sh
# equivalent): 64-dim tables, 10M max index range. Expects raw
# day_0..day_23 files under ./input/day_*.
set -u
cd "$(dirname "$0")/../.."
dlrm_extra_option=${*:-}

python -m dlrm_tpu_torch.cli \
  --arch-sparse-feature-size=64 --arch-mlp-bot=13-512-256-64 \
  --arch-mlp-top=512-512-256-1 --max-ind-range=10000000 \
  --data-generation=dataset --data-set=terabyte \
  --raw-data-file=./input/day \
  --processed-data-file=./input/terabyte_processed/ready \
  --loss-function=bce --round-targets=True --learning-rate=0.1 \
  --mini-batch-size=2048 --print-freq=1024 --print-time \
  --test-mini-batch-size=16384 \
  $dlrm_extra_option 2>&1 | tee run_terabyte_torch.log
