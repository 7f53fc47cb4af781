#!/bin/bash
# Criteo Kaggle DAC full training on the port (the twin of
# bench_scripts/dlrm_criteo_kaggle.sh; bench/dlrm_s_criteo_kaggle.sh
# equivalent). Expects the raw train.txt at ./input/train.txt (kaggle
# display-ad challenge).
set -u
cd "$(dirname "$0")/../.."
dlrm_extra_option=${*:-}

python -m dlrm_tpu_torch.cli \
  --arch-sparse-feature-size=16 --arch-mlp-bot=13-512-256-64-16 \
  --arch-mlp-top=512-256-1 --data-generation=dataset --data-set=kaggle \
  --raw-data-file=./input/train.txt \
  --processed-data-file=./input/kaggle_processed/ready \
  --loss-function=bce --round-targets=True --learning-rate=0.1 \
  --mini-batch-size=128 --print-freq=1024 --print-time \
  --test-mini-batch-size=16384 --test-freq=30000 \
  $dlrm_extra_option 2>&1 | tee run_kaggle_torch.log
