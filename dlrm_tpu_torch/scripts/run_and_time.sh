#!/bin/bash
# MLPerf v0.7-style run on the port (the twin of bench_scripts/run_and_time.sh;
# bench/run_and_time.sh equivalent): 128-dim tables, 40M max index range,
# SGD lr 1.0, bin loader, early stop at test AUC 0.8025. Check the log with
# python -m dlrm_tpu_torch.utils.compliance run_terabyte_mlperf_torch.log
set -u
cd "$(dirname "$0")/../.."
dlrm_extra_option=${*:-}

python -m dlrm_tpu_torch.cli \
  --arch-sparse-feature-size=128 --arch-mlp-bot=13-512-256-128 \
  --arch-mlp-top=1024-1024-512-256-1 --max-ind-range=40000000 \
  --data-generation=dataset --data-set=terabyte \
  --raw-data-file=./input/day \
  --processed-data-file=./input/terabyte_mlperf/ready \
  --loss-function=bce --round-targets=True --learning-rate=1.0 \
  --mini-batch-size=2048 --print-freq=2048 --print-time \
  --test-freq=102400 --test-mini-batch-size=16384 \
  --mlperf-logging --mlperf-auc-threshold=0.8025 \
  --mlperf-bin-loader \
  $dlrm_extra_option 2>&1 | tee run_terabyte_mlperf_torch.log

echo "done"
