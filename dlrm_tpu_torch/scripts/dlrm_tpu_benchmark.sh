#!/bin/bash
# Benchmark sweep on the port (the twin of bench_scripts/dlrm_tpu_benchmark.sh;
# bench/dlrm_s_benchmark.sh equivalent): random-data DLRM at the reference's
# bench shape (8 x 1M-row 64-dim tables, 100 idx/lookup, mb 2048) across
# batch sizes on the card, extracting min ms/it from the logs.
set -u
cd "$(dirname "$0")/../.."

outdir=${1:-bench_out}
mkdir -p "$outdir"

common="--arch-sparse-feature-size=64 \
  --arch-embedding-size=1000000-1000000-1000000-1000000-1000000-1000000-1000000-1000000 \
  --arch-mlp-bot=512-512-64 --arch-mlp-top=1024-1024-1024-1 \
  --data-generation=random --num-indices-per-lookup=100 \
  --num-indices-per-lookup-fixed=1 --num-batches=100 --print-freq=10 \
  --print-time --compute-dtype=bfloat16"

for mb in 2048 4096 8192; do
  log="$outdir/run_mb${mb}.log"
  echo "=== mini-batch $mb ==="
  python -m dlrm_tpu_torch.cli $common --mini-batch-size=$mb 2>&1 | tee "$log"
  # min ms/it across print windows (dlrm_s_benchmark.sh:78 extraction)
  min=$(grep -oE '[0-9.]+ ms/it' "$log" | awk '{print $1}' | sort -n | grep -v '^-' | head -1)
  echo "Min time per iteration = $min ms/it"
done
