#!/bin/bash
# Preprocess the raw Criteo 1TB day files out-of-core with the port (the
# twin of scripts/process_criteo_1tb.sh; the counterpart of
# torchrec_dlrm/scripts/process_Criteo_1TB_Click_Logs_dataset.sh: its three
# torchrec steps, tsv->npy, contiguous ids and the cross-day shuffle, in one
# streaming pass; day 23 is left unshuffled for the val/test split, same as
# the reference).
# Usage: bash dlrm_tpu_torch/scripts/process_criteo_1tb.sh <raw_dir> <output_dir>
set -ex
[ -z "$2" ] && { echo "usage: $0 <raw_dir> <output_dir>"; exit 1; }
# the port's package, wherever the script is called from
export PYTHONPATH="$(readlink -m "$(dirname "$0")/../..")${PYTHONPATH:+:$PYTHONPATH}"
date
python -m dlrm_tpu_torch.data.criteo_stream \
  --input-dir "$(readlink -m "$1")" \
  --output-dir "$(readlink -m "$2")" \
  --days 24 --data-randomize total --dataset-multiprocessing --make-bins
date
