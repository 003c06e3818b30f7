#!/usr/bin/env bash
# Data-parallel evaluation on the GPUs of one machine, one process a GPU
# (parity surface: reference tools/dist_test.sh):
#
#   kgdet_tpu_torch/tools/dist_test.sh CONFIG GPUS \
#       [--checkpoint STEP | --load-pth PTH] [tools/test.py args...]
#
# Each process infers its stride of the batches; the results are gathered
# onto every process and scored there; process 0 writes the JSON files and
# prints.
set -euo pipefail

CONFIG=$1
GPUS=$2
shift 2

ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec torchrun --standalone --nproc_per_node="$GPUS" \
  -m kgdet_tpu_torch.tools.test "$CONFIG" --distributed "$@"
