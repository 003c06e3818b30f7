#!/usr/bin/env bash
# Data-parallel training on the GPUs of one machine, one process a GPU
# (parity surface: reference tools/dist_train.sh):
#
#   kgdet_tpu_torch/tools/dist_train.sh CONFIG GPUS [tools/train.py args...]
#
# torchrun starts GPUS processes with RANK, WORLD_SIZE, LOCAL_RANK and a
# free rendezvous port; each joins the group through --distributed and
# takes train_data.batch_size / GPUS images a step.
set -euo pipefail

CONFIG=$1
GPUS=$2
shift 2

ROOT=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec torchrun --standalone --nproc_per_node="$GPUS" \
  -m kgdet_tpu_torch.tools.train "$CONFIG" --distributed "$@"
