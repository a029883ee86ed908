#!/bin/bash
# Launch a PyTorch-port job on the GPUs of one host, or of several, under
# torchrun: one process (rank) a GPU, each on its shard of the data
# (multi_part_assembly_tpu_torch/parallel/dist.py).  Counterpart of
# scripts/tpu_run.sh.  `exp.batch_size` is a rank's batch: N GPUs train a
# global batch of N x 32 under a -32x1- config.
# Env knobs:
#   NUM_GPUS     - ranks on this host (default: every visible GPU)
#   NNODES       - hosts (default 1: --standalone rendezvous)
#   NODE_RANK    - this host's index (several hosts)
#   RDZV_ENDPOINT - host:port of the rendezvous (several hosts)
# Usage: ./scripts/gpu_run.sh scripts/train_torch.py job_name --cfg_file configs/...py [...]

PY_FILE=$1
JOB_NAME=$2
shift 2

if [ -z "$NUM_GPUS" ]; then
    NUM_GPUS=$(python -c 'import torch; print(max(1, torch.cuda.device_count()))')
fi
NNODES=${NNODES:-1}

if [ "$NNODES" -eq 1 ]; then
    torchrun --standalone --nproc_per_node="$NUM_GPUS" \
        "$PY_FILE" "$@" 2>&1 | tee "${JOB_NAME}.log"
else
    torchrun --nnodes="$NNODES" --node_rank="${NODE_RANK:?set NODE_RANK}" \
        --nproc_per_node="$NUM_GPUS" --rdzv_backend=c10d \
        --rdzv_endpoint="${RDZV_ENDPOINT:?set RDZV_ENDPOINT}" \
        "$PY_FILE" "$@" 2>&1 | tee "${JOB_NAME}.log"
fi
