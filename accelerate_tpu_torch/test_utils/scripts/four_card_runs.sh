#!/usr/bin/env bash
# The four-card runs of the PyTorch port, from the repository root on a
# host with four cards (one process a card, NCCL):
#
#   bash accelerate_tpu_torch/test_utils/scripts/four_card_runs.sh [sanity|full|shallow|all]
#
# sanity:  the sanity script (test_script.py) under --tp_size 4 and under
#          --tp_size 2 --dp_shard_size 2
# full:    train_timing.py on Llama-3-8B at full depth (32 layers), global
#          batch 4 x 2048: TP 4, TP 2 x FSDP2 2, FSDP2 4
# shallow: the same at 4 layers under DDP 4, FSDP2 4 and HSDP 2 x 2
# Each timing run writes chiprun_out/train_timing_<layout>_<layers>l.json;
# the lines printed carry the card's name and power limit.
set -euo pipefail
what=${1:-all}
launch=(python -m accelerate_tpu_torch.commands.launch --num_processes 4)
timing=accelerate_tpu_torch/test_utils/scripts/train_timing.py
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# build the kernels once, before four processes load them
python -c "from accelerate_tpu_torch.ops import _build; print(_build.build_all())"
if [[ $what == sanity || $what == all ]]; then
  "${launch[@]}" --tp_size 4 accelerate_tpu_torch/test_utils/scripts/test_script.py
  "${launch[@]}" --tp_size 2 --dp_shard_size 2 accelerate_tpu_torch/test_utils/scripts/test_script.py
fi
if [[ $what == full || $what == all ]]; then
  "${launch[@]}" --tp_size 4 "$timing" --layers 32
  "${launch[@]}" --tp_size 2 --dp_shard_size 2 "$timing" --layers 32
  "${launch[@]}" --dp_shard_size 4 "$timing" --layers 32
fi
if [[ $what == shallow || $what == all ]]; then
  "${launch[@]}" --dp_replicate_size 4 "$timing" --layers 4
  "${launch[@]}" --dp_shard_size 4 "$timing" --layers 4
  "${launch[@]}" --dp_replicate_size 2 --dp_shard_size 2 "$timing" --layers 4
fi
