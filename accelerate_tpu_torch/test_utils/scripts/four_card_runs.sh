#!/usr/bin/env bash
# The four-card runs of the PyTorch port, from the repository root on a
# host with four cards (one process a card, NCCL):
#
#   bash accelerate_tpu_torch/test_utils/scripts/four_card_runs.sh [sanity|full|shallow|all|supervise|serve|fp8|disagg|fleet|control]
#
# sanity:  the sanity script (test_script.py) under --tp_size 4 and under
#          --tp_size 2 --dp_shard_size 2
# full:    train_timing.py on Llama-3-8B at full depth (32 layers), global
#          batch 4 x 2048: TP 4, TP 2 x FSDP2 2, FSDP2 4
# shallow: the same at 4 layers under DDP 4, FSDP2 4 and HSDP 2 x 2
# supervise (not part of all): the supervised fine-tune of
#          crash_resume_script.py on Llama-3-8B at 4 layers under FSDP2 4,
#          uninterrupted and with rank 2 killed at the end of step 2 on the
#          first attempt (--max_restarts 1 --watchdog_timeout 300, a save
#          after step 1): all four ranks restart and must end on the
#          uninterrupted run's losses and every rank's parameters bit for
#          bit; then elastic_recovery_script.py at 1 layer: FSDP2 4 with a
#          synchronous replica, rank 3 lost after the commit, the tree
#          wiped, a relaunch at 2 cards (FSDP2 2, --elastic) restoring
#          from the replica, held bit for bit against a 2-card run that
#          loads the replica directly (1 row a rank: the global batch and
#          the loader's position change)
# serve (not part of all): serve_timing.py, static generate of Llama-3-8B at
#          32 layers (bf16, B = 8, 512 + 128 tokens, the decode step one CUDA
#          graph with its NCCL collectives) under TP 4 and TP 2 x FSDP2 2,
#          rank 0's greedy tokens held against card 0's unsharded model;
#          then the continuous server (--mode continuous: chip_smoke.py
#          phase 4's server and 16-request mix, the engine's programs
#          captured with their collectives) under the same two layouts
# fp8 (not part of all): train_timing.py at 32 layers under TP 4 and FSDP2 4,
#          each in bf16 and then with --mixed_precision fp8 (ops/fp8.py: the
#          projections on the fp8 tensor cores, their scales all-reduced
#          over the mesh), on the same cards
# disagg (not part of all): disagg_timing.py, chip_smoke.py phase 4's model
#          (32 layers) and mix with each prompt forward run by a prefill
#          process on cuda:1 and shipped over TCPTransport (loopback) to the
#          continuous server on cuda:0; tokens bitwise the one-card run's
#          (chiprun_out/disagg_timing.json)
# fleet (not part of all): fleet_timing.py, one continuous server a card
#          (phase 4's server and kind of mix, 64 requests, each card its own
#          copy of the 32-layer model) behind one FleetRouter: the mix on
#          cuda:0 alone, through the fleet (tokens bitwise), and with r0's
#          worker killed mid-decode (every request finished on the others,
#          bitwise) (chiprun_out/fleet_timing.json)
# control (not part of all): control_timing.py, the SLO controller over a
#          fleet that starts with one replica on cuda:0 and whose
#          replica_factory takes the next idle card (max_replicas 4, each
#          card its own copy of the 32-layer model), through a seeded ramp
#          -> flash crowd -> drain of phase 7's mix scaled to four cards;
#          then four static replicas over the same arrivals: replica-seconds
#          and TTFT p99 against the SLO for both (chiprun_out/control_timing.json)
# Each timing run writes chiprun_out/train_timing_<layout>_<layers>l.json
# (fp8: train_timing_<layout>_32l_fp8.json)
# (serve: serve_timing_<layout>_32l.json and
# serve_timing_continuous_<layout>_32l.json); the lines printed carry the
# card's name and power limit.
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
if [[ $what == fp8 ]]; then
  for layout in "--tp_size 4" "--dp_shard_size 4"; do
    # shellcheck disable=SC2086  # the layout is two words
    "${launch[@]}" $layout "$timing" --layers 32
    # shellcheck disable=SC2086
    "${launch[@]}" $layout "$timing" --layers 32 --mixed_precision fp8
  done
fi
if [[ $what == serve ]]; then
  serve=accelerate_tpu_torch/test_utils/scripts/serve_timing.py
  "${launch[@]}" --tp_size 4 "$serve" --layers 32
  "${launch[@]}" --tp_size 2 --dp_shard_size 2 "$serve" --layers 32
  "${launch[@]}" --tp_size 4 "$serve" --layers 32 --mode continuous
  "${launch[@]}" --tp_size 2 --dp_shard_size 2 "$serve" --layers 32 --mode continuous
fi
if [[ $what == fleet ]]; then
  python -m accelerate_tpu_torch.test_utils.scripts.fleet_timing --layers 32
fi
if [[ $what == control ]]; then
  python -m accelerate_tpu_torch.test_utils.scripts.control_timing --layers 32
fi
if [[ $what == disagg ]]; then
  python -m accelerate_tpu_torch.test_utils.scripts.disagg_timing --layers 32
fi
if [[ $what == supervise ]]; then
  crash=accelerate_tpu_torch/test_utils/scripts/crash_resume_script.py
  elastic=accelerate_tpu_torch/test_utils/scripts/elastic_recovery_script.py
  tmp=$(mktemp -d "${TMPDIR:-/tmp}/four_card_supervise.XXXXXX")
  trap 'rm -rf "$tmp"' EXIT
  out=chiprun_out/supervise
  common=(--preset llama3_8b --layers 4 --rows 4 --seq 2048 --lr 3e-4 --total_steps 4)
  "${launch[@]}" --dp_shard_size 4 "$crash" "${common[@]}" --project_dir "$tmp/ref" \
    --out "${out}_ref.json" --events "${out}_ref.events"
  rm -rf "$tmp/ref"
  "${launch[@]}" --dp_shard_size 4 --max_restarts 1 --watchdog_timeout 300 --monitor_interval 1 \
    "$crash" "${common[@]}" --project_dir "$tmp/crash" --save_at 1 \
    --fault train_step_end:kill:after=1 --fault_rank 2 --out "${out}_crash.json" \
    --events "${out}_crash.events" 2> >(tee "${out}_crash.stderr" >&2)
  rm -rf "$tmp/crash"
  ecommon=(--preset llama3_8b --layers 1 --rows 4 --seq 2048 --loader_batches 8 --per_process_rows 1)
  # the host-loss launch ends non-zero by design (rank 3 SIGKILLs itself)
  ACCELERATE_REPLICATION_SYNC=1 "${launch[@]}" --dp_shard_size 4 --replicate_to "$tmp/replica" \
    "$elastic" "${ecommon[@]}" --project_dir "$tmp/e" --phase host_loss --steps 2 --kill_rank 3 \
    || echo "host-loss launch exited $? (rank 3 killed after the commit)"
  rm -rf "$tmp/e/checkpoints"
  two=(python -m accelerate_tpu_torch.commands.launch --num_processes 2 --dp_shard_size 2)
  ACCELERATE_REPLICATION_SYNC=1 "${two[@]}" --elastic --replicate_to "$tmp/replica" "$elastic" \
    "${ecommon[@]}" --project_dir "$tmp/e" --phase resume --steps 2 --out "${out}_elastic.json" \
    2> >(tee "${out}_elastic.stderr" >&2)
  "${two[@]}" "$elastic" "${ecommon[@]}" --project_dir "$tmp/direct" --phase resume --steps 2 \
    --load_dir "$tmp/replica/r0/checkpoint_0" --out "${out}_direct.json"
  python - "$out" <<'PY'
import json, subprocess, sys
out = sys.argv[1]
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip().splitlines()[0]
ref, crash = (json.load(open(f"{out}_{k}.json")) for k in ("ref", "crash"))
events = [json.loads(l) for l in open(f"{out}_crash.events")]
death = [e["t"] for e in events if e["event"] == "step" and e["attempt"] == 0][-1]
first = [e["t"] for e in events if e["event"] == "step" and e["attempt"] == 1][0]
saved = next(e for e in events if e["event"] == "saved")
restarted = "restart 1/1" in open(f"{out}_crash.stderr").read()
ok_crash = (restarted and crash["attempt"] == 1 and crash["start"] == 1
            and crash["losses"] == ref["losses"][1:] and crash["checksum"] == ref["checksum"])
el, direct = (json.load(open(f"{out}_{k}.json")) for k in ("elastic", "direct"))
restored = "from replica" in open(f"{out}_elastic.stderr").read()
ok_elastic = (restored and el["resumed"] and el["num_processes"] == 2 and el["position"] == 4
              and el["losses"] == direct["losses"] and el["position"] == direct["position"])
summary = {"card": card, "crash_restart_bitwise": ok_crash, "losses": ref["losses"],
           "save_s": saved["save_s"], "restart_s": first - death,
           "elastic_4_to_2_bitwise": ok_elastic, "elastic_losses": el["losses"],
           "elastic_position": el["position"]}
print(json.dumps(summary), flush=True)
json.dump(summary, open(f"{out}_summary.json", "w"))
sys.exit(0 if ok_crash and ok_elastic else 1)
PY
fi
