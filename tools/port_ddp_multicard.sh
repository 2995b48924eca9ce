#!/bin/bash
# Data-parallel scaling of the port on one machine with four H100s:
# chip_smoke.py's NCCL world-1 phase and its multi-card phase (two ranks,
# then every card: DDP and the sharded update in f32 and int8, each in
# parity with the concatenated batch, per-rank profiles), then the
# training CLI under torch.distributed.run at world 1, 2 and 4 (fused
# full-width ResNet-18, B=128 per rank, 36,864 synthetic images, one
# epoch; the meter's global images/s and each rank's momentum bytes):
# the replicated update (DDP) and the sharded one
# (--train.update_sharding=sharded) with its gradient exchange in f32,
# bf16 and int8, unbucketed and in 25 MB buckets, each eager and in
# windows of 24 updates replayed as CUDA graphs (--train.steps_per_call=0,
# the auto window), all on the streamed feed (--data.device_resident=off);
# then tools/port_resident_multicard.py: --preset=resnet18_8chip_gb1024 on
# the device-resident feed and on the streamed one at world 1, 2 and 4.
# Run from the repository root:
#
#     bash tools/port_ddp_multicard.sh            # everything
#     bash tools/port_ddp_multicard.sh resident   # the gb1024 runs alone
#
# Logs and records go to chiprun_out/ddp_multicard_*; one line per CLI run
# goes to chiprun_out/ddp_multicard_cli.jsonl, one per gb1024 run to
# chiprun_out/resident_multicard.jsonl.
cd "$(dirname "$0")/.." || exit 1
mkdir -p chiprun_out
if [[ ${1:-} == resident ]]; then
  exec python3 tools/port_resident_multicard.py
fi
card=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -n 1)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 chip_smoke.py --only ddp_nccl_world1,ddp_nccl_multi_card \
  > chiprun_out/ddp_multicard_smoke.log 2> chiprun_out/ddp_multicard_smoke.err
echo "chip_smoke rc=$? secs=$(( $(date +%s) - t0 ))"
cp chiprun_out/chip_smoke.json chiprun_out/ddp_multicard_smoke.json
grep -E "NVIDIA|ddp_nccl_multi|sharded_(f32|int8)\] NVIDIA|^\{\"ok" \
  chiprun_out/ddp_multicard_smoke.log | cut -c1-900
SLICE="--preset=resnet18_cifar10 --model.fused_stages=all
  --model.fused_bwd=true --train.pallas_xent=true --data.dataset=synthetic
  --data.synthetic_train_size=36864 --data.synthetic_test_size=256
  --train.epochs=1 --train.log_every=1000 --data.device_resident=off"
: > chiprun_out/ddp_multicard_cli.jsonl
for n in 1 2 4; do
  for spc in 1 0; do
    for mode in replicated f32 bf16 int8 f32@25 bf16@25 int8@25; do
      wire=${mode%@*}
      mb=0
      [[ $mode == *@* ]] && mb=${mode#*@}
      knobs=""
      if [[ $mode != replicated ]]; then
        knobs="--train.update_sharding=sharded --train.bucket_mb=$mb"
        [[ $wire != f32 ]] && knobs="$knobs --train.collective_dtype=$wire"
      fi
      t0=$(date +%s)
      log=chiprun_out/ddp_multicard_cli${n}_spc${spc}_${mode/@/_}.log
      # shellcheck disable=SC2086
      timeout 300 python -m torch.distributed.run --standalone \
        --nproc_per_node=$n -m tpu_dp_torch.train $SLICE $knobs \
        --train.steps_per_call=$spc \
        --train.ckpt_dir=build/ddp_multicard_ckpt \
        > "$log" 2>&1
      rc=$?
      secs=$(( $(date +%s) - t0 ))
      echo "cli world $n steps_per_call $spc $mode rc=$rc secs=$secs"
      last=$(tail -n 1 "$log")
      echo "$last" | cut -c1-400
      if [[ $last == \{* ]]; then
        echo "{\"world\": $n, \"steps_per_call\": $spc, \"mode\": \"$mode\"," \
          "\"rc\": $rc, \"card\": \"$card\", \"summary\": $last}" \
          >> chiprun_out/ddp_multicard_cli.jsonl
      fi
      rm -rf build/ddp_multicard_ckpt
    done
  done
done
python3 tools/port_resident_multicard.py
