#!/bin/bash
# ResNet-50 through the port's entry points on one H100, as a user runs
# them: the preset as given (30 epochs of the synthetic CIFAR-100 fallback,
# 1,024 images, no --device: the card), the same in windows of
# min(24, steps per epoch) updates replayed as CUDA graphs
# (--train.steps_per_call=0) at 24,576 images, one epoch, against its
# eager run; serving the random-weight model; serving the first run's
# checkpoint. Run from the repository root:
#
#     bash tools/port_r50_cli.sh
#
# Logs go to chiprun_out/r50_cli_*.log; each run's last line is its JSON.
cd "$(dirname "$0")/.." || exit 1
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
SLICE="--preset=resnet50_cifar100 --model.fused_stages=all
  --model.fused_bwd=true --train.pallas_xent=true --data.root=$tmp/no_data"
run() {  # name, then the command
  local name=$1 t0
  shift
  t0=$(date +%s)
  timeout 600 "$@" > "chiprun_out/r50_cli_$name.log" 2>&1
  echo "$name rc=$? secs=$(( $(date +%s) - t0 ))"
  tail -n 1 "chiprun_out/r50_cli_$name.log" | cut -c1-1200
}
# shellcheck disable=SC2086
run preset python -m tpu_dp_torch.train $SLICE --train.ckpt_dir="$tmp/ck"
for spc in 1 0; do
  # shellcheck disable=SC2086
  run "spc$spc" python -m tpu_dp_torch.train $SLICE --train.epochs=1 \
    --data.synthetic_train_size=24576 --train.log_every=1000 \
    --train.steps_per_call=$spc --train.ckpt_dir="$tmp/ck_spc$spc"
done
run serve python -m tpu_dp_torch.serve --model=resnet50
run serve_ckpt python -m tpu_dp_torch.serve --ckpt="$tmp/ck"
for name in serve serve_ckpt; do  # their report is indented JSON
  python3 -c 'import json, sys
t = open(sys.argv[1]).read()
r = json.loads(t[t.index("{"):])
print(sys.argv[1], json.dumps({"latency_ms": r["latency_ms"],
      "verdict": r["verdict"]["ok"], "batches": r["batches"],
      "classes": len(r["device_stats"]["class_counts"])}))' \
    "chiprun_out/r50_cli_$name.log"
done
