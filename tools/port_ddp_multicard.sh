#!/bin/bash
# Data-parallel scaling of the port on one machine with four H100s:
# chip_smoke.py's NCCL world-1 phase and its multi-card phase (two ranks,
# then every card: parity with the concatenated batch, per-rank profiles),
# then the training CLI under torch.distributed.run at world 1, 2 and 4
# (fused full-width ResNet-18, B=128 per rank, 98,304 synthetic images, one
# epoch; the meter's global images/s), each world eager and then in
# windows of 24 updates replayed as CUDA graphs (--train.steps_per_call=0,
# the auto window). Run from the repository root:
#
#     bash tools/port_ddp_multicard.sh
#
# Logs and records go to chiprun_out/ddp_multicard_*.
cd "$(dirname "$0")/.." || exit 1
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 chip_smoke.py --only ddp_nccl_world1,ddp_nccl_multi_card \
  > chiprun_out/ddp_multicard_smoke.log 2> chiprun_out/ddp_multicard_smoke.err
echo "chip_smoke rc=$? secs=$(( $(date +%s) - t0 ))"
cp chiprun_out/chip_smoke.json chiprun_out/ddp_multicard_smoke.json
grep -E "NVIDIA|ddp_nccl_multi|^\{\"ok" chiprun_out/ddp_multicard_smoke.log \
  | cut -c1-900
SLICE="--preset=resnet18_cifar10 --model.fused_stages=all
  --model.fused_bwd=true --train.pallas_xent=true --data.dataset=synthetic
  --data.synthetic_train_size=98304 --data.synthetic_test_size=2048
  --train.epochs=1 --train.log_every=1000"
for n in 1 2 4 1; do
  for spc in 1 0; do
    t0=$(date +%s)
    log=chiprun_out/ddp_multicard_cli${n}_spc$spc.log
    # shellcheck disable=SC2086
    timeout 300 python -m torch.distributed.run --standalone \
      --nproc_per_node=$n -m tpu_dp_torch.train $SLICE \
      --train.steps_per_call=$spc > "$log" 2>&1
    echo "cli world $n steps_per_call $spc rc=$? secs=$(( $(date +%s) - t0 ))"
    tail -n 1 "$log"
  done
done
