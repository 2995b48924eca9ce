#!/bin/bash
# The preempt-and-resume sequence through the port's CLI on one H100, as a
# supervisor drives it: ResNet-18 (--preset=resnet18_cifar10 with the
# kernel knobs, synthetic data, 30 updates an epoch, 4 epochs, windows of
# 10, a snapshot every 10 updates). An uninterrupted control run; a run
# parked at its step-20 boundary by a delay fault and sent a real SIGTERM
# (exit 143, a committed snapshot, the flight recorder's dump), then
# --resume; a run killed by kill:step=41 (exit 137), then --resume. Each
# resumed run's final parameters are held against the control run's, and
# a second control run against the first gives the yardstick: the CLI
# leaves cuDNN's algorithm choice to cuDNN, so two uninterrupted runs
# already differ (chip_smoke.py phase 14 runs the same sequence with cuDNN
# deterministic and requires bitwise equality).
# Run from the repository root:
#
#     bash tools/port_resilience_cli.sh
#
# Logs go to chiprun_out/resilience_cli_*.log.
cd "$(dirname "$0")/.." || exit 1
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
ARGS="--preset=resnet18_cifar10 --model.fused_stages=all
  --model.fused_bwd=true --train.pallas_xent=true --data.dataset=synthetic
  --data.synthetic_train_size=3840 --data.synthetic_test_size=256
  --train.epochs=4 --train.log_every=100 --train.steps_per_call=10
  --resilience.snapshot_every_steps=10"
run() {  # name, then the command
  local name=$1 t0
  shift
  t0=$(date +%s)
  timeout 600 "$@" > "chiprun_out/resilience_cli_$name.log" 2>&1
  echo "$name rc=$? secs=$(( $(date +%s) - t0 ))"
  tail -n 1 "chiprun_out/resilience_cli_$name.log" | cut -c1-600
}
for c in control control2; do
  # shellcheck disable=SC2086
  run "$c" python -m tpu_dp_torch.train $ARGS --train.ckpt_dir="$tmp/$c"
done

# A real SIGTERM at the step-20 boundary.
t0=$(date +%s)
# shellcheck disable=SC2086
python -m tpu_dp_torch.train $ARGS --train.ckpt_dir="$tmp/sig" \
  --resilience.fault=delay:step=20,ms=5000 \
  > chiprun_out/resilience_cli_sigterm.log 2>&1 &
pid=$!
for _ in $(seq 1 6000); do
  [ -f "$tmp/sig/snapshots/step_0000000020/meta.json" ] && break
  kill -0 "$pid" 2>/dev/null || break
  sleep 0.05
done
kill -TERM "$pid"
wait "$pid"
echo "sigterm rc=$? secs=$(( $(date +%s) - t0 ))"
tail -n 1 chiprun_out/resilience_cli_sigterm.log
ls "$tmp/sig/snapshots" "$tmp/sig/obs"
# shellcheck disable=SC2086
run sigterm_resume python -m tpu_dp_torch.train $ARGS \
  --train.ckpt_dir="$tmp/sig" --resume

# kill:step=41 (the boundary at 50), then --resume.
# shellcheck disable=SC2086
run kill python -m tpu_dp_torch.train $ARGS --train.ckpt_dir="$tmp/kill" \
  --resilience.fault=kill:step=41
# shellcheck disable=SC2086
run kill_resume python -m tpu_dp_torch.train $ARGS \
  --train.ckpt_dir="$tmp/kill" --resume

python3 - "$tmp" <<'PY'
import json, sys
import numpy as np
from tpu_dp_torch import serialization
from tpu_dp_torch.checkpoint import _walk_state_dict

def params(d):
    with open(f"{sys.argv[1]}/{d}/final_params.msgpack", "rb") as f:
        return dict(_walk_state_dict(serialization.msgpack_restore(f.read())))

ref = params("control")
for run in ("control2", "sig", "kill"):
    got = params(run)
    diff = max(float(np.abs(np.asarray(got[k]) - np.asarray(v)).max())
               for k, v in ref.items())
    same = all(np.asarray(got[k]).tobytes() == np.asarray(v).tobytes()
               for k, v in ref.items())
    print(json.dumps({"run": run, "final_params_bitwise_equal": same,
                      "max_abs_diff": diff}))
PY
