"""Where a checkpoint's time goes in the port (`tpu_dp_torch.checkpoint`),
for the fused full-width ResNet-18 after two training steps (momentum
buffers present): each part of a save and of a verified load, timed
apart, median of ``--reps``.

    python tools/port_ckpt_costs.py            # on the card
    python tools/port_ckpt_costs.py --device cpu --batch 4   # rehearsal

Save, on the training thread: the device-to-host copies one tensor at a
time against one flat copy into pinned memory; the layout export
(OIHW→HWIO, (out, in)→(in, out)) done on the host from those copies; and
the whole `state_dict_of`, which does the layout on the device and one
flat pinned copy. Save, on the writer thread: encode, the integrity
manifest (payload and per-leaf sha256), the file write. Load: read, the
payload's sha256, decode, `restore_state` (layout, host-to-device). Prints
the card's name and power limit and one JSON line; the same record goes
to ``chiprun_out/port_ckpt_costs.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import hashlib

    import torch

    from tpu_dp_torch import checkpoint as ck
    from tpu_dp_torch import serialization
    from tpu_dp_torch.compat import export_params, export_variables
    from tpu_dp_torch.config import parse_cli
    from tpu_dp_torch.train.trainer import Trainer

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        print("port_ckpt_costs: no CUDA device", file=sys.stderr)
        return 1
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tmp = tempfile.TemporaryDirectory(prefix="port_ckpt_costs_")
    trainer = Trainer(parse_cli([
        "--preset=resnet18_cifar10", "--model.fused_stages=all",
        "--model.fused_bwd=true", "--train.pallas_xent=true",
        "--data.dataset=synthetic", f"--data.batch_size={args.batch}",
        f"--data.synthetic_train_size={2 * args.batch}",
        f"--data.synthetic_test_size={args.batch}",
        f"--train.ckpt_dir={tmp.name}"]), device=args.device)
    for batch in trainer.train_pipe:
        trainer.train_step(trainer.state, batch)
    sync()
    state = trainer.state
    model, opt = state.model, state.optimizer
    tensors = list(model.state_dict().values()) + [
        opt.state[p]["momentum_buffer"] for p in model.parameters()]

    def timed(fn):
        times, out = [], None
        for _ in range(args.reps):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), out

    def per_tensor():
        return [t.detach().to("cpu", copy=True) for t in tensors]

    def flat_pinned():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        host = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=cuda)
        host.copy_(flat)
        return host

    rec = {"card": card, "device": args.device, "batch": args.batch,
           "tensors": len(tensors),
           "bytes": sum(t.numel() * t.element_size() for t in tensors)}
    rec["d2h_per_tensor_ms"], host = timed(per_tensor)
    rec["d2h_flat_pinned_ms"], _ = timed(flat_pinned)
    sd = dict(zip(model.state_dict(), host))
    bufs = dict(zip([n for n, _ in model.named_parameters()],
                    host[len(sd):]))
    rec["host_export_ms"], _ = timed(
        lambda: (export_variables(sd), export_params(bufs)))
    rec["state_dict_of_ms"], tree = timed(lambda: ck.state_dict_of(state))
    rec["encode_ms"], payload = timed(lambda: serialization.to_bytes(tree))
    rec["manifest_ms"], _ = timed(
        lambda: ck._integrity_manifest(payload, tree))
    path = os.path.join(tmp.name, "state.msgpack")

    def write():
        with open(path + ".tmp", "wb") as f:
            f.write(payload)
        os.replace(path + ".tmp", path)

    rec["file_write_ms"], _ = timed(write)
    rec["payload_bytes"] = len(payload)
    rec["file_read_ms"], raw_bytes = timed(lambda: open(path, "rb").read())
    rec["payload_sha256_ms"], _ = timed(
        lambda: hashlib.sha256(raw_bytes).hexdigest())
    rec["decode_ms"], raw = timed(
        lambda: serialization.msgpack_restore(raw_bytes))
    rec["restore_state_ms"], _ = timed(lambda: ck.restore_state(state, raw))
    mgr = ck.CheckpointManager(os.path.join(tmp.name, "mgr"),
                               async_save=False)
    rec["manager_save_sync_ms"], _ = timed(lambda: mgr.save(state, {}))
    step_dir = mgr.latest_dir()
    rec["load_checkpoint_verified_ms"], _ = timed(
        lambda: ck.load_checkpoint(step_dir, state))
    tmp.cleanup()
    print(card)
    print(json.dumps(rec))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "port_ckpt_costs.json"),
              "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
