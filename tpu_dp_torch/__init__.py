"""tpu_dp_torch — the PyTorch/CUDA port of `tpu_dp`, one slice at a time.

It trains the reference's `Net`, a CIFAR ResNet-18 whose stride-1
BasicBlock chains run on a hand-written Hopper (sm_90a) CUDA kernel
(`tpu_dp_torch.ops.conv_block`) and a ResNet-50 whose stride-1
bottlenecks run their 3x3 on it, on one card or data-parallel across
processes, saves and resumes checkpoints in the JAX package's format, and
serves (``python -m tpu_dp_torch.train``, ``python -m
tpu_dp_torch.serve``; ROADMAP.md has the queue). The package imports
torch and numpy, never jax, flax, msgpack or `tpu_dp`; its entry points
run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
