"""tpu_dp_torch — the PyTorch/CUDA port of `tpu_dp`, one slice at a time.

This slice serves a CIFAR ResNet-18 whose stride-1 BasicBlock chains run
on a hand-written Hopper (sm_90a) CUDA kernel
(`tpu_dp_torch.ops.conv_block`): ``python -m tpu_dp_torch.serve``. The
package imports torch and numpy, never jax and never `tpu_dp`; its entry
points run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
