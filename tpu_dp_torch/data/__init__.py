"""Data of the port: CIFAR loading and the synthetic set, the sampler,
on-device augmentation and the host-batch feed."""
