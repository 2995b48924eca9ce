"""Training and inference of the port: schedules, SGD, the steps and the
trainer (`python -m tpu_dp_torch.train`)."""
