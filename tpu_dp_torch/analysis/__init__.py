"""tpu_dp_torch.analysis — the run-time half of `tpu_dp.analysis`: the
`RecompileGuard` (`recompile.py`). The static linter waits for ROADMAP
Queue 1 item 13."""
