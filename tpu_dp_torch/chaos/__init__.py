"""Chaos engineering for the port's resilience stack: `storage`, the
storage-fault shim behind the ``ioerr``/``torn``/``bitrot``/``slowfs``/
``enospc`` fault kinds (armed by `tpu_dp_torch.resilience.faultinject`,
consulted by `tpu_dp_torch.checkpoint`). Import-light on purpose: the
checkpoint writes reach the shim through ``sys.modules``, so a run that
never armed a storage fault never imports this package.
"""
