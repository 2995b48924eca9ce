"""``python -m tpu_dp_torch.obs`` — the obsctl forensic CLI (see obsctl.py)."""

import sys

from tpu_dp_torch.obs.obsctl import main

if __name__ == "__main__":
    sys.exit(main())
