"""Shared tmp-write-then-rename for the obs artifact writers (copy of
`tpu_dp.obs._atomic` for the PyTorch port, which never imports the JAX
package).

Every obs artifact — flight-recorder dumps, the hang-dump sentinel, the
Prometheus textfile, Perfetto traces — may be read by a scraper or a
postmortem while (or right after) the writing process dies; a reader
must see either the previous complete file or the new one, never a torn
half. One implementation instead of a per-writer copy, so a future
durability change (e.g. fsync-before-rename) lands everywhere at once.
Import-light on purpose (os + pathlib only): `flightrec` pulls this in
from signal-adjacent paths.
"""

from __future__ import annotations

import os
from pathlib import Path


def atomic_write_text(path: str | os.PathLike, text: str) -> Path:
    """Write ``text`` to ``path`` via a same-directory tmp + rename.

    The tmp name carries the pid: two processes racing the same target
    (rank files share directories) each rename their own complete tmp,
    and last-rename-wins stays atomic. Parent dirs are created.
    """
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    tmp.write_text(text, encoding="utf-8")
    os.replace(tmp, out)
    return out
