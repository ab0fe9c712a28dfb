"""Tee stdout/stderr to a file (reference: log/tee.py).

The port's copy of ``caiman_asr_tpu/log/tee.py``.
"""

from __future__ import annotations

import sys
from pathlib import Path


class _Tee:
    def __init__(self, stream, fh):
        self.stream = stream
        self.fh = fh

    def write(self, data):
        self.stream.write(data)
        self.fh.write(data)

    def flush(self):
        self.stream.flush()
        self.fh.flush()

    def isatty(self):
        return getattr(self.stream, "isatty", lambda: False)()


def tee_stdout_to_file(output_dir: str | Path, fname: str = "stdout.log"):
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    fh = open(out / fname, "a")
    sys.stdout = _Tee(sys.stdout, fh)
    sys.stderr = _Tee(sys.stderr, fh)
    return fh
