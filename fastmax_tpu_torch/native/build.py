"""Build the native C++ packed loader ahead of its first use (counterpart of
``fastmax_tpu/native/build.py``):

    python -m fastmax_tpu_torch.native.build

It runs the build the loader runs at first use (``native/loader.build``:
``g++ -O3 -shared`` into the package's ``_build/``, named after a hash of
the source and flags) and prints the library's path; it raises where the
build fails. Without the library the reader falls back to the numpy
``PackedDataset``, so the build is optional.
"""

from __future__ import annotations

from pathlib import Path

from . import loader


def build(verbose: bool = True) -> Path:
    """Compile the loader (once per source and flags); returns the library's path."""
    path = loader.build()
    if verbose:
        print(f"built {path}")
    return path


if __name__ == "__main__":
    build()
