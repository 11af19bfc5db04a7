"""The benchmark's own tests run from any working directory: the checkout's
root goes on ``sys.path`` so that ``portbench`` and the port import."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the tests run side by side in several workers on a few cores
torch.set_num_threads(2)
