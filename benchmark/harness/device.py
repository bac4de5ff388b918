"""The card, the caches and the guard against JAX.

- `require_cards(n)`: the run needs `n` CUDA devices and fails without them;
  it never falls back to the CPU.
- `use_checkout_caches(root)`: every kernel cache the run could fill lies at
  a fixed path inside the checkout (the port's own nvcc build directory,
  `build/cuda/`, already does).
- `foreign_modules()`: the modules of JAX, Flax or the JAX package loaded
  in this process, compared by their whole top-level names (the port's
  name begins with the JAX package's).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

#: Top-level module names that no run may load.
FOREIGN = ("jax", "jaxlib", "flax", "stheno_tpu")
#: The caches, relative to the checkout's root.
CACHES = {
    "TRITON_CACHE_DIR": "benchmark/.cache/triton",
    "TORCH_EXTENSIONS_DIR": "benchmark/.cache/torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "benchmark/.cache/inductor",
}


class NoCard(RuntimeError):
    pass


def require_cards(n):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available: the benchmark runs on the card only")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the workload needs {n} CUDA devices, this machine has {have}")


def use_checkout_caches(root):
    for key, rel in CACHES.items():
        path = Path(root) / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)


def foreign_modules(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FOREIGN))


def card_line():
    """`nvidia-smi`'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"not read ({err.__class__.__name__})"
