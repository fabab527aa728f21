"""Global numeric configuration for mpc_tpu_torch.

Counterpart of ``mpc_tpu/utils/config.py``.  Construct-time math runs in
NumPy float64 on the host; the runtime (the batched serving step) runs in
the dtype the caller picks, float64 for parity work on the CPU, float32 on
the GPU.

Precision policy, set when this module is imported: float32 matrix
products run in full float32, never TF32.  TF32 keeps about three decimal
digits, and the reference found that reduced-precision matmuls break the
ADMM residual tests and the Â-power prediction stacks (``mpc_tpu``
``utils/config.py::precision32`` and ``ops/qp.py::solve_qp``).
"""
from __future__ import annotations

import torch

# Large-but-finite stand-in for ±Inf bounds: the QP keeps every row (static
# shapes), an infinite bound is a ±BIG row.
BIG = 1e20

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (default: the GPU, ``cuda``).

    Raises ``RuntimeError`` when a CUDA device is asked for, by default or
    by name, and none is available: the port never carries on on the CPU
    unless the caller asks for ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} was requested but "
                           "torch.cuda.is_available() is False")
    return dev


def as_device(device) -> torch.device:
    """``torch.device(device)``, a CUDA device without an index made the
    current card's, so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
