"""Weight matmul of the serving path — the port of
paddle_tpu/kernels/quant_matmul.weight_only_matmul, dense branch.

The int8 weight-only branch (``{"q": int8, "s": scales}`` leaves) is not
ported yet (ROADMAP queue A4) and raises.
"""
from __future__ import annotations

import torch


def weight_only_matmul(x, w, out_dtype):
    """``x @ w.to(out_dtype)`` for a dense [K, N] weight."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "int8 weight-only matmul is not ported yet (ROADMAP queue A4)")
    return x @ w.to(out_dtype)
