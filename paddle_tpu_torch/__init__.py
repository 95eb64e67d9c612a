"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module names (``models/llama.py``,
``models/moe.py``, ``kernels/pallas_attention.py``,
``kernels/paged_attention.py``, ``kernels/mega_decode.py``,
``kernels/moe_dispatch.py``, ``kernels/moe_fused.py``,
``kernels/quant_matmul.py``, ``optimizer/functional.py``,
``serving/engine.py``, ``examples/llama_pretrain.py``,
``examples/moe_pretrain.py``) so each piece has an obvious counterpart. Every TPU kernel on a ported path is a CUDA C++
kernel for ``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` on
first use and bound with ``ctypes``; beside each sits a plain PyTorch
version that CPU tensors take.

Entry points run on the card: they default to ``device="cuda"`` and raise
when no Hopper card is present, unless the caller passes ``device="cpu"``.
The package imports ``torch`` and ``numpy`` only — never ``jax`` and never
``paddle_tpu``. Importing the package itself loads neither:
``resolve_device`` resolves on first use (PEP 562), so the stdlib-only
``observability`` and ``framework.flags`` modules import without torch.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
