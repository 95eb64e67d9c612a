"""The port's kernels: each wrapper launches its hand-written CUDA kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors.
Kernel sources live in ``csrc/`` and build on first use (``_build``, which
also holds the per-kernel ``launch_counts``).

- ``pallas_attention.flash_attention_fwd`` — FlashAttention-2 forward
  (``csrc/flash_fwd.cu``);
- ``pallas_attention.flash_dq`` / ``flash_dkv`` — its backward, dQ
  (``csrc/flash_dq.cu``) and dK/dV (``csrc/flash_dkv.cu``), run together
  by ``flash_attention_bwd`` and the autograd Function
  ``flash_attention``;
- ``paged_attention.ragged_decode_partial`` — the ragged paged-decode
  walk over bf16/f32 or int8 pools (``csrc/ragged_decode.cu``, its walk
  in ``csrc/ragged_walk.cuh``);
- ``mega_decode.mega_decode_step`` — the persistent decode megakernel,
  one launch for a decode step of every layer (``csrc/mega_decode.cuh``,
  reusing the walk), with dense or int8 weights and pools, screened by
  ``mega_decode.mega_supported``; ``mega_decode.mega_decode_loop``, its
  multi-step form (the speculative draft's k greedy steps, head and
  argmax included, in one launch: ``csrc/mega_decode_multi_*.cu``);
- ``paged_attention.paged_decode_attention`` (``csrc/paged_decode.cu``),
  ``paged_append_token`` and ``paged_append_blocks``
  (``csrc/paged_cache.cu``) — the paged-cache API's decode attention and
  in-place appends;
- ``quant_matmul`` — the int8 quantizers and ``weight_only_matmul`` (plain
  torch ops: no kernel of its own);
- ``moe_dispatch.gmm`` / ``tgmm`` — the grouped GEMM over expert-sorted
  rows and its per-group weight gradient (``csrc/gmm.cu``,
  ``csrc/tgmm.cu``), under the differentiable ``grouped_matmul``;
- ``moe_fused.gather_gmm`` — the grouped GEMM with the expert-sort gather
  fused into its row loads, dense or int8 rhs (``csrc/gather_gmm.cu``),
  the fused MoE dispatch's gate|up projection. In bf16 it and ``gmm`` run
  on the persistent wgmma/TMA kernel of ``csrc/grouped_gemm_sm90.cuh``
  (tile width from ``moe_dispatch.tile_width``); ``tgmm`` and the f32
  forms share the mma.sync tiles of ``csrc/grouped_gemm.cuh``.

Functions are imported from their modules (a re-export here would shadow
the ``paged_attention`` module with its function of the same name).
"""
