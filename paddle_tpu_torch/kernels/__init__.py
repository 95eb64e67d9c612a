"""The port's kernels: each wrapper launches its hand-written CUDA kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors.
Kernel sources live in ``csrc/`` and build on first use (``_build``, which
also holds the per-kernel ``launch_counts``).

- ``pallas_attention.flash_attention_fwd`` — FlashAttention-2 forward
  (``csrc/flash_fwd.cu``);
- ``pallas_attention.flash_dq`` / ``flash_dkv`` — its backward, dQ
  (``csrc/flash_dq.cu``) and dK/dV (``csrc/flash_dkv.cu``), run together
  by ``flash_attention_bwd`` and the autograd Function
  ``flash_attention``. In bf16 all three are persistent, warp-specialised
  wgmma/TMA kernels (shared blocks in ``csrc/hopper.cuh``); the f32
  forms run on the CUDA cores;
- ``paged_attention.ragged_decode_partial`` — the ragged paged-decode
  walk over bf16/f32 or int8 pools (``csrc/ragged_decode.cu``): bf16
  queries walk on the split, tensor-core walk of ``csrc/ragged_split.cuh``
  (shared with B6), f32 queries on the CUDA-core walk of
  ``csrc/ragged_walk.cuh`` over the same schedule;
- ``mega_decode.mega_decode_step`` — the persistent decode megakernel,
  one launch for a decode step of every layer (``csrc/mega_decode.cuh``,
  reusing ``ragged_walk.cuh``), with dense or int8 weights and pools, screened by
  ``mega_decode.mega_supported``; ``mega_decode.mega_decode_loop``, its
  multi-step form (the speculative draft's k greedy steps, head and
  argmax included, in one launch: ``csrc/mega_decode_multi_*.cu``). A
  producer warp streams the weights by TMA ahead of the grid barriers;
  bf16 and int8 weights meet the input rows on wgmma, f32 on the CUDA
  cores;
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
  the fused MoE dispatch's gate|up projection. In bf16 it, ``gmm`` and
  ``tgmm`` run on the persistent wgmma/TMA kernels of
  ``csrc/grouped_gemm_sm90.cuh`` (tile width from
  ``moe_dispatch.tile_width``); the f32 forms share the CUDA-core tiles
  of ``csrc/grouped_gemm.cuh``.

Functions are imported from their modules (a re-export here would shadow
the ``paged_attention`` module with its function of the same name).
"""
