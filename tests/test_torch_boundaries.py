"""Boundaries of the port: paddle_tpu_torch imports neither jax nor
paddle_tpu, its entry points default to the card and raise without one,
and a kernel wrapper given a CUDA tensor never falls back to its plain
version."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.kernels import mega_decode as tmd
from paddle_tpu_torch.kernels import moe_dispatch as tmdisp
from paddle_tpu_torch.kernels import moe_fused as tmf
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import pallas_attention as tfa
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models import moe as tm
from paddle_tpu_torch.serving import LLMEngine

REPO = Path(__file__).resolve().parents[1]
PKG = Path(paddle_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_package_and_smoke_script_import_no_jax_ast():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and _forbidden(node.module or ""):
                bad.append((path.name, node.module))
    assert not bad, bad


def test_cpu_engine_runs_without_jax_in_a_fresh_process():
    code = """
import sys
import torch
import paddle_tpu_torch
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.serving import LLMEngine
cfg = llama.tiny_llama(vocab=32, hidden=32, layers=1, heads=4, kv_heads=2,
                       ffn=32)
params = llama.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
eng = LLMEngine(params, cfg, max_slots=2, block_size=8, max_model_len=32,
                prompt_buckets=[8], decode_steps=2, device="cpu")
rid = eng.add_request([1, 2, 3], max_new_tokens=4)
assert len(eng.run()[rid]) == 4
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
assert not leaked, leaked
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    cfg = tl.tiny_llama(vocab=32, hidden=32, layers=1, heads=4, kv_heads=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_params(cfg)
    params = tl.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.init_train_state(cfg)
    from paddle_tpu_torch.examples import llama_pretrain
    with pytest.raises(RuntimeError, match="CUDA"):
        llama_pretrain.main(["--size", "tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        paddle_tpu_torch.resolve_device("cuda:0")
    with pytest.raises(ValueError):
        paddle_tpu_torch.resolve_device("meta")


def test_offload_entry_points_default_to_cuda_and_raise_without_it():
    """The layer-wise, streaming and offload steps' entry points and the
    8B example run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    from paddle_tpu_torch.optimizer import offload as to
    cfg = tl.tiny_llama(vocab=32, hidden=32, layers=1, heads=4, kv_heads=2)
    mcfg = tm.tiny_moe(vocab=32, hidden=32, layers=1, heads=4, experts=4)
    for call in (lambda: to.init_layerwise_train_state(cfg),
                 lambda: to.init_streaming_train_state(cfg),
                 lambda: to.make_streaming_train_step(cfg),
                 lambda: to.init_streaming_moe_train_state(mcfg),
                 lambda: to.make_streaming_moe_train_step(mcfg),
                 lambda: to.init_offload_train_state(tl, cfg),
                 lambda: to.supports_host_memory(),
                 lambda: to.supports_compiled_host_memory(),
                 lambda: to.host_put({"w": torch.zeros(2)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    from paddle_tpu_torch.examples import llama_pretrain, train_8b_single_chip
    with pytest.raises(RuntimeError, match="CUDA"):
        llama_pretrain.main(["--size", "tiny", "--layerwise"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_8b_single_chip.main(["--size", "tiny"])


def test_kernel_library_is_keyed_by_its_sources(tmp_path, monkeypatch):
    """An edited CUDA source names a new library, so it is rebuilt."""
    from paddle_tpu_torch.kernels import _build
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.SRC_DIR.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", src)
    before = _build._digest()
    assert _build._digest() == before
    with open(src / "flash_fwd.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build._digest() != before


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper decides from
    when it picks between the kernel and its plain version."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _PlainTaken(Exception):
    pass


def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    """Without a card the wrapper raises when it goes to launch; it never
    calls its plain version instead."""
    def no_plain(*a, **k):
        raise _PlainTaken("plain version taken for a CUDA tensor")

    for name in ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
                 "flash_dq_plain", "flash_dkv_plain"):
        monkeypatch.setattr(tfa, name, no_plain)
    monkeypatch.setattr(tpa, "ragged_decode_partial_plain", no_plain)
    monkeypatch.setattr(tmd, "mega_decode_step_plain", no_plain)
    monkeypatch.setattr(tmd, "decode_layers", no_plain)

    def cuda(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype).as_subclass(_CudaTyped)

    q = cuda((1, 8, 4, 64))
    kv = cuda((1, 8, 2, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention_fwd(q, kv, kv, causal=True)
    lse = cuda((1, 4, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention_bwd(q, kv, kv, q, lse, q, causal=True)
    # the checks that come before a launch still hold for CUDA tensors
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(q, kv, kv, q, cuda((1, 4, 8), torch.float64),
                                q)
    half = cuda((1, 8, 4, 64), torch.float16)
    hkv = cuda((1, 8, 2, 64), torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(half, hkv, hkv, half, lse, half)
    q32, kv32 = cuda((1, 8, 4, 32)), cuda((1, 8, 2, 32))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_bwd(q32, kv32, kv32, q32, lse, q32)
    pool = cuda((1, 3, 4, 2, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.ragged_decode_partial(cuda((2, 4, 64)), pool, pool,
                                  cuda((2, 2), torch.int32),
                                  cuda((2,), torch.int32))
    cfg = tl.tiny_llama(vocab=32, hidden=256, layers=1, heads=4, kv_heads=2,
                        ffn=256)
    params = {k: (cuda(v.shape) if torch.is_tensor(v)
                  else {kk: cuda(vv.shape) for kk, vv in v.items()})
              for k, v in tl.init_params(cfg, device="cpu").items()}
    ring = cuda((1, 2, 4, 2, 64))
    lens = cuda((2,), torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmd.mega_decode_step(params, cfg, x0=cuda((2, 256)), t=0,
                             block_table=cuda((2, 2), torch.int32),
                             walk_lens=lens, lens=lens, ring_k=ring,
                             ring_v=ring, k_pool=pool, v_pool=pool)
    # the int8 branches: int8 pools with their scales, int8 weights
    pool8 = cuda((1, 3, 4, 2, 64), torch.int8)
    scales = cuda((1, 3, 4, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.ragged_decode_partial(cuda((2, 4, 64)), pool8, pool8,
                                  cuda((2, 2), torch.int32),
                                  cuda((2,), torch.int32), ks_pool=scales,
                                  vs_pool=scales)
    with pytest.raises(ValueError, match="scales"):
        tpa.ragged_decode_partial(cuda((2, 4, 64)), pool8, pool8,
                                  cuda((2, 2), torch.int32),
                                  cuda((2,), torch.int32))
    q8 = tl.quantize_params(tl.init_params(cfg, device="cpu"))
    params8 = {k: (cuda(v.shape) if torch.is_tensor(v) else
                   {kk: ({a: cuda(b.shape, b.dtype) for a, b in vv.items()}
                         if isinstance(vv, dict) else cuda(vv.shape))
                    for kk, vv in v.items()})
               for k, v in q8.items() if k != "lm_head"}
    for p, kp, extra in ((params8, pool, {}),
                         (params, pool8, dict(ks_pool=scales,
                                              vs_pool=scales)),
                         (params8, pool8, dict(ks_pool=scales,
                                               vs_pool=scales))):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmd.mega_decode_step(p, cfg, x0=cuda((2, 256)), t=0,
                                 block_table=cuda((2, 2), torch.int32),
                                 walk_lens=lens, lens=lens, ring_k=ring,
                                 ring_v=ring, k_pool=kp, v_pool=kp, **extra)


def test_spec_and_paged_cache_cuda_tensors_never_reach_the_plain_versions(
        monkeypatch):
    """B5's multi-step form and the paged-cache kernels (B6-B8) given CUDA
    tensors raise without a card when they go to launch, whatever the
    length; they never run their plain versions. The speculative engine
    defaults to the card like the plain one."""
    def no_plain(*a, **k):
        raise _PlainTaken("plain version taken for a CUDA tensor")

    monkeypatch.setattr(tmd, "mega_decode_loop_plain", no_plain)
    monkeypatch.setattr(tmd, "decode_layers", no_plain)
    for name in ("paged_decode_attention_plain", "paged_append_token_plain",
                 "paged_append_blocks_plain", "paged_attention"):
        monkeypatch.setattr(tpa, name, no_plain)

    def cuda(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype).as_subclass(_CudaTyped)

    cfg = dataclasses.replace(tl.tiny_llama(vocab=32, hidden=256, layers=1,
                                            heads=4, kv_heads=2, ffn=256),
                              dtype=torch.float32)
    params = {k: (cuda(v.shape) if torch.is_tensor(v)
                  else {kk: cuda(vv.shape) for kk, vv in v.items()})
              for k, v in tl.init_params(cfg, device="cpu").items()}
    pool = cuda((1, 3, 4, 2, 64))
    ring = cuda((1, 2, 2, 2, 64))
    ints = cuda((2,), torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmd.mega_decode_loop(params, cfg, x0=cuda((2, 256)), n_steps=2,
                             block_table=cuda((2, 2), torch.int32),
                             walk_lens=ints, lens=ints,
                             active=cuda((2,), torch.bool), last0=ints,
                             budgets=ints, eos_ids=ints, ring_k=ring,
                             ring_v=ring, k_pool=pool, v_pool=pool)
    # a table far wider than the TPU wrapper's 12 MiB of VMEM staging
    # (where the JAX package gathers instead) takes the kernel too
    small = cuda((1, 2, 64, 2, 64))
    cache = tpa.PagedKVCache(small, small, cuda((2, 4096), torch.int32),
                             cuda((2,), torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.paged_decode_attention(cuda((2, 4, 64)), cache)
    rows = cuda((2, 2, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.paged_append_token(pool, pool, rows, rows, ints, ints)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.paged_append_blocks(pool[0], pool[0], cuda((2, 4, 2, 64)),
                                cuda((2, 4, 2, 64)), ints)
    # the checks before a launch hold for CUDA tensors: no fp16 queries
    with pytest.raises(TypeError):
        tpa.paged_decode_attention(cuda((2, 4, 64), torch.float16), cache)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LLMEngine(params, cfg, draft_params=params, draft_config=cfg)


def test_moe_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    cfg = tm.tiny_moe(vocab=32, hidden=32, layers=1, heads=4, experts=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_train_state(cfg, optimizer="adafactor")
    from paddle_tpu_torch.examples import moe_pretrain
    with pytest.raises(RuntimeError, match="CUDA"):
        moe_pretrain.main(["--size", "tiny", "--steps", "1"])
    # the example's train_step runs where its state lies: on the CPU only
    # when asked
    assert moe_pretrain.main(["--size", "tiny", "--steps", "1",
                              "--batch-size", "1", "--seq", "16",
                              "--device", "cpu"]) > 0


def test_moe_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    """gather_gmm, gmm and tgmm given CUDA tensors launch or raise; they
    never call their plain versions."""
    def no_plain(*a, **k):
        raise _PlainTaken("plain version taken for a CUDA tensor")

    monkeypatch.setattr(tmf, "gather_gmm_plain", no_plain)
    monkeypatch.setattr(tmdisp, "gmm_plain", no_plain)
    monkeypatch.setattr(tmdisp, "tgmm_plain", no_plain)

    def cuda(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_CudaTyped)

    gs = cuda((4,), torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmf.gather_gmm(cuda((8, 64)), cuda((256,), torch.int32),
                       cuda((4, 64, 32)), cuda((2,), torch.int32))
    # B9's int8 branch: an int8 rhs launches or raises too, and its width
    # must be a multiple of 16
    with pytest.raises(RuntimeError, match="CUDA"):
        tmf.gather_gmm(cuda((8, 64)), cuda((256,), torch.int32),
                       cuda((4, 64, 32), torch.int8),
                       cuda((2,), torch.int32))
    with pytest.raises(ValueError, match="multiples of 16"):
        tmf.gather_gmm(cuda((8, 64)), cuda((256,), torch.int32),
                       cuda((4, 64, 40), torch.int8),
                       cuda((2,), torch.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmdisp.gmm(cuda((256, 64)), cuda((4, 64, 32)), gs)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmdisp.gmm(cuda((256, 64)), cuda((4, 32, 64)), gs,
                   transpose_rhs=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmdisp.tgmm(cuda((256, 64)).t(), cuda((256, 32)), gs)
    # what the kernels do not take raises before any launch
    with pytest.raises(ValueError, match="multiples of 8"):
        tmdisp.gmm(cuda((256, 60)), cuda((4, 60, 32)), gs)
    with pytest.raises(TypeError):
        tmdisp.gmm(cuda((256, 64), torch.float16),
                   cuda((4, 64, 32), torch.float16), gs)


@pytest.mark.parametrize("n,want", [(2816, 256), (2048, 256), (1408, 128),
                                    (136, 128), (264, 128), (256, 256)])
def test_tile_width_picks_the_kernel_tile(n, want):
    """The bf16 B9/gmm kernels' tile width, picked in Python and passed to
    the C entry points: 256 columns for a whole number of 256-wide tiles,
    else 128."""
    assert tmdisp.tile_width(n) == want


@pytest.mark.parametrize("n", [0, -8, 100, 1410])
def test_tile_width_raises_on_widths_the_kernels_do_not_take(n):
    with pytest.raises(ValueError, match="multiple of 8"):
        tmdisp.tile_width(n)


def test_tgmm_passes_the_tile_width_of_its_output_columns(monkeypatch):
    """tgmm runs on the Hopper grouped-GEMM kernel and, like gmm and B9,
    passes ``tile_width`` of its output's columns (rhs's width n of
    [E, k, n]) to its C entry point after the inputs' checks: 256 for the
    MoE step's wgrads (2816, 2048), 128 for 1408 and 136. The launch is
    replaced here by a recorder of its arguments."""
    import contextlib
    calls = []

    def kernel(name, argtypes):
        def fn(*args):
            calls.append((name, len(argtypes), args))
            return 0
        return fn

    real_empty = torch.empty
    monkeypatch.setattr(tmdisp._build, "kernel", kernel)
    monkeypatch.setattr(tmdisp._build, "ptr", lambda t: 0)
    monkeypatch.setattr(tmdisp._build, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        real_empty(*a, **k))

    def cuda(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_CudaTyped)

    gs = cuda((4,), torch.int32)
    for n, want in ((2816, 256), (2048, 256), (1408, 128), (136, 128)):
        for out_dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            tmdisp.tgmm(cuda((300, 136)).t(), cuda((300, n)), gs,
                        out_dtype=out_dtype)
            name, n_args, args = calls[-1]
            assert name == "ptt_tgmm" and len(args) == n_args == 12
            # M, K, N, E, dtype, out_dtype, tile width
            assert args[4:11] == (300, 136, n, 4, 1, code, want)


def test_flash_kernels_take_only_16_byte_aligned_inputs():
    """B1's bf16 kernel reads q, k and v by TMA, which needs 16-byte-aligned
    rows: a contiguous view 2 bytes off that alignment is refused before
    any launch; an aligned one passes the checks."""
    base = torch.zeros(2 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
    off = base[1:1 + 2 * 8 * 2 * 64].view(2, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        tfa._check_cuda("flash_attention_fwd", (off, off, off), 64)
    ok = base[:2 * 8 * 2 * 64].view(2, 8, 2, 64)
    tfa._check_cuda("flash_attention_fwd", (ok, ok, ok), 64)


def test_flash_backward_takes_only_16_byte_aligned_lse_and_delta():
    """B3 reads lse and Delta by TMA: a contiguous view 4 bytes off a
    16-byte boundary is refused before any launch, for the given Delta
    and for the buffer B2 fills; aligned ones pass the checks."""
    def cuda(t):
        return t.as_subclass(_CudaTyped)

    q = cuda(torch.zeros(1, 8, 4, 64))
    kv = cuda(torch.zeros(1, 8, 2, 64))
    base = torch.zeros(4 * 8 + 4)
    ok = cuda(base[:32].view(1, 4, 8))
    off = cuda(base[1:33].view(1, 4, 8))
    for lse, delta in ((off, ok), (ok, off)):
        with pytest.raises(ValueError, match="16-byte-aligned"):
            tfa._check_bwd("flash_dkv", q, kv, kv, q, lse, delta)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        tfa.flash_dq(q, kv, kv, q, ok, off, out=q)
    assert tfa._check_bwd("flash_dkv", q, kv, kv, q, ok, ok) is False


def test_moe_unported_arguments_raise_naming_their_queue():
    cfg = tm.tiny_moe(vocab=32, hidden=32, layers=1, heads=4, experts=4)
    params = tm.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 9), dtype=torch.long)
    for kw, err, match in (({"expert_dtype": "fp8"}, ValueError,
                            "expert_dtype"),
                           ({"dispatch": "dense"}, NotImplementedError,
                            "A9")):
        with pytest.raises(err, match=match):
            tm.loss_fn(params, toks, dataclasses.replace(cfg, **kw))
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.zeros((8, 32))
    with pytest.raises(NotImplementedError, match="A10"):
        tm.moe_ffn(x, lp["router"], lp["e_gate"], lp["e_up"], lp["e_down"],
                   cfg, mesh={"dp": 1, "ep": 2})
    # int8 experts are ported: quantize_expert_params makes int8 leaves
    # (expert_dtype None leaves the params as they are), and B9 takes an
    # int8 rhs (its plain version on the CPU)
    q8 = tm.quantize_expert_params(params)
    assert q8["layers"]["e_gate"]["q"].dtype == torch.int8
    assert tm.quantize_expert_params(params, cfg) is params
    rhs8 = torch.ones((4, 32, 8), dtype=torch.int8)
    out = tmf.gather_gmm(x + 1, torch.zeros(128, dtype=torch.int32), rhs8,
                         torch.zeros(1, dtype=torch.int32))
    assert out.shape == (128, 8) and torch.all(out == 32)
    for name in ("dropless_moe_ffn_ep", "dropless_moe_ffn_a2a"):
        with pytest.raises(NotImplementedError, match="A10"):
            getattr(tmdisp, name)(x)
    with pytest.raises(NotImplementedError, match="A9"):
        tmdisp.dropless_moe_ffn_dense(x)
    from paddle_tpu_torch.examples import moe_pretrain
    with pytest.raises(NotImplementedError, match="A10"):
        moe_pretrain.main(["--ep", "2", "--device", "cpu"])
