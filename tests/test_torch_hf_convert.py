"""Hugging Face Llama checkpoint interchange in the port
(paddle_tpu_torch.models.llama ``convert_hf_state_dict`` and
``to_hf_state_dict``) held to the JAX package's on the CPU: a seeded
synthetic HF state dict converts to equal trees in both, to-HF
round-trips exactly, the same ``ValueError``s, and (where transformers is
installed) the port's logits on a tiny ``LlamaForCausalLM`` match
transformers'."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import llama as tl
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_DIMS = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
             max_seq_len=64, rope_theta=10000.0, remat=False,
             use_flash=False)


def _configs(tie=False, **kw):
    j = jl.LlamaConfig(**dict(_DIMS, **kw), dtype=jnp.float32,
                       tie_embeddings=tie)
    t = tl.LlamaConfig(**dict(_DIMS, **kw), dtype=torch.float32,
                       tie_embeddings=tie)
    return j, t


def _hf_dict(seed=0, layers=2, lm_head=True, as_torch=True):
    """A synthetic HF Llama state dict at _DIMS, values from a numpy
    seed: torch tensors (as ``state_dict()`` gives them) or numpy."""
    rng = np.random.default_rng(seed)
    h, f, V = _DIMS["hidden_size"], _DIMS["intermediate_size"], \
        _DIMS["vocab_size"]
    q = _DIMS["num_heads"] * _DIMS["head_dim"]
    kv = _DIMS["num_kv_heads"] * _DIMS["head_dim"]
    shapes = {"model.embed_tokens.weight": (V, h), "model.norm.weight": (h,)}
    for i in range(layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (q, h),
            p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h),
            p + "self_attn.o_proj.weight": (h, q),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (f, h),
            p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f)})
    if lm_head:
        shapes["lm_head.weight"] = (V, h)
    sd = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    return {k: torch.from_numpy(v) for k, v in sd.items()} if as_torch \
        else sd


def _tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_equal(got[k], want[k])
        return
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tie,lm_head,as_torch", [
    (False, True, True), (False, False, True), (True, False, True),
    (False, True, False)],
    ids=["untied", "tied_checkpoint", "tied_config", "numpy_values"])
def test_convert_matches_reference(tie, lm_head, as_torch):
    """The same HF dict converts to equal f32 trees in both packages: the
    transposed projections, stacked layers, and the head — ``lm_head``'s
    transpose, ``embed.T`` for a checkpoint without one (a tied
    checkpoint), no head for a tied config."""
    jcfg, tcfg = _configs(tie=tie)
    sd = _hf_dict(lm_head=lm_head, as_torch=as_torch)
    want = jl.convert_hf_state_dict(sd, jcfg)
    got = tl.convert_hf_state_dict(sd, tcfg, device="cpu")
    _tree_equal(got, want)
    assert ("lm_head" in got) == (not tie)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_to_hf_roundtrips_exactly(dtype):
    """to-HF of a converted tree gives the HF dict back bit for bit, equal
    to the reference's to-HF; a bf16 tree comes out widened (exact) and
    converts back to its own values."""
    jcfg, tcfg = _configs()
    sd = _hf_dict(seed=1)
    params = tl.convert_hf_state_dict(sd, tcfg, device="cpu")
    if dtype == torch.bfloat16:
        params = {k: ({kk: vv.to(dtype) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dtype))
                  for k, v in params.items()}
        sd = {k: torch.from_numpy(v) for k, v in
              tl.to_hf_state_dict(params, tcfg).items()}
    back = tl.to_hf_state_dict(params, tcfg)
    ref = jl.to_hf_state_dict(jl.convert_hf_state_dict(sd, jcfg), jcfg)
    assert set(back) == set(sd) == set(ref)
    for k in sd:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], sd[k].numpy())
        np.testing.assert_array_equal(back[k], np.asarray(ref[k]))
    again = tl.convert_hf_state_dict(back, tcfg, device="cpu")
    _tree_equal(again, jl.convert_hf_state_dict(sd, jcfg))


def test_mismatches_raise_the_reference_errors():
    """A layer-count or embedding-shape mismatch raises the reference's
    ``ValueError`` with the same message."""
    jcfg, tcfg = _configs()
    cases = [(_hf_dict(layers=3), jcfg, tcfg)]
    j2, t2 = _configs(vocab_size=80)
    cases.append((_hf_dict(), j2, t2))
    for sd, jc, tc in cases:
        with pytest.raises(ValueError) as want:
            jl.convert_hf_state_dict(sd, jc)
        with pytest.raises(ValueError) as got:
            tl.convert_hf_state_dict(sd, tc, device="cpu")
        assert str(got.value) == str(want.value)


def test_hf_llama_logits_match_transformers():
    """The port's forward on a converted tiny ``LlamaForCausalLM`` gives
    transformers' logits (RoPE layout, GQA heads, transposes), and to-HF
    returns its state dict."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    sd = hf.state_dict()
    cfg = tl.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=64,
        rope_theta=10000.0, rms_eps=1e-5, dtype=torch.float32, remat=False,
        use_flash=False)
    params = tl.convert_hf_state_dict(sd, cfg, device="cpu")
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 128, (2, 16)))
    with torch.no_grad():
        ref = hf(ids).logits
        ours = tl.forward(params, ids, cfg)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-4,
                               rtol=2e-4)
    back = tl.to_hf_state_dict(params, cfg)
    for k, v in sd.items():
        if k.endswith("rotary_emb.inv_freq"):
            continue
        np.testing.assert_array_equal(back[k], v.numpy())
    # and the generation path reads the converted tree
    out = tl.generate(params, ids[:, :6], dataclasses.replace(cfg), 4,
                      device="cpu")
    with torch.no_grad():
        want = hf.generate(ids[:, :6], max_new_tokens=4, do_sample=False)
    assert torch.equal(out, want)
