"""The port's fixed-batch generation (paddle_tpu_torch.models.llama
``generate``, ``generate_fused`` and their sampling) held to the JAX
package's on the CPU: greedy token ids and lengths (with an eos early
exit) equal, the sampling masks (top-k, top-p, both) equal on the same
logits. The two packages' random generators differ, so sampled streams
are compared by their masks, not by id. tiny_llama, f32, weights carried
over with ``params_from_numpy``; inputs from numpy seeds."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import llama as tl
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(), dtype=torch.float32)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jl.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            tl.params_from_numpy(tree, device="cpu"))


def _prompt(seed, B=2, S=8, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("fn", ["generate", "generate_fused"])
def test_greedy_ids_match_reference(model, fn):
    """Greedy ``generate`` and ``generate_fused``: the prompt followed by
    12 tokens, equal to the reference's ``generate`` (and the token ids
    come back in the prompt's dtype)."""
    jcfg, jp, tcfg, tp = model
    prompt = _prompt(1)
    want = np.asarray(jl.generate(jp, jnp.asarray(prompt), jcfg, 12))
    got = getattr(tl, fn)(tp, prompt, tcfg, 12, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_matches_the_uncached_argmax(model):
    """As the reference's own test: greedy generation equals the argmax
    of the uncached forward, token by token."""
    _, _, tcfg, tp = model
    prompt = torch.as_tensor(_prompt(3, B=1, S=5))
    out = tl.generate(tp, prompt, tcfg, 3, device="cpu")
    seq = prompt
    for _ in range(3):
        nxt = tl.forward(tp, seq, tcfg)[:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt.to(seq.dtype)], 1)
    assert torch.equal(out, seq)


@pytest.mark.parametrize("fn", ["generate", "generate_fused"])
@pytest.mark.parametrize("where", [3, 10])
def test_eos_early_exit_matches_reference(model, fn, where):
    """With an eos that one row emits at step ``where`` (greedy), rows
    that finish pad with eos and generation stops once every row has
    finished: the ids and the returned length equal the reference's
    ``generate`` and ``generate_fused``."""
    jcfg, jp, tcfg, tp = model
    prompt = _prompt(1)
    free = np.asarray(jl.generate(jp, jnp.asarray(prompt), jcfg, 24))
    eos = int(free[0, 8 + where])
    want = np.asarray(jl.generate(jp, jnp.asarray(prompt), jcfg, 24,
                                  eos_token_id=eos))
    want_f = np.asarray(jl.generate_fused(jp, jnp.asarray(prompt), jcfg, 24,
                                          eos_token_id=eos))
    np.testing.assert_array_equal(want, want_f)
    got = getattr(tl, fn)(tp, prompt, tcfg, 24, eos_token_id=eos,
                          device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_every_row_finishing_at_once_stops_after_one_token(model):
    """An eos every row emits first: n = 1 in both packages."""
    jcfg, jp, tcfg, tp = model
    prompt = np.repeat(_prompt(4, B=1), 2, axis=0)
    eos = int(np.asarray(jl.generate(jp, jnp.asarray(prompt), jcfg, 1))[0,
                                                                        -1])
    want = np.asarray(jl.generate_fused(jp, jnp.asarray(prompt), jcfg, 16,
                                        eos_token_id=eos))
    assert want.shape == (2, 9)
    for fn in (tl.generate, tl.generate_fused):
        got = fn(tp, prompt, tcfg, 16, eos_token_id=eos, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_with_no_new_tokens_returns_the_prompt(model):
    _, _, tcfg, tp = model
    prompt = torch.as_tensor(_prompt(2))
    assert tl.generate_fused(tp, prompt, tcfg, 0, device="cpu") is prompt
    assert tl.generate_fused(tp, prompt, tcfg, -3, device="cpu") is prompt


def _reference_filtered(logits, temperature, top_k, top_p, monkeypatch):
    """The logits the reference's ``_sample_impl`` draws from: its
    categorical draw replaced by the identity for this call."""
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, lg, axis=-1: lg)
    out = jl._sample_impl(jnp.asarray(logits), jax.random.PRNGKey(0),
                          jnp.float32(temperature), jnp.int32(top_k),
                          jnp.float32(top_p), sampled=True,
                          use_top_k=top_k > 0, use_top_p=top_p < 1.0)
    monkeypatch.undo()
    return np.asarray(out)


@pytest.mark.parametrize("top_k,top_p", [(40, 1.0), (0, 0.9), (40, 0.95),
                                         (1, 1.0), (5, 0.5)],
                         ids=["top_k", "top_p", "both", "k1", "k5_p05"])
def test_sampling_masks_match_reference(monkeypatch, top_k, top_p):
    """The filtered logits equal the reference's on the same [4, 512]
    logits (numpy seed; two rows with a repeated maximum for ties): the
    same tokens masked to -1e30 and the kept ones scaled alike, as Python
    numbers (``generate``) and as 0-d tensors (``generate_fused``)."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, 512)) * 3).astype(np.float32)
    logits[1, 10] = logits[1, 20] = logits[1].max() + 1
    want = _reference_filtered(logits, 0.8, top_k, top_p, monkeypatch)
    flags = dict(use_top_k=top_k > 0, use_top_p=top_p < 1.0)
    for args in ((0.8, top_k, top_p),
                 (torch.tensor(0.8), torch.tensor(top_k),
                  torch.tensor(top_p))):
        got = tl._filter_logits(torch.as_tensor(logits), *args,
                                **flags).numpy()
        np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
        keep = want > -1e29
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    # every kept set is non-empty and every draw lands in it
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        tok = tl._sample_logits(torch.as_tensor(logits), g, 0.8, top_k,
                                top_p).numpy()
        assert keep[np.arange(4), tok].all()


def test_top_k_one_sampled_stream_equals_greedy(model):
    """Sampling at top_k = 1 keeps only the largest logit: the sampled
    streams of both loops equal the greedy one."""
    _, _, tcfg, tp = model
    prompt = _prompt(5)
    greedy = tl.generate(tp, prompt, tcfg, 10, device="cpu")
    for fn in (tl.generate, tl.generate_fused):
        got = fn(tp, prompt, tcfg, 10, temperature=0.7, top_k=1,
                 generator=torch.Generator().manual_seed(11), device="cpu")
        assert torch.equal(got, greedy)


def test_sampled_fused_equals_the_loop_on_one_generator(model):
    """Both loops draw the same uniforms in the same order: from one seed
    their sampled streams (top-k, top-p, an eos) are equal."""
    _, _, tcfg, tp = model
    prompt = _prompt(6)
    kw = dict(temperature=0.8, top_k=20, top_p=0.9, device="cpu")
    a = tl.generate(tp, prompt, tcfg, 12,
                    generator=torch.Generator().manual_seed(3), **kw)
    b = tl.generate_fused(tp, prompt, tcfg, 12,
                          generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b)
    eos = int(a[1, 12])
    a = tl.generate(tp, prompt, tcfg, 12, eos_token_id=eos,
                    generator=torch.Generator().manual_seed(3), **kw)
    b = tl.generate_fused(tp, prompt, tcfg, 12, eos_token_id=eos,
                          generator=torch.Generator().manual_seed(3), **kw)
    assert torch.equal(a, b)


def test_device_position_equals_host_position(model):
    """``forward_with_cache`` with ``pos`` a 0-d tensor (the captured
    decode step's form) gives the logits and cache of an int ``pos``,
    through a prefill and three decode steps."""
    _, _, tcfg, tp = model
    toks = torch.as_tensor(_prompt(8, S=11))
    ca = tl.init_kv_cache(tcfg, 2, 16, device="cpu")
    cb = tl.init_kv_cache(tcfg, 2, 16, device="cpu")
    cb["pos"] = torch.zeros((), dtype=torch.long)
    for lo, hi in ((0, 8), (8, 9), (9, 10), (10, 11)):
        la, ca = tl.forward_with_cache(tp, toks[:, lo:hi], ca, tcfg)
        lb, cb = tl.forward_with_cache(tp, toks[:, lo:hi], cb, tcfg)
        assert torch.equal(la, lb)
        assert int(cb["pos"]) == ca["pos"] == hi
    assert torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"])


def test_example_runs_on_the_cpu_when_asked_and_refuses_load(model):
    """``examples/llama_generate.py``: on the CPU only when asked (it
    defaults to the card and raises without one), the prompt followed by
    at most ``--max-new`` tokens; ``--load`` and
    ``llama.export_for_inference`` raise naming ROADMAP A11."""
    from paddle_tpu_torch.examples import llama_generate

    out = llama_generate.main(["--batch", "2", "--prompt-len", "4",
                               "--max-new", "6"], device="cpu")
    assert out.shape == (2, 10)
    with pytest.raises(NotImplementedError, match="A11"):
        llama_generate.main(["--load", "params.pd"], device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        tl.export_for_inference(None, None, "model", 8, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            llama_generate.main(["--max-new", "2"])
        _, _, tcfg, tp = model
        with pytest.raises(RuntimeError, match="CUDA"):
            tl.generate(tp, _prompt(0), tcfg, 2, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            tl.convert_hf_state_dict({}, tcfg)
