"""The port's chained decode (paddle_tpu_torch.serving.LLMEngine) held to
the JAX LLMEngine on the CPU, step for step: each ``step()`` must emit
the same (req_id, token) list in the same order — the readback lag of
the chained pipeline included — at decode_steps 1 and 4, through
recompute preemption, and with an eos request that forces the engine to
read each call before dispatching the next. Also: a steady-state chained
dispatch uploads nothing and reads back only the previous call."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as jl
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.serving import engine as teng
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, seq=128,
             ffn=64)
ENGINE = dict(max_slots=2, block_size=8, max_model_len=64, num_blocks=6,
              prompt_buckets=[8, 32])


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jl.tiny_llama(**SIZES), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**SIZES), dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(k)).tolist()
            for k in rng.integers(3, 20, size=n)]


def _ledger_ok(eng):
    a = eng.block_accounting()
    assert a["free"] + a["backed"] + a["cached"] + a["squeezed"] \
        + a["in_flight"] == a["total"], a
    return a


def _steps(eng, requests, check=None):
    """Add ``requests`` ((prompt, kwargs) pairs) and step until drained:
    the list of every step's emitted pairs."""
    for prompt, kw in requests:
        eng.add_request(prompt, **kw)
    out = []
    while eng.has_work():
        out.append(eng.step())
        if check is not None:
            check(eng)
    return out


@pytest.mark.parametrize("decode_steps,eos", [(1, False), (4, False),
                                              (4, True)])
def test_chained_steps_equal_jax_engine(model, decode_steps, eos):
    jcfg, jp, tcfg, tp = model
    prompts = _prompts()
    requests = [(p, dict(max_new_tokens=16)) for p in prompts]
    if eos:
        # an eos a few tokens into request 1's greedy stream: while it is
        # decoding no call may be dispatched before the previous is read
        greedy = LLMEngine(tp, tcfg, decode_steps=decode_steps,
                           device="cpu", **ENGINE)
        rid = greedy.add_request(prompts[1], max_new_tokens=16)
        stream = greedy.run()[rid]
        requests[1] = (prompts[1], dict(max_new_tokens=16,
                                        eos_token_id=stream[6]))
    jax_eng = JaxEngine(jp, jcfg, decode_steps=decode_steps,
                        decode_kernel="bucketed", **ENGINE)
    want = _steps(jax_eng, requests)

    eng = LLMEngine(tp, tcfg, decode_steps=decode_steps, device="cpu",
                    **ENGINE)
    preempted = []
    free_slot = eng._free_slot

    def counting_free_slot(slot, requeue=False):
        preempted.append(requeue)
        return free_slot(slot, requeue)

    eng._free_slot = counting_free_slot
    got = _steps(eng, requests, _ledger_ok)
    assert eos or any(preempted), "the pool was meant to force a preemption"
    assert got == want
    assert eng.results == jax_eng.results
    # every decode call is read exactly once; chained reads happen only
    # while no slot of the unread call can finish inside it
    calls = sum(eng.decode_paths.values())
    assert sum(eng.readbacks.values()) == calls
    assert eng.readbacks["chained"] >= 1
    if eos:
        stream = eng.results[1]
        assert stream[-1] == requests[1][1]["eos_token_id"]
        assert len(stream) < 16
    a = _ledger_ok(eng)
    assert a["free"] == a["total"] and eng._inflight is None


def test_eos_everywhere_never_chains(model):
    """Every request carries an eos: each call is read before the next
    is dispatched (``_spec_safe`` refuses), so no readback is chained."""
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, decode_steps=2, device="cpu", **ENGINE)
    for p in _prompts(seed=5, n=3):
        eng.add_request(p, max_new_tokens=8, eos_token_id=63)
    eng.run()
    assert eng.readbacks["chained"] == 0
    assert eng.readbacks["drained"] == sum(eng.decode_paths.values())


def test_steady_state_dispatch_uploads_nothing(model, monkeypatch):
    """A chained dispatch with no admission, no new block and no slot
    change uploads nothing (the carry, slot vectors and table stay on
    the device) and reads back exactly one tensor: the previous call's
    tokens, through the host copy started when that call was enqueued
    (so the read waits for that call alone, not the one queued after
    it)."""
    _, _, tcfg, tp = model
    eng = LLMEngine(tp, tcfg, max_slots=2, block_size=32, max_model_len=128,
                    prompt_buckets=[32], decode_steps=2, device="cpu")
    for p in _prompts(seed=6, n=2):
        eng.add_request(p[:5], max_new_tokens=40)
    eng.step()                   # prefill + first call (nothing to read)
    eng.step()                   # reads the first call and its admissions
    uploads, reads = [], []
    real_upload, real_read = teng.upload, teng._Readback.numpy
    monkeypatch.setattr(teng, "upload",
                        lambda *a: uploads.append(a) or real_upload(*a))
    monkeypatch.setattr(teng._Readback, "numpy",
                        lambda rb: reads.append(rb.dev.shape)
                        or real_read(rb))
    emitted = eng.step()
    assert len(emitted) == 2 * 2 and not uploads
    assert reads == [torch.Size([2, 2])]
    assert eng.readbacks["chained"] == 2 and eng._inflight is not None
    monkeypatch.undo()
    out = eng.run()
    assert all(len(v) == 40 for v in out.values())


def test_sampled_chained_streams_stay_in_vocab(model):
    """Sampled requests through the chained pipeline: right lengths,
    in-vocabulary tokens, a balanced ledger, and the same streams from
    the same seed."""
    _, _, tcfg, tp = model

    def run():
        eng = LLMEngine(tp, tcfg, decode_steps=3, device="cpu", seed=7,
                        **ENGINE)
        ids = [eng.add_request(p, max_new_tokens=12, temperature=0.9,
                               top_k=8, top_p=0.9)
               for p in _prompts(seed=8, n=4)]
        _steps(eng, [], _ledger_ok)
        return [eng.results[i] for i in ids]

    a = run()
    assert all(len(s) == 12 and all(0 <= t < 64 for t in s) for s in a)
    assert run() == a
