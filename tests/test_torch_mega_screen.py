"""The mega decode kernel's screen (``mega_supported``), its shared-memory
layout (``_smem_bytes``) on the configurations the card runs, on the
CPU: parameter trees on the ``meta`` device, so Llama-3-8B costs no
memory. The static schedule (``schedule``) comes from the kernel
library, so its test needs the card. Every configuration that
``chip_smoke.py`` drives through the kernel is taken, with a ring of at
least two weight stages within the card's 227 KB."""
import dataclasses

import pytest
import torch

from paddle_tpu_torch.kernels import mega_decode as tmd
from paddle_tpu_torch.models import llama as tl


def _meta_params(cfg):
    """A parameter tree of ``cfg``'s shapes in its dtype, on ``meta``."""
    top, layers = tl._shapes(cfg)

    def make(shape):
        return torch.empty(shape, dtype=cfg.dtype, device="meta")
    params = {k: make(shape) for k, (shape, _s) in top.items()}
    params["layers"] = {k: make(shape) for k, (shape, _s) in layers.items()}
    return params


def _llama3_8b():
    cfg = dataclasses.replace(tl.llama3_8b(), dtype=torch.bfloat16)
    return cfg, _meta_params(cfg)


def _draft_1b(cfg8):
    """The Llama-3.2-1B-shaped draft of chip_smoke.py's spec phases."""
    dcfg = dataclasses.replace(tl.draft_config(
        cfg8, num_layers=16, hidden_size=2048, intermediate_size=8192,
        num_heads=32, num_kv_heads=8, head_dim=64), tie_embeddings=True)
    return dcfg, _meta_params(dcfg)


@pytest.mark.parametrize("n_slots", range(1, 9))
@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_screen_takes_llama3_8b(n_slots, weights):
    """Llama-3-8B in bf16 and with ``quantize_params``' int8 weights, at
    1-8 slots, over bf16 and int8 pools, in both forms: taken."""
    cfg, params = _llama3_8b()
    if weights == "int8":
        params = tl.quantize_params(params)
    for kv_int8 in (False, True):
        for multi in (False, True):
            assert tmd.mega_supported(
                params, cfg, n_slots=n_slots, n_steps=4, block_size=64,
                kv_int8=kv_int8, multi_step=multi) == (True, "ok")
    stages, smem = tmd._smem_layout(2, cfg.head_dim, n_slots)
    assert stages >= 2 and smem <= tmd.SMEM_LIMIT
    assert tmd._smem_bytes(2, cfg.head_dim, n_slots) == smem


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_screen_takes_the_1b_draft_multi_step(dtype):
    """The 1B-shaped draft with its tied head (bf16, and widened to f32
    as chip_smoke.py's (s1) holds it), multi-step form, 4 slots, k = 4;
    also with int8 layer weights."""
    cfg8, _ = _llama3_8b()
    dcfg, dparams = _draft_1b(cfg8)
    dcfg = dataclasses.replace(dcfg, dtype=dtype)
    dparams = _meta_params(dcfg)
    for params in (dparams, tl.quantize_params(dparams)):
        for kv_int8 in (False, True):
            assert tmd.mega_supported(
                params, dcfg, n_slots=4, n_steps=4, block_size=64,
                kv_int8=kv_int8, multi_step=True) == (True, "ok")
    isz = torch.empty((), dtype=dtype).element_size()
    for n in (1, 4, 5, 8):
        stages, smem = tmd._smem_layout(isz, 64, n)
        assert stages >= 2 and smem <= tmd.SMEM_LIMIT


@pytest.mark.parametrize("itemsize,D,n_slots,stages", [
    (2, 128, 4, 9), (2, 128, 8, 9), (2, 64, 4, 10), (4, 128, 8, 5),
    (4, 128, 4, 5), (4, 64, 8, 8)])
def test_smem_layout_fills_the_card(itemsize, D, n_slots, stages):
    """The ring takes what the walk's staging (or the GEMVs' input rows
    and a tile's sums) and the small state leave of 227 KB."""
    got, smem = tmd._smem_layout(itemsize, D, n_slots)
    assert got == stages
    assert smem <= tmd.SMEM_LIMIT < smem + tmd._STAGE_BYTES


@pytest.mark.cuda
def test_schedule_splits_every_phase_evenly():
    """The schedule the kernel library reports (the code its producer and
    consumers run) for Llama-3-8B's phases on 132 blocks: each phase's
    units (16 KB stages) are its weight bytes, and no block takes more
    than one unit over another; the 1B draft's tied head and an int8 head
    likewise. Needs the built library, so the card."""
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an NVIDIA Hopper card (sm_90): the schedule "
                    "comes from the kernel library")
    cfg, _ = _llama3_8b()
    sched = tmd.schedule(cfg, 132)
    h, F = cfg.hidden_size, cfg.intermediate_size
    Mqkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    weight_bytes = {"qkv": h * Mqkv * 2, "wo": h * h * 2,
                    "gate_up": 2 * h * F * 2, "down": F * h * 2}
    assert set(sched) == set(weight_bytes)
    for name, nbytes in weight_bytes.items():
        assert sched[name]["units"] * tmd._STAGE_BYTES == nbytes
        U = sched[name]["units"]
        assert U == sched[name]["tiles"] * sched[name]["units_a_tile"]
        assert sched[name]["max_units"] == -(-U // 132)
        assert sched[name]["imbalance"] < 1.1
    q8 = tmd.schedule(cfg, 132, w_int8=True, head="int8")
    assert q8["gate_up"]["units"] * tmd._STAGE_BYTES == h * F * 2
    assert q8["head"]["tiles"] == -(-cfg.vocab_size // 512)
    dcfg, _ = _draft_1b(cfg)
    tied = tmd.schedule(dcfg, 132, head="tied")["head"]
    assert tied["tiles"] == -(-dcfg.vocab_size // 128)
    assert tied["units"] == tied["tiles"] * (dcfg.hidden_size // 64)
