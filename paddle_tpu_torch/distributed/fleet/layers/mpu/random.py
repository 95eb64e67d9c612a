"""Model-parallel RNG state management — the port of
paddle_tpu/distributed/fleet/layers/mpu/random.py (parity:
fleet/layers/mpu/random.py — RNGStatesTracker for distinct dropout seeds
inside vs outside TP regions).

Each tracked state is a pair of explicit ``torch.Generator``s (the CPU's,
and the current CUDA device's when CUDA is available); ``rng_state(name)``
swaps them in as torch's default generators for the block and keeps what
the block drew."""
from __future__ import annotations

import contextlib

import torch

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _cuda() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class RNGStatesTracker:
    def __init__(self):
        self.states = {}
        self.seeds = set()

    def reset(self):
        self.states = {}
        self.seeds = set()

    def add(self, name, seed):
        if seed in self.seeds:
            raise ValueError(f"seed {seed} already exists")
        self.seeds.add(seed)
        gens = {"cpu": torch.Generator().manual_seed(seed)}
        if _cuda():
            gens["cuda"] = torch.Generator(device="cuda").manual_seed(seed)
        self.states[name] = gens

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states:
            raise ValueError(f"rng state {name} not added")
        gens = self.states[name]
        prev_cpu = torch.get_rng_state()
        torch.set_rng_state(gens["cpu"].get_state())
        cuda = "cuda" in gens and _cuda()
        if cuda:
            prev_cuda = torch.cuda.get_rng_state()
            torch.cuda.set_rng_state(gens["cuda"].get_state())
        try:
            yield
        finally:
            gens["cpu"].set_state(torch.get_rng_state())
            torch.set_rng_state(prev_cpu)
            if cuda:
                gens["cuda"].set_state(torch.cuda.get_rng_state())
                torch.cuda.set_rng_state(prev_cuda)


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker


def model_parallel_random_seed(seed=None):
    """Seed torch's default generators with ``seed`` (one for every
    rank) and track ``seed + 1024 + rank`` as the model-parallel state."""
    import random as _pyrandom

    from ....env import get_rank

    seed = seed or (_pyrandom.randint(0, 2 ** 31 - 1))
    global_seed = seed
    local_seed = seed + 1024 + get_rank()
    _tracker.reset()
    _tracker.add(MODEL_PARALLEL_RNG, local_seed)
    torch.manual_seed(global_seed)
